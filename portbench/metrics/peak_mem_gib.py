"""peak_mem_gib: the device memory the allocator held at most, in GiB,
from before the port's operand is built to the close of the window."""


def read(run: dict):
    if run.get("memory_peak_bytes") is None:
        return None
    return run["memory_peak_bytes"] / 2 ** 30
