"""The port's tests' share of the CPU cores, decided in one place.

The suite runs on pytest-xdist workers that share one machine. Left alone,
torch's intra-op pool and numpy's BLAS pool each take a thread a core in
every worker, so small ops spend their time in contended barriers (a 2 s
``gradcheck`` took minutes with six workers on eight cores). Every
``tests/test_torch_*.py`` takes the module fixture below with one line::

    from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

and starts its child processes with ``child_env``. The fixture holds the
pools only while a port module runs, so the JAX package's tests, which share
the workers, keep the pools they have. Outside xdist (a plain pytest run, or
the card's run with ``--noconftest``) the pools keep their defaults.
"""

import os

import pytest


def worker_threads():
    """This xdist worker's share of the process's cores (at least 1), or
    ``None`` outside a worker."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return None
    return max(1, len(os.sched_getaffinity(0)) // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))


@pytest.fixture(autouse=True, scope="module")
def worker_share_of_cores():
    """torch's intra-op threads and the native pools that threadpoolctl
    finds (OpenBLAS, OpenMP) at ``worker_threads()`` for the module's tests,
    both restored after them."""
    n = worker_threads()
    if n is None:
        yield
        return
    import torch
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        with threadpool_limits(limits=n):
            yield
    finally:
        torch.set_num_threads(threads)


def child_env(**extra):
    """``os.environ`` for a child process, with ``OMP_NUM_THREADS`` at this
    worker's share (1 outside a worker), updated by ``extra``."""
    env = dict(os.environ, OMP_NUM_THREADS=str(worker_threads() or 1))
    env.update(extra)
    return env
