"""The spread of each metric over a set of runs of one cell, and the bound
it suggests: the distance between the first and the third quartile over
the median, as ``statistics.quantiles(values, n=4)`` gives them, and five
times that, never under 1%.

    python3 portbench/spread.py <result file> ...

Each file holds the standard output of one run of the cell; its last line
is the result.
"""

import json
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import measure  # noqa: E402


def spreads(results: list) -> dict:
    """{metric: spread} over the results of one cell's runs."""
    values = defaultdict(list)
    for res in results:
        for name, m in res["metrics"].items():
            values[name].append(m["value"])
    return {name: measure.spread(v) for name, v in values.items() if len(v) >= 2}


def main(paths) -> int:
    results = [json.loads(Path(p).read_text().strip().splitlines()[-1]) for p in paths]
    s = spreads(results)
    print(json.dumps({"runs": len(results), "spread": s,
                      "bound": {k: max(0.01, 5 * v) for k, v in s.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
