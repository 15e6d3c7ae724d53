"""The spreads of two sets of runs of one cell, as the bounds are judged.

    python3 -m limo_bench.spread setA.jsonl setB.jsonl

Each file holds the result lines of one set (one JSON object a line; other
lines are skipped). For each end-to-end metric it prints the median of
each set, each set's spread (the distance between the first and the third
quartile of ``statistics.quantiles(values, n=4)``, as a share of the
median), each set's spread without its run farthest from the median, the
mean of those two (which may be at most half the bound), the spread of
all the runs together (the bound may be at most eight times it), and the
second median's change against the first.
"""

from __future__ import annotations

import json
import statistics
import sys


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def without_farthest(values):
    """The spread without the run farthest from the median, where that
    narrows it."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    rest = values[:far] + values[far + 1:]
    return min(spread(values), spread(rest)) if len(rest) >= 2 else \
        spread(values)


def load(path):
    lines = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                try:
                    lines.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return [x for x in lines if "metrics" in x]


def report(a, b):
    names = sorted({n for x in a + b for n in x["metrics"]})
    rows = {}
    for n in names:
        va = [x["metrics"][n]["value"] for x in a if n in x["metrics"]]
        vb = [x["metrics"][n]["value"] for x in b if n in x["metrics"]]
        if len(va) < 2 or len(vb) < 2:
            continue
        ta, tb = without_farthest(va), without_farthest(vb)
        rows[n] = {"median_a": statistics.median(va),
                   "median_b": statistics.median(vb),
                   "spread_a": spread(va), "spread_b": spread(vb),
                   "trimmed_a": ta, "trimmed_b": tb,
                   "trimmed_mean": (ta + tb) / 2,
                   "spread_all": spread(va + vb),
                   "median_change": statistics.median(vb)
                   / statistics.median(va) - 1}
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    for name, row in report(load(argv[0]), load(argv[1])).items():
        print(json.dumps({"metric": name, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
