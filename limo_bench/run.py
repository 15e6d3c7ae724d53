"""One run of one benchmark cell on the card it is started on.

    python3 -m limo_bench.run --workload scan.drive --seed 7 --seconds 30 \
        --trace 0

Prints the run's result as the last line of standard output (one JSON
object, see ``harness.result_line``) and the numbers that decide
``correct``, each beside its limit, as the last lines of standard error.
Exits with 2, printing no result, where the card or the cell's number of
cards is missing, and with 3 where a forbidden module (``jax``, ``jaxlib``,
``flax``, ``limo_tpu``) was loaded in the process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_IMPORT = time.perf_counter()
_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
# every build and kernel cache inside the checkout, at a fixed path
_CACHE = os.path.join(_ROOT, ".limo_bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
# the host's threads: one process drives the card, and PyTorch's CPU
# pool only adds threads that contend with it (see PERF.md, the spread
# study); fixed before torch is imported
THREADS = "1"
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = THREADS

from . import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def main(argv=None) -> int:
    args = parse(argv)
    age = harness.process_age_s()
    t_process = T_IMPORT if age is None else time.perf_counter() - age
    manifest = harness.load_manifest()
    cell, config, traffic, config_file = harness.cell_files(args.workload,
                                                            manifest)

    import torch
    torch.set_num_threads(int(THREADS))
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"limo_bench: the cell {args.workload} needs {chips} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              , file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)

    drv = harness.driver(traffic["driver"])
    record = drv.run(cell=cell, traffic=traffic, config=config_file,
                     seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=device,
                     t_process=t_process)
    info = device_info(torch, chips)
    info["memory_peak_bytes"] = int(record.memory_peak_bytes)
    breakdown = None
    if args.trace:
        if record.trace is None:
            print("limo_bench: the profiler saw no device time",
                  file=sys.stderr)
            return 4
        info["busy_s"] = record.trace["busy_s"]
        info["window_s"] = record.trace["window_s"]
        breakdown = record.trace["breakdown"]
    compared = record.compare() if record.compare is not None else []
    bad = harness.forbidden_loaded()
    if bad:
        print(f"limo_bench: forbidden modules loaded in this process: "
              f"{bad}", file=sys.stderr)
        return 3
    metrics = harness.metrics_of(args.workload, manifest, bool(args.trace))
    line = harness.result_line(record, metrics, bool(args.trace), compared,
                               info, breakdown)
    for name, value, limit in compared:
        if limit is None:
            print(f"read {name} = {value!r} (not compared)", file=sys.stderr)
    for name, value, limit in compared:
        if limit is not None:
            print(f"compared {name} = {value!r} (limit {limit!r})",
                  file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
