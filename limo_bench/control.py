"""Readings that the limits of ``correct`` are set from, on the card.

    python3 -m limo_bench.control --workload scan.drive --seeds 1,2,3 \
        --system port|tf32|stale_solve|one_iteration

Runs the cell's driver once per seed in this one process (the kernels are
built once; each window is one pass of the drive) and prints, per seed,
each compared number of the run as one JSON line. ``--system``:

- ``port``: the program as the configuration states it (the sound runs:
  the lower readings);
- ``tf32``: the control: the program with its full-float32 pin (every
  solver entry point runs with TF32 off, ``utils/precision.full_f32``)
  switched to TF32, the nearest precision below the configuration's
  float32 with TF32 off (the upper readings);
- ``stale_solve``, ``one_iteration``: two faults of
  ``tests/test_bench_faults.py`` planted at the cell's own size: the
  trimmed solve returning its input window, or cut to one LM iteration.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

SYSTEMS = ("port", "tf32", "stale_solve", "one_iteration")


@contextlib.contextmanager
def tf32_on():
    """What the program's full-float32 pin becomes in the control: TF32 on
    for cuBLAS and cuDNN inside every solver entry point (restored
    after)."""
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def plant(system: str) -> None:
    """Switch the program in this process to ``system``."""
    from limo_tpu_torch.pipeline import scan_odometry as so
    from limo_tpu_torch.utils import precision
    if system == "tf32":
        precision._tf32_off = tf32_on
    elif system == "stale_solve":
        solve = so.solve_trimmed

        def stale(w, sel, rig, cfg):
            _, sel2, info = solve(w, sel, rig, cfg)
            return w, sel2, info
        so.solve_trimmed = stale
    elif system == "one_iteration":
        solve = so.solve_trimmed

        def one(w, sel, rig, cfg):
            return solve(w, sel, rig, dataclasses.replace(
                cfg, robust=dataclasses.replace(cfg.robust,
                                                num_trim_iterations=0),
                solver=dataclasses.replace(cfg.solver,
                                           refinement_iterations=1)))
        so.solve_trimmed = one


def main(argv=None) -> int:
    from . import run as bench_run  # sets the run's environment
    from . import harness
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--system", choices=SYSTEMS, default="port")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    import torch
    torch.set_num_threads(int(bench_run.THREADS))
    if not torch.cuda.is_available():
        print("limo_bench.control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    manifest = harness.load_manifest()
    cell, _, traffic, config = harness.cell_files(args.workload, manifest)
    drv = harness.driver(traffic["driver"])
    plant(args.system)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        record = drv.run(cell=cell, traffic=traffic, config=config,
                         seed=seed, seconds=args.seconds, trace=False,
                         device=device, t_process=t0)
        t1 = time.perf_counter()
        compared = record.compare()
        print(json.dumps({
            "workload": args.workload, "system": args.system, "seed": seed,
            "frames": len(record.frame_ms),
            "solves": record.frame_kind.count("solve"),
            "window_s": record.window_s, "run_s": t1 - t0,
            "compare_s": time.perf_counter() - t1,
            "compared": {n: v for n, v, _ in compared}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
