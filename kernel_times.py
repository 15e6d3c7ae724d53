"""A/B of the port's kernels and bench solve between checkouts, on one card.

Run from the repository root on a machine with one NVIDIA card:

    python3 kernel_times.py                # this checkout
    python3 kernel_times.py --root DIR     # the checkout in DIR

To compare two commits, unpack the other's package into a directory that
git ignores (``git archive <commit> limo_tpu_torch | tar -x -C
build/parent``) and run parent, change, change, parent in one session on
one card: solve times on the card move from machine to machine.

Each run prints one JSON line, then the card's name and power limit as
nvidia-smi gives them:

- ``kernel_ms``: each kernel's device time per launch at the bench width
  (``make_problem(20, 1536, 12, 800, float32, seed=1)``) over 50 calls of
  its wrapper, from the torch.profiler trace (``chip_smoke.device_ms``).
  The wrapper's own work does not enter it, so checkouts with other
  wrappers compare like with like.
- ``solve``: the bench solve, ms per solve (CUDA events around each of 10
  solves after a warm-up: median, min, max), LM iterations, final cost.
- ``seeds``: one solve on the card of the bench-width window of each seed
  in ``SEEDS``: LM iterations, trim rounds, trimmed landmarks, final cost,
  beside the same window solved in float64 on the CPU (the plain path),
  and the card's final cost relative to that one's.
"""

import argparse
import json
import statistics
import sys

import torch

SEEDS = (1, 2, 3, 4)
N_SOLVES = 10


def kernel_ms(ca, ba_core, problem):
    """{kernel: (device ms per launch, method)} of the imported checkout's
    wrappers on ``problem``."""
    from chip_smoke import SYMBOL, device_ms
    ops, sizes = ba_core._obs_kernel_args(*problem)
    return {name: device_ms(lambda: getattr(ca, name)(*ops, **sizes),
                            SYMBOL[name])
            for name in ("assemble_obs", "cost_obs")}


def solve_ms(solve_trimmed, problem):
    """ms per solve of ``problem`` on the card and the last solve's info."""
    solve_trimmed(*problem)                                   # warm-up
    times = []
    for _ in range(N_SOLVES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        info = solve_trimmed(*problem)[2]
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"ms_per_solve": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times), "iterations": info.n_iterations,
            "final_cost": float(info.final_cost)}


def summary(info) -> dict:
    return {"iterations": info.n_iterations, "rounds": info.n_rounds,
            "trimmed": int(info.n_trimmed),
            "final_cost": float(info.final_cost)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", help="time the checkout in this directory")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA card")
    if args.root:
        sys.path.insert(0, args.root)
    # imported after the path is set, so that they are the checkout's
    from chip_smoke import card_line
    from limo_tpu_torch.entry import make_problem
    from limo_tpu_torch.solver import ba_core, cuda_assemble as ca
    from limo_tpu_torch.solver import solve_trimmed

    def bench(seed, dtype=torch.float32, device="cuda"):
        return make_problem(20, 1536, 12, 800, dtype, seed=seed,
                            device=device)

    record = {"root": args.root or ".",
              "kernel_ms": kernel_ms(ca, ba_core, bench(1)),
              "solve": solve_ms(solve_trimmed, bench(1)), "seeds": {}}
    for seed in SEEDS:
        card = summary(solve_trimmed(*bench(seed))[2])
        cpu = summary(solve_trimmed(*bench(seed, torch.float64, "cpu"))[2])
        record["seeds"][seed] = {
            "card_f32": card, "cpu_f64": cpu,
            "rel_cost": abs(card["final_cost"] - cpu["final_cost"])
            / cpu["final_cost"]}
    print(json.dumps(record), flush=True)
    print(card_line())


if __name__ == "__main__":
    main()
