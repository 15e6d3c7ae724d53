"""Chip smoke run of the PyTorch/CUDA port (``limo_tpu_torch``) on one card.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit, and no result):

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the CUDA kernels from limo_tpu_torch/csrc/;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the bench width (K=20, C=1, L=1536) and at a 2-camera ragged shape
   (K=6, C=2, L=1000), depth on and off; timed with CUDA events beside the
   plain version and the least time the card could take (bound);
4. main path: the trimmed windowed-BA solve at the bench width
   (``make_problem(20, 1536, 12, 800, float32, seed=1)``) run 10 times
   after one warm-up, with the launch counts of both kernels, the solve
   shape (1 round, 77 trimmed, final cost within 1e-4 of the reference
   package's f64 solve, 1612.640648) and bit-identical repeats checked,
   then one solve without lidar depth;
5. where the time goes: one solve under torch.profiler (device time by
   kernel, device idle share) and the host syncs of one solve.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. The profile table and a JSON record of
the run are written under chiprun_out/.
"""

import json
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from limo_tpu_torch.entry import kernel_check_windows, make_problem
from limo_tpu_torch.solver import ba_core, cuda_assemble as ca
from limo_tpu_torch.solver import solve_trimmed

# the reference package's solve of this fixture, JAX on the CPU in f64
REF_FINAL_COST = 1612.640648
REF_TRIMMED = 77
N_SOLVES = 10

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# f32 operations per (landmark, keyframe, camera) slot, counted from
# csrc/assemble.cu: residuals and cost 44; weights, the 18+9 Jacobian
# entries and the V/b_l/U/b_pose/W accumulations 575 more. Both kernels do
# this work for every slot (masks multiply, they do not skip).
OPS_PER_SLOT = {"assemble_obs": 619, "cost_obs": 44}
SOURCE = "limo_tpu_torch/csrc/assemble.cu"
REPLACES = {
    "assemble_obs": "limo_tpu/solver/pallas_assemble.py:325",
    "cost_obs": "limo_tpu/solver/pallas_assemble.py:122",
}
OUT = Path("chiprun_out")


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name):
    print(f"\n== {name}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def events_ms(fn, n_batches, per_batch, warmup=3):
    """Median over batches of the per-call device time of ``fn`` (CUDA
    events around ``per_batch`` back-to-back calls)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n_batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def bound(name, ops, outs, K, C):
    """Least time (ms) for the work: each input read once, each output
    written once, over the HBM rate; the f32 operations over the f32 rate."""
    L = ops[0].shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in (*ops, *outs))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_SLOT[name] * L * K * C / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes


def check_kernels(device):
    """Phase 3: every kernel against its plain version; returns the
    per-kernel error and timing record at the bench width."""
    errs = {"assemble_obs": (0.0, 0.0), "cost_obs": (0.0, 0.0)}
    for name, (w, sel, rig, cfg) in kernel_check_windows(device):
        case = ca.compare_with_plain(*ba_core._obs_kernel_args(w, sel, rig,
                                                               cfg))
        torch.cuda.synchronize()
        errs = {k: tuple(map(max, errs[k], case[k])) for k in errs}
        print(f"{name}: both kernels agree with their plain versions; "
              f"cost kernel == assembly kernel cost")

    # timing at the bench width, depth on, in one call: the kernel alone
    # (the wrapper's launch into outputs allocated once), the whole
    # wrapper, and the plain version
    w, sel, rig, cfg = make_problem(20, 1536, 12, 800, torch.float32, seed=1,
                                    device=device)
    ops, sizes = ba_core._obs_kernel_args(w, sel, rig, cfg)
    K, C, L = sizes["K"], sizes["C"], ops[0].shape[1]
    wrapper = {"assemble_obs": lambda: ca.assemble_obs(*ops, **sizes),
               "cost_obs": lambda: ca.cost_obs(*ops, **sizes)}
    plain = {"assemble_obs": lambda: ca.assemble_obs_plain(*ops, **sizes),
             "cost_obs": lambda: ca.cost_obs_plain(*ops, **sizes)}
    records = {}
    for name in ("assemble_obs", "cost_obs"):
        outs = ca.kernel_outputs(name, K, L, device)
        launch = ca.launcher(name, ops, outs, **sizes)
        b_ms, b_by, nbytes = bound(name, ops, outs, K, C)
        records[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": None,               # filled from the main path
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": events_ms(launch, 11, 50),
            "wrapper_ms": events_ms(wrapper[name], 11, 50),
            "plain_ms": events_ms(plain[name], 5, 10),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
            "library_ms": None,     # no single PyTorch call computes this
        }
        r = records[name]
        print(f"{name}: {r['ms']:.4f} ms/launch (wrapper {r['wrapper_ms']:.4f}"
              f", plain {r['plain_ms']:.4f}, bound {b_ms * 1e3:.3f} us by "
              f"{b_by}); max |kernel - plain| {errs[name][0]:.3g} "
              f"(relative {errs[name][1]:.3g})")
    return records


def main_path(device):
    """Phase 4: the trimmed solve at the bench width, through both kernels."""
    w, sel, rig, cfg = make_problem(20, 1536, 12, 800, torch.float32,
                                    seed=1, device=device)
    plan = ba_core.assembly_plan(w.poses.dtype, w.poses.device, cfg)
    print(f"assembly plan: {plan}")
    check(plan.startswith("cuda["), f"plan {plan} is not the kernel path")
    solve_trimmed(w, sel, rig, cfg)                    # warm-up
    torch.cuda.synchronize()

    for k in ca.launches:
        ca.launches[k] = 0
    results, dev_ms, host_ms = [], [], []
    for _ in range(N_SOLVES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = solve_trimmed(w, sel, rig, cfg)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
        results.append(out)
    launches = dict(ca.launches)

    infos = [r[2] for r in results]
    n_it = sum(i.n_iterations for i in infos)
    n_rounds = sum(i.n_rounds for i in infos)
    print(f"launches in {N_SOLVES} solves: {launches} "
          f"(LM iterations {n_it}, trim rounds {n_rounds})")
    check(launches["assemble_obs"] == n_it, f"launches {launches}")
    # cost evaluations: initial + one per LM iteration + one per trim round
    check(launches["cost_obs"] == N_SOLVES + n_it + n_rounds,
          f"launches {launches}")
    w0, s0, i0 = results[0]
    for wi, si, ii in results[1:]:
        for a, b in zip(w0, wi):
            check(torch.equal(a, b), "repeated solves differ (window)")
        check(torch.equal(s0.lm_selected, si.lm_selected)
              and torch.equal(i0.final_cost, ii.final_cost)
              and ii.n_iterations == i0.n_iterations,
              "repeated solves differ (selection, cost or iterations)")
    final = float(i0.final_cost)
    rel = abs(final - REF_FINAL_COST) / REF_FINAL_COST
    print(f"solve: LM iterations {i0.n_iterations}, rounds {i0.n_rounds}, "
          f"trimmed {int(i0.n_trimmed)}, cost {float(i0.initial_cost):.4f} "
          f"-> {final:.4f} (reference {REF_FINAL_COST}, rel {rel:.2e}); "
          f"{N_SOLVES} repeats bit-identical")
    check(i0.n_rounds == 1 and int(i0.n_trimmed) == REF_TRIMMED,
          f"solve shape: rounds {i0.n_rounds}, trimmed {int(i0.n_trimmed)}")
    check(rel < 1e-4, f"final cost {final} vs {REF_FINAL_COST}: rel {rel}")
    check(bool(torch.isfinite(w0.poses).all()
               and torch.isfinite(w0.lm_pos).all()), "non-finite state")
    print(f"ms/solve: device-event median {statistics.median(dev_ms):.3f} "
          f"(min {min(dev_ms):.3f}, max {max(dev_ms):.3f}); host median "
          f"{statistics.median(host_ms):.3f}; solves/s "
          f"{1e3 / statistics.median(dev_ms):.2f}; host syncs/solve "
          f"{i0.n_host_syncs}")

    wn, seln, rign, cfgn = make_problem(20, 1536, 12, 800, torch.float32,
                                        with_depth=False, seed=1,
                                        device=device)
    _, _, info_n = solve_trimmed(wn, seln, rign, cfgn)
    c0, c1 = float(info_n.initial_cost), float(info_n.final_cost)
    print(f"no-depth solve: iterations {info_n.n_iterations}, trimmed "
          f"{int(info_n.n_trimmed)}, cost {c0:.4f} -> {c1:.4f}")
    check(bool(np.isfinite(c1)) and c1 < c0,
          f"no-depth solve did not decrease the cost: {c0} -> {c1}")
    return launches, (w, sel, rig, cfg), {
        "ms_per_solve": statistics.median(dev_ms), "host_ms": host_ms,
        "device_ms": dev_ms, "iterations": i0.n_iterations,
        "host_syncs": i0.n_host_syncs, "final_cost": final}


def where_time_goes(problem):
    """Phase 5: device time by kernel over one solve, and the host syncs
    PyTorch reports for one solve."""
    w, sel, rig, cfg = problem
    torch.cuda.synchronize()
    syncs = Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        # attribute each synchronizing operation to the innermost caller
        # in the port (the warning is raised inside the operation's call)
        if "synchroniz" in str(message):
            own = [f for f in traceback.extract_stack()
                   if "limo_tpu_torch" in f.filename]
            f = own[-1] if own else None
            syncs[f"{Path(f.filename).name}:{f.lineno}" if f
                  else f"{Path(filename).name}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solve_trimmed(w, sel, rig, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    print(f"synchronizing operations in one solve (sync debug mode): "
          f"{sum(syncs.values())}, by caller: {dict(syncs.most_common())}")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        solve_trimmed(w, sel, rig, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    kernels = sorted([(e.key, e.count, e.device_time_total / 1e3)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not e.key.startswith("limo.")],
                     key=lambda r: -r[2])
    busy = sum(r[2] for r in kernels)
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_profile.txt").write_text(
        prof.key_averages().table(sort_by="device_time_total", row_limit=40))
    if busy == 0:
        print("device time by kernel: not measured (the profiler saw no "
              "device time)")
        return {"profile": "not measured", "syncs": dict(syncs)}
    print(f"one solve under the profiler: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, device idle share {1 - busy / wall_ms:.3f}, "
          f"{sum(r[1] for r in kernels)} device operations")
    # each range appears twice: on the host (its host time and the device
    # time of the operations it launched) and as a device-side annotation
    layers = sorted([(e.key, e.count, e.cpu_time_total / 1e3,
                      e.device_time_total / 1e3)
                     for e in prof.key_averages()
                     if e.key.startswith("limo.")
                     and e.device_type != DeviceType.CUDA],
                    key=lambda r: -r[2])
    print("  host ms (incl. nested) | device ms | calls | layer")
    for key, count, host, dev in layers:
        print(f"  {host:10.3f} | {dev:9.4f} | {count:5d} | {key}")
    print("  device ms | count | top device operations")
    for key, count, ms in kernels[:12]:
        print(f"  {ms:9.4f} | {count:5d} | {key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1 - busy / wall_ms, "syncs": dict(syncs),
            "layers": [{"name": k, "count": c, "host_ms": h, "device_ms": d}
                       for k, c, h, d in layers],
            "top": [{"name": k[:120], "count": c, "ms": m}
                    for k, c, m in kernels[:12]]}


def main():
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() "
                         "is false)")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    run(torch.device("cuda"), card)


def run(device, card):
    """Phases 2-5 on ``device``; prints the result lines."""
    phase("build")
    b = ca.build()
    print(f"built {b.path.name} in {b.seconds:.1f} s")
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  " + line.strip())

    phase("kernels against their plain versions")
    records = check_kernels(device)

    phase("main path: trimmed windowed BA, 20x1536 (12x800 used)")
    launches, problem, solve = main_path(device)
    for name, r in records.items():
        r["launches"] = launches[name]

    phase("where the time goes")
    prof = where_time_goes(problem)

    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": list(records.values()), "solve": solve,
         "profile": prof}, indent=1))
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
