"""The kilometre-scale long drive on the CPU, through either package.

    python scripts/long_drive_cpu.py --package reference --frames 120
    python scripts/long_drive_cpu.py --package port --frames 120
    python scripts/long_drive_cpu.py --package port --dtype float64

Both build the drive of ``evaluation.evaluate_long_drive`` (an S-curve
world at 10 m/s, 4 landmarks and 1 ground point per metre, row-packed
tracks with lidar depth and labels, 12 keyframe slots x ``--rows``; seed
``--seed``), run it through their ``scan_odometry.run_sequence`` and print
one JSON line: keyframes, attempted and accepted solves, ``po_ok`` frames
and the first frame without it, the rows that hold more than one track,
ATE, KITTI drift (the evaluator's 100-800 m segments) and the wall time. ``chip_smoke.py`` phase 9 holds the
card's drive to the reference's line (``REF_LONG``).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def summary(out, world, valid, seconds):
    from limo_tpu_torch.pipeline.metrics import ate_rmse, kitti_drift
    est = out["poses"]
    gt = world.kitti_gt()
    drift = kitti_drift(gt, est)
    starts = (valid[1:] & ~valid[:-1]).sum(axis=0) + valid[0]
    return {
        "frames": len(est), "keyframes": int(out["is_keyframe"].sum()),
        "attempted": int((out["cost"] != 0).sum()),
        "accepted": int(out["solved"].sum()), "po_ok": int(out["po_ok"].sum()),
        "first_not_po_ok": int(np.argmin(out["po_ok"])) if not
        out["po_ok"].all() else None,
        "rows_reused": int((starts > 1).sum()),
        "ate_m": ate_rmse(gt, est), "drift_t_percent": drift["t_err_percent"],
        "drift_r_deg_per_m": drift["r_err_deg_per_m"],
        "drift_segments": drift["num_segments"], "seconds": seconds}


def run_reference(n, rows, seed, dtype):
    import jax
    jax.config.update("jax_platforms", "cpu")
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from limo_tpu.geometry.camera import CameraRig
    from limo_tpu.pipeline import evaluation as ev
    from limo_tpu.pipeline import scan_odometry as so

    dt = getattr(jnp, dtype)
    cfg = ev._long_drive_config(rows)
    world, stamps, uvd, valid, labels = ev._long_drive_inputs(
        n, 10.0, rows, seed, 4.0, 1.0, cfg)
    rig = CameraRig.single(world.focal, world.principal[0],
                           world.principal[1],
                           T_cam_veh=jnp.asarray(world.T_cam_veh, dt),
                           dtype=dt)
    t0 = time.time()
    _, out = so.run_sequence(stamps, uvd, valid, rig, cfg, dtype=dt,
                             labels=labels)
    out = jax.device_get(out)
    seconds = time.time() - t0
    rec = {k: np.asarray(v) for k, v in out._asdict().items()}
    rec["poses"] = so.poses_kitti(out)
    return summary(rec, world, valid, seconds)


def run_port(n, rows, seed, dtype):
    import torch

    from limo_tpu_torch.geometry.camera import CameraRig
    from limo_tpu_torch.pipeline import evaluation as ev
    from limo_tpu_torch.pipeline import scan_odometry as so

    dt = getattr(torch, dtype)
    cfg = ev._long_drive_config(rows)
    world, stamps, uvd, valid, labels = ev._long_drive_inputs(
        n, 10.0, rows, seed, 4.0, 1.0, cfg)
    rig = CameraRig.single(world.focal, world.principal[0],
                           world.principal[1], T_cam_veh=world.T_cam_veh,
                           dtype=dt, device="cpu")
    t0 = time.time()
    _, out = so.run_sequence(stamps, uvd, valid, rig, cfg, dtype=dt,
                             labels=labels, device="cpu")
    seconds = time.time() - t0
    rec = {k: v.numpy() for k, v in out._asdict().items()}
    rec["poses"] = so.poses_kitti(out)
    rec = summary(rec, world, valid, seconds)
    rec["torch_threads"] = torch.get_num_threads()
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("reference", "port"),
                    required=True)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--rows", type=int, default=768)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    a = ap.parse_args()
    run = run_reference if a.package == "reference" else run_port
    rec = run(a.frames, a.rows, a.seed, a.dtype)
    print(json.dumps({"package": a.package, "dtype": a.dtype,
                      "seed": a.seed, "rows": a.rows, **rec}))


if __name__ == "__main__":
    main()
