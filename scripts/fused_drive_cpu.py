"""The full-width fused drive on the CPU, through either package.

    python scripts/fused_drive_cpu.py --package reference   # JAX, float32
    python scripts/fused_drive_cpu.py --package port        # PyTorch, float32
    python scripts/fused_drive_cpu.py --package port --dtype float64

Both build the same world (``make_km_rendered_world(200, seed=11)``, clouds
from ``np.random.default_rng(11)``) and the flagship fused configuration
(``limo_tpu_torch.entry.fused_drive``; the reference's
``evaluation.evaluate_rendered_long_drive``), run ``run_fused`` over it with
``chunk=64`` in float32, and print one JSON line: keyframes, attempted and
accepted solves, ``po_ok`` frames, the minima of ``n_tracks``,
``n_matches`` and ``n_depth`` after frame 5, ATE, KITTI drift, the largest
cloud and the wall time (``--dump`` also writes every frame's outputs
and the ground truth to an npz file). The port runs its plain assembly on the CPU; its
line also gives the LM iterations and trim rounds of its solves (the
kernels' launches on the card follow from them) and its host reads.
``chip_smoke.py`` phase 7 holds the card's drive to the reference's line.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def summary(out, world, clouds, seconds, dump=None):
    from limo_tpu_torch.pipeline.metrics import ate_rmse, kitti_drift
    est = out["poses"]
    gt = world.kitti_gt()[:len(est)]
    if dump:
        np.savez(dump, gt=gt, **out)
    drift = kitti_drift(gt, est)
    return {
        "frames": len(est), "keyframes": int(out["is_keyframe"].sum()),
        "attempted": int((out["cost"] != 0).sum()),
        "accepted": int(out["solved"].sum()), "po_ok": int(out["po_ok"].sum()),
        "min_n_tracks": int(out["n_tracks"][5:].min()),
        "min_n_matches": int(out["n_matches"][5:].min()),
        "min_n_depth": int(out["n_depth"][5:].min()),
        "ate_m": ate_rmse(gt, est), "drift_t_percent": drift["t_err_percent"],
        "drift_r_deg_per_m": drift["r_err_deg_per_m"],
        "drift_segments": drift["num_segments"],
        "max_cloud": max(len(c) for c in clouds), "seconds": seconds}


def run_reference(n, seed, chunk, dump):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from limo_tpu.frontend.lidar_depth import LidarDepthConfig
    from limo_tpu.frontend.tracker import TrackerConfig
    from limo_tpu.geometry.camera import CameraRig
    from limo_tpu.pipeline import fused
    from limo_tpu.pipeline.evaluation import make_km_rendered_world
    from limo_tpu.pipeline.full import LimoPipelineConfig
    from limo_tpu.pipeline.render import SequenceRenderer
    from limo_tpu_torch.entry import fused_drive

    # the port's fixture gives the configuration; the world and streams are
    # rendered by the reference's own instruments
    _, _, _, _, _, tcfg, tpcfg, _ = fused_drive(2, seed, device="cpu")
    import dataclasses

    from limo_tpu.config import LandmarkSelectionConfig, LimoConfig, PriorConfig
    cfg = LimoConfig(
        landmark_selection=dataclasses.replace(
            LandmarkSelectionConfig(),
            height_over_ground=tcfg.landmark_selection.height_over_ground),
        prior=dataclasses.replace(PriorConfig(),
                                  default_speed=tcfg.prior.default_speed))
    pcfg = LimoPipelineConfig(
        limo=cfg, tracker=TrackerConfig(**vars(tpcfg.tracker)),
        lidar=LidarDepthConfig(**vars(tpcfg.lidar)), use_groundplane=True,
        cloud_capacity=tpcfg.cloud_capacity)
    world, _ = make_km_rendered_world(n, seed=seed)
    rend, rng = SequenceRenderer(world), np.random.default_rng(seed)
    imgs, labels, clouds = [], [], []
    for i in range(n):
        img, lab = rend.frame(i)
        imgs.append((img * 255).astype(np.uint8))
        labels.append(lab)
        clouds.append(rend.cloud(i, rng))
    rig = CameraRig.single(world.focal, world.principal[0], world.principal[1],
                           T_cam_veh=jnp.asarray(world.T_cam_veh, jnp.float32))
    t0 = time.time()
    _, out = fused.run_fused(world.stamps[:n], np.stack(imgs), clouds, rig,
                             cfg, pcfg, label_images=np.stack(labels),
                             chunk=chunk)
    seconds = time.time() - t0
    rec = {k: np.asarray(v) for k, v in out._asdict().items()}
    rec["poses"] = fused.poses_kitti(out)
    return summary(rec, world, clouds, seconds, dump)


def run_port(n, seed, chunk, dump, dtype="float32"):
    import torch

    from limo_tpu_torch.entry import fused_drive
    from limo_tpu_torch.pipeline import fused

    (stamps, imgs, clouds, labels, rig, cfg, pcfg,
     world) = fused_drive(n, seed, device="cpu")
    runner = fused.make_fused_runner(rig, cfg, pcfg, world.image_size, True)
    t0 = time.time()
    if dtype == "float64":
        rig = type(rig)(*[x.double() for x in rig])
        runner = fused.make_fused_runner(rig, cfg, pcfg, world.image_size,
                                         True)
    _, out = fused.run_fused(stamps, imgs, clouds, rig, cfg, pcfg,
                             label_images=labels, chunk=chunk, device="cpu",
                             runner=runner, dtype=getattr(torch, dtype))
    seconds = time.time() - t0
    poses = fused.poses_kitti(out)
    out = {k: v.numpy() for k, v in out._asdict().items()}
    out["poses"] = poses
    rec = summary(out, world, clouds, seconds, dump)
    infos = runner.stats.solves
    rec.update(lm_iterations=sum(i.n_iterations for i in infos),
               trim_rounds=sum(i.n_rounds for i in infos),
               solves_run=len(infos), host_syncs=runner.stats.host_syncs,
               frames_stepped=runner.stats.frames,
               torch_threads=torch.get_num_threads())
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("reference", "port"),
                    required=True)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--dump", help="write the per-frame outputs (npz) here")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32",
                    help="the port's float type (the reference's run_fused "
                         "runs in float32 only)")
    a = ap.parse_args()
    if a.package == "reference":
        rec = run_reference(a.frames, a.seed, a.chunk, a.dump)
    else:
        rec = run_port(a.frames, a.seed, a.chunk, a.dump, a.dtype)
    print(json.dumps({"package": a.package, "dtype": a.dtype, **rec}))


if __name__ == "__main__":
    main()
