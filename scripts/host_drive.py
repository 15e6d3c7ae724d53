"""The rendered KITTI-layout drive through the host engine, either package.

    python scripts/host_drive.py --package reference --frames 200   # JAX, CPU
    python scripts/host_drive.py --package port --frames 200        # the card

Both write the reference package's host-engine gate world
(``tests/test_kitti_eval.py``'s 200-frame drift gate:
``limo_tpu_torch.entry.kitti_host_drive``, 512 × 192 at f = 450, 6 m/s,
labels, clouds from ``np.random.default_rng(42)``) to a temporary directory
with their own ``write_kitti_sequence`` (the same pixels, scans and poses),
and run ``evaluate_kitti_sequence(engine="host")`` over it with the gate's
configuration (``LimoConfig()`` at 20 × 1536 × 1, 256 features, the
groundplane on, float32). They print one JSON line: ATE, KITTI drift over
25 m and 50 m segments, keyframes and solves, ms per frame (median, and
split by whether the frame solved), the drive's seconds and, for the port
on the card, the host syncs per frame (PyTorch's sync debug mode, which
adds a little host time) and the two kernels' launches. The port runs on
the card, and fails without one, unless ``--device cpu`` asks for the CPU.
Frame timing and sync counting are ``chip_smoke.py``'s (phase 8).
"""

import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time
from collections import Counter

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def reference_drive(n, root):
    """The reference package's writer and configuration on the same world."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import dataclasses

    from limo_tpu.config import (LandmarkSelectionConfig, LimoConfig,
                                 PriorConfig)
    from limo_tpu.frontend.lidar_depth import LidarDepthConfig
    from limo_tpu.frontend.tracker import TrackerConfig
    from limo_tpu.pipeline import evaluation, full
    from limo_tpu.pipeline.render import write_kitti_sequence
    from limo_tpu.pipeline.synthetic import make_world

    world = make_world(num_frames=n, speed=6.0, yaw_rate=0.012,
                       n_landmarks=500, n_ground=150, n_shrubbery=60,
                       n_dynamic=40, dynamic_speed=6.0, seed=9, focal=450.0,
                       pp=(256.0, 96.0), image_size=(512, 192))
    gt = write_kitti_sequence(root, world, n, np.random.default_rng(42),
                              with_labels=True)
    pcfg = full.LimoPipelineConfig(
        limo=LimoConfig(
            landmark_selection=dataclasses.replace(
                LandmarkSelectionConfig(), height_over_ground=1.65),
            prior=dataclasses.replace(PriorConfig(), default_speed=6.0)),
        tracker=TrackerConfig(max_features=256, border=8),
        lidar=LidarDepthConfig(), use_groundplane=True, cloud_capacity=16384)
    return gt, pcfg, evaluation.evaluate_kitti_sequence, full.LimoPipeline, {}


def port_drive(n, root, device):
    from limo_tpu_torch import entry
    from limo_tpu_torch.pipeline import evaluation, full
    gt, pcfg = entry.kitti_host_drive(n, root)
    return (gt, pcfg, evaluation.evaluate_kitti_sequence, full.LimoPipeline,
            {"device": device})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("reference", "port"),
                    required=True)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="the port: cuda unless cpu is asked for; the "
                    "reference: cpu only")
    args = ap.parse_args()
    device = args.device or ("cuda" if args.package == "port" else "cpu")
    if args.package == "reference" and device == "cuda":
        raise SystemExit("host_drive: the reference package runs on the CPU")
    # the recorder and the sync counter of chip_smoke.py's phase 8
    import chip_smoke
    import torch
    on_card = device == "cuda"
    sync = lambda: None
    card = "cpu"
    launches = None
    if on_card:
        if not torch.cuda.is_available():
            raise SystemExit("host_drive: --device cuda needs a card")
        card = chip_smoke.card_line()
        sync = torch.cuda.synchronize
        from limo_tpu_torch.solver import cuda_assemble as ca
        launches = ca.launches
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "seq")
        if args.package == "reference":
            gt, pcfg, evaluate, cls, kw = reference_drive(args.frames, root)
        else:
            gt, pcfg, evaluate, cls, kw = port_drive(args.frames, root,
                                                     device)
            cls = None  # the recorder's default: the port's pipeline
        if launches is not None:
            for k in launches:
                launches[k] = 0
        t0 = time.perf_counter()
        with chip_smoke.recording_host(sync, cls) as rec, \
                (chip_smoke.counting_syncs() if on_card
                 else contextlib.nullcontext(Counter())) as syncs:
            rep = evaluate(root, os.path.join(tmp, "poses.txt"), gt, cfg=pcfg,
                           drift_kw={"lengths": (25.0, 50.0), "step": 5},
                           **kw)
        seconds = time.perf_counter() - t0
    frames = rec["frames"]
    ms = [m for _, m in frames]
    solved = [r.solved for r, _ in frames]
    pick = lambda want: [m for m, s in zip(ms, solved) if s == want]
    print(json.dumps({
        "package": args.package, "device": device, "card": card,
        "frames": rep.n_frames, "ate_m": rep.ate,
        "drift_t_percent": rep.drift["t_err_percent"],
        "drift_r_deg_per_m": rep.drift["r_err_deg_per_m"],
        "drift_segments": rep.drift["num_segments"],
        "keyframes": int(sum(r.is_keyframe for r, _ in frames)),
        "solves": int(sum(solved)),
        "ms_per_frame": statistics.median(ms),
        "ms_per_frame_solve": statistics.median(pick(True)) if any(solved)
        else None,
        "ms_per_frame_no_solve": statistics.median(pick(False)),
        "host_syncs_per_frame": (sum(syncs.values()) / len(frames) if on_card
                                 else "not measured"),
        "launches": dict(launches) if launches is not None else None,
        "seconds": seconds}))


if __name__ == "__main__":
    main()
