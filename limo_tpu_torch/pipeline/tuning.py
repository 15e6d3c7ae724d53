"""Parameter grid search — the reference's KITTI tuning harness
(``res/tune_parameters_kitti.py:3-17``: nested loop over
depth_thres × reprojection_thres × shrubbery_weight, each point re-running
``kitti_eval_script.sh`` over all sequences and collecting drift).

Each grid point is one config (``dataclasses.replace`` on the frozen tree)
evaluated by a pluggable callable — the synthetic system gate by default,
or :func:`~.evaluation.evaluate_kitti_sequence` when a dataset is present
(:func:`grid_search`); or the whole grid over one synthetic sequence in one
call (:func:`grid_search_fused`). The loss scales reach the CUDA kernels as
runtime scalars, so no point compiles anything.

    python -m limo_tpu_torch.pipeline.tuning --fused      # on the card
    python -m limo_tpu_torch.pipeline.tuning --fused --device cpu
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from ..config import LimoConfig

# the reference sweep (tune_parameters_kitti.py:4-6)
REFERENCE_DEPTH_THRES = (0.1, 0.11, 0.12, 0.13, 0.14, 0.15, 0.16, 0.17, 0.18, 0.19)
REFERENCE_REPR_THRES = (1.0, 1.1, 1.2, 1.3, 1.4, 1.5, 1.6, 1.7, 1.8, 2.0)
REFERENCE_SHRUBBERY = (0.9,)
SORT_KEYS = ("t_err_percent", "r_err_deg_per_m", "ate_m")


@dataclass
class GridPoint:
    depth_thres: float
    reprojection_thres: float
    shrubbery_weight: float
    ate: float
    drift_t: float
    drift_r: float

    def to_json(self) -> str:
        return json.dumps({
            "depth_thres": self.depth_thres,
            "reprojection_thres": self.reprojection_thres,
            "shrubbery_weight": self.shrubbery_weight,
            "ate_m": round(self.ate, 5),
            "t_err_percent": round(self.drift_t, 5),
            "r_err_deg_per_m": round(self.drift_r, 7),
        })


def apply_point(cfg: LimoConfig, depth_thres: float, reprojection_thres: float,
                shrubbery_weight: float) -> LimoConfig:
    """One grid point as a config (the dynamic_reconfigure set of
    ``kitti_eval_script.sh:64-66``)."""
    return dataclasses.replace(
        cfg,
        robust=dataclasses.replace(cfg.robust, depth_thres=depth_thres,
                                   reprojection_thres=reprojection_thres),
        regularization=dataclasses.replace(
            cfg.regularization, shrubbery_weight=shrubbery_weight))


def _check_key(key: str) -> None:
    if key not in SORT_KEYS:
        raise ValueError(f"unknown sort key {key!r}")


def grid_search(evaluate: Optional[Callable[[LimoConfig], Dict[str, float]]] = None,
                depth_thres: Sequence[float] = REFERENCE_DEPTH_THRES,
                reprojection_thres: Sequence[float] = REFERENCE_REPR_THRES,
                shrubbery_weights: Sequence[float] = REFERENCE_SHRUBBERY,
                base_cfg: Optional[LimoConfig] = None,
                key: str = "t_err_percent",
                verbose: bool = False) -> List[GridPoint]:
    """Sweep the reference's tuning grid; returns points sorted best-first by
    ``key`` (translation drift by default, ATE fallback when drift is NaN).

    ``evaluate(cfg) -> {"ate_m", "t_err_percent", "r_err_deg_per_m"}`` runs
    one full evaluation; defaults to the synthetic system gate on the
    card."""
    _check_key(key)                                # before any evaluation
    if evaluate is None:
        evaluate = _default_evaluate
    base = base_cfg or LimoConfig()
    out: List[GridPoint] = []
    for d, r, w in itertools.product(depth_thres, reprojection_thres,
                                     shrubbery_weights):
        rep = evaluate(apply_point(base, d, r, w))
        pt = GridPoint(d, r, w, ate=rep.get("ate_m", float("nan")),
                       drift_t=rep.get("t_err_percent", float("nan")),
                       drift_r=rep.get("r_err_deg_per_m", float("nan")))
        out.append(pt)
        if verbose:
            print(pt.to_json(), flush=True)
    return _sorted_points(out, key)


def _sorted_points(out: List[GridPoint], key: str) -> List[GridPoint]:
    def score(p: GridPoint):
        v = {"t_err_percent": p.drift_t, "r_err_deg_per_m": p.drift_r,
             "ate_m": p.ate}[key]
        if v == v:
            return (0, v)
        # no valid measurement on the requested metric: rank strictly after
        # every valid point (tie-broken by ATE when finite)
        return (1, p.ate if p.ate == p.ate else float("inf"))

    return sorted(out, key=score)


def fused_grid_world(num_frames: int = 40, seed: int = 0,
                     base_cfg: Optional[LimoConfig] = None,
                     landmark_rows: int = 512):
    """The world and config of :func:`grid_search_fused`: ``base_cfg`` at 12
    keyframe slots × ``landmark_rows`` × 1 camera with a 1.65 m camera
    height, and a world sized to the rows (one row per world landmark) with
    labelled vegetation observed with extra pixel jitter, so that the
    shrubbery weight has something to tune against. Returns (world, stamps
    [F], uvd [F,R,3], valid [F,R], labels [F,R], cfg)."""
    from .synthetic import dense_tracks, make_world

    cfg = base_cfg or LimoConfig()
    cfg = dataclasses.replace(
        cfg,
        capacity=dataclasses.replace(
            cfg.capacity, max_keyframes=12, max_landmarks=landmark_rows,
            max_cameras=1),
        landmark_selection=dataclasses.replace(
            cfg.landmark_selection, height_over_ground=1.65))
    n_lm = min(260, int(landmark_rows * 0.6))
    n_shrub = min(60, max(0, landmark_rows - n_lm - 80))
    world = make_world(num_frames=num_frames, speed=8.0, yaw_rate=0.015,
                       n_landmarks=n_lm, n_ground=min(80, landmark_rows - n_lm),
                       n_shrubbery=n_shrub, seed=seed)
    stamps, uvd, valid, labels = dense_tracks(
        world, landmark_rows, with_depth=True, seed=seed + 100,
        with_labels=True, shrubbery_px_noise=1.5)
    return world, stamps, uvd, valid, labels, cfg


def grid_search_fused(depth_thres: Sequence[float] = REFERENCE_DEPTH_THRES,
                      reprojection_thres: Sequence[float] = REFERENCE_REPR_THRES,
                      shrubbery_weights: Sequence[float] = REFERENCE_SHRUBBERY,
                      num_frames: int = 40, seed: int = 0,
                      base_cfg: Optional[LimoConfig] = None,
                      landmark_rows: int = 512,
                      key: str = "t_err_percent",
                      verbose: bool = False, device="cuda") -> List[GridPoint]:
    """The whole tuning grid over one synthetic sequence in one call.

    All three reference sweep dimensions (``res/tune_parameters_kitti.py:
    3-17``: depth_thres × reprojection_thres × shrubbery_weight) form a
    ``[G,3]`` grid run by :func:`~.scan_odometry.run_tuning_grid` over the
    world of :func:`fused_grid_world`: the sequence is put on ``device``
    once and shared, the grid's trajectories come back to the host
    together, and the metrics loop is numpy."""
    import numpy as np

    from ..geometry.camera import CameraRig
    from . import scan_odometry as so
    from .metrics import ate_rmse, kitti_drift

    _check_key(key)
    world, stamps, uvd, valid, labels, cfg = fused_grid_world(
        num_frames, seed, base_cfg, landmark_rows)
    rig = CameraRig.single(world.focal, world.principal[0],
                           world.principal[1], T_cam_veh=world.T_cam_veh,
                           device=device)
    grid = np.asarray(list(itertools.product(depth_thres, reprojection_thres,
                                             shrubbery_weights)))
    _, outs = so.run_tuning_grid(stamps, uvd, valid, rig, cfg, grid,
                                 labels=labels, device=device)
    # every trajectory to the host at once; the metrics loop below is numpy
    outs = so.FrameOut(*[t.cpu() for t in outs])

    gt = world.kitti_gt()
    out: List[GridPoint] = []
    for g, (d, r, s) in enumerate(grid):
        est = so.poses_kitti(so.FrameOut(*[t[g] for t in outs]))
        drift = kitti_drift(gt, est, lengths=(20.0, 30.0), step=5)
        pt = GridPoint(float(d), float(r), float(s),
                       ate=ate_rmse(gt, est),
                       drift_t=drift["t_err_percent"],
                       drift_r=drift["r_err_deg_per_m"])
        out.append(pt)
        if verbose:
            print(pt.to_json(), flush=True)
    return _sorted_points(out, key)


def _default_evaluate(cfg: LimoConfig, num_frames: int = 40,
                      seed: int = 0, device="cuda") -> Dict[str, float]:
    from .evaluation import evaluate_synthetic_sequence
    rep = evaluate_synthetic_sequence(num_frames=num_frames, seed=seed,
                                      cfg=cfg, device=device)
    return {"ate_m": rep.ate, **rep.drift}


def main(argv=None):
    import argparse
    import time

    p = argparse.ArgumentParser(
        description="Sweep the reference's tuning grid; one JSON line per "
                    "point, then the best point and the sweep's rate.")
    p.add_argument("--depth", type=float, nargs="+",
                   default=list(REFERENCE_DEPTH_THRES))
    p.add_argument("--repr", dest="repr_", type=float, nargs="+",
                   default=list(REFERENCE_REPR_THRES))
    p.add_argument("--shrubbery", type=float, nargs="+",
                   default=list(REFERENCE_SHRUBBERY))
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--fused", action="store_true",
                   help="run the whole grid over one sequence in one call")
    p.add_argument("--device", default="cuda",
                   help="where the sweep runs (default: the card)")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    if args.fused:
        pts = grid_search_fused(depth_thres=args.depth,
                                reprojection_thres=args.repr_,
                                shrubbery_weights=args.shrubbery,
                                num_frames=args.frames, verbose=True,
                                device=args.device)
    else:
        pts = grid_search(
            evaluate=lambda cfg: _default_evaluate(
                cfg, num_frames=args.frames, device=args.device),
            depth_thres=args.depth, reprojection_thres=args.repr_,
            shrubbery_weights=args.shrubbery, verbose=True)
    seconds = time.perf_counter() - t0
    print("# best:")
    print(pts[0].to_json())
    print(json.dumps({"points": len(pts), "seconds": seconds,
                      "points_per_s": len(pts) / seconds,
                      "device": args.device}))


if __name__ == "__main__":
    main()
