"""Trajectory evaluation metrics.

The reference reports KITTI-leaderboard drift (translation %/rotation °/m over
100–800 m segments) and the build targets add ATE (BASELINE.md). Implemented
host-side in numpy — evaluation is offline. A copy of the reference
package's ``limo_tpu/pipeline/metrics.py``, so that the port's drives are
scored without that package.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

KITTI_SEGMENT_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative path length per frame from [N,4,4] poses (origin←frame)."""
    t = poses[:, :3, 3]
    d = np.linalg.norm(np.diff(t, axis=0), axis=-1)
    return np.concatenate([[0.0], np.cumsum(d)])


def _rot_angle(R: np.ndarray) -> float:
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def kitti_drift(poses_gt: np.ndarray, poses_est: np.ndarray,
                lengths=KITTI_SEGMENT_LENGTHS, step: int = 10
                ) -> Dict[str, float]:
    """KITTI odometry benchmark error: average translation (%) and rotation
    (deg/m) over all subsequences of the standard lengths."""
    n = min(len(poses_gt), len(poses_est))
    gt, est = poses_gt[:n], poses_est[:n]
    dist = trajectory_distances(gt)
    t_errs: List[float] = []
    r_errs: List[float] = []
    for first in range(0, n, step):
        for seg in lengths:
            # find frame where gt path length exceeds first+seg
            target = dist[first] + seg
            idx = np.searchsorted(dist, target)
            if idx >= n:
                continue
            dgt = np.linalg.inv(gt[first]) @ gt[idx]
            dest = np.linalg.inv(est[first]) @ est[idx]
            err = np.linalg.inv(dest) @ dgt
            t_errs.append(np.linalg.norm(err[:3, 3]) / seg)
            r_errs.append(_rot_angle(err[:3, :3]) / seg)
    if not t_errs:
        return {"t_err_percent": float("nan"), "r_err_deg_per_m": float("nan"),
                "num_segments": 0}
    return {
        "t_err_percent": 100.0 * float(np.mean(t_errs)),
        "r_err_deg_per_m": float(np.degrees(np.mean(r_errs))),
        "num_segments": len(t_errs),
    }


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares rigid (optionally similarity) alignment src→dst."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    scale = float(np.trace(np.diag(D) @ S) / xs.var(0).sum()) if with_scale else 1.0
    t = mu_d - scale * R @ mu_s
    return R, t, scale


def ate_rmse(poses_gt: np.ndarray, poses_est: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error (RMSE of aligned positions)."""
    n = min(len(poses_gt), len(poses_est))
    gt = poses_gt[:n, :3, 3]
    est = poses_est[:n, :3, 3]
    if align and n >= 3:
        R, t, s = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((gt - est) ** 2, -1))))
