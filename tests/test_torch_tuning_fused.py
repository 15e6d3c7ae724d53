"""``pipeline/tuning.grid_search_fused`` through the port against the
reference package's, in float32 (both packages' default) at 30 frames x
256 rows, on the CPU: the same grid points with their ATE and drift within
GRID_METRIC_ATOL (the port's sequential runs against the reference's
vmapped program; measured gaps in the constant's comment)."""

import numpy as np

from limo_tpu.pipeline import tuning as jtuning
from limo_tpu_torch.pipeline import tuning as ttuning
from torch_parity import TUNE_FRAMES as FRAMES
from torch_parity import TUNE_ROWS as ROWS

# ATE m, drift %, drift deg/m, about three times the gaps measured on this
# grid: 6.0e-5 m, 5.7e-4 %, 6.3e-6 deg/m (the 0.10 point; the 0.16 point
# 6.8e-7, 1.1e-6, 4.8e-8)
GRID_METRIC_ATOL = {"ate": 2e-4, "drift_t": 2e-3, "drift_r": 2e-5}


def test_grid_search_fused_matches_reference():
    """Two points, float32, at 30 frames x 256 rows."""
    kw = dict(depth_thres=(0.16, 0.10), reprojection_thres=(1.6,),
              num_frames=FRAMES, landmark_rows=ROWS)
    pts = ttuning.grid_search_fused(device="cpu", **kw)
    ref = jtuning.grid_search_fused(**kw)
    by = lambda ps: {(p.depth_thres, p.reprojection_thres): p for p in ps}
    got, want = by(pts), by(ref)
    assert got.keys() == want.keys() and len(got) == 2
    for k in want:
        for f, atol in GRID_METRIC_ATOL.items():
            np.testing.assert_allclose(getattr(got[k], f),
                                       getattr(want[k], f), rtol=0,
                                       atol=atol, err_msg=f"{k} {f}")
    assert pts[0].drift_t <= pts[1].drift_t
