"""The port's tuning path (``scan_odometry.make_tuning_runner``,
``run_tuning_grid``; ``pipeline/tuning.py``) against the reference
package's, on the CPU.

A two-column grid runs in float64 against the reference's vmapped
``run_tuning_grid`` (``torch_parity.assert_grid_equal``: every decision
equal, poses within 1e-9, costs within 1e-7 relative, the scan parity
tests' standard). The sweep helpers (``grid_search``, ordering and NaN
rules) are held to ``tests/test_tuning_transforms.py``'s cases. The shrubbery column
and chunking: ``test_torch_tuning_grid.py``; ``grid_search_fused``:
``test_torch_tuning_fused.py``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu.pipeline import scan_odometry as jso
from limo_tpu.pipeline import tuning as jtuning
from limo_tpu_torch.config import LimoConfig as TLimoConfig
from limo_tpu_torch.pipeline import scan_odometry as tso
from limo_tpu_torch.pipeline import tuning as ttuning
from torch_parity import (TUNE_FRAMES, assert_grid_equal, port_of,
                          tuning_drive)


@pytest.fixture(scope="module")
def grid_drive():
    return tuning_drive()


def test_tuning_grid_matches_reference(grid_drive):
    """Two (depth_thres, reprojection_thres) points."""
    chans, rig, cfg = grid_drive
    grid = np.array([[0.16, 1.6], [0.10, 1.0]])
    _, ref = jax.device_get(jso.run_tuning_grid(*chans, rig, cfg, grid,
                                                dtype=jnp.float64))
    trig, tcfg = port_of(rig, cfg)
    _, out = tso.run_tuning_grid(*chans, trig, tcfg, grid,
                                 dtype=torch.float64, device="cpu")
    assert out.pose.shape == (2, TUNE_FRAMES, 7)
    assert_grid_equal(out, ref)
    # different loss scales give different trajectories
    assert not torch.allclose(out.pose[0], out.pose[1])


def test_tuning_point_is_run_sequence(grid_drive):
    """A grid row runs as run_sequence under apply_point's config."""
    (stamps, uvd, valid), rig, cfg = grid_drive
    trig, tcfg = port_of(rig, cfg)
    n = 12
    _, out = tso.run_tuning_grid(stamps[:n], uvd[:n], valid[:n], trig, tcfg,
                                 np.array([[0.10, 1.0, 0.5]]),
                                 dtype=torch.float64, device="cpu")
    _, one = tso.run_sequence(stamps[:n], uvd[:n], valid[:n], trig,
                              ttuning.apply_point(tcfg, 0.10, 1.0, 0.5),
                              dtype=torch.float64, device="cpu")
    for a, b in zip(out, one):
        assert torch.equal(a[0], b)


# ---------------------------------------------------------------------------
# grid_search: the sweep shape with a fake evaluator, both packages
# ---------------------------------------------------------------------------

def fake_drift(cfg):
    # lower depth_thres -> better drift (deterministic)
    return {"ate_m": cfg.robust.depth_thres,
            "t_err_percent": cfg.robust.depth_thres * 10,
            "r_err_deg_per_m": 0.001}


def fake_nan_drift(cfg):
    return {"ate_m": cfg.robust.depth_thres, "t_err_percent": float("nan"),
            "r_err_deg_per_m": float("nan")}


def fake_one_diverged(cfg):
    if cfg.robust.depth_thres == 0.1:        # "diverged": NaN drift, tiny ATE
        return {"ate_m": 0.001, "t_err_percent": float("nan"),
                "r_err_deg_per_m": float("nan")}
    return {"ate_m": 5.0, "t_err_percent": 2.0, "r_err_deg_per_m": 0.01}


@pytest.mark.parametrize("evaluate,depth,key", [
    (fake_drift, (0.2, 0.1), "t_err_percent"),
    (fake_drift, (0.2, 0.1), "ate_m"),
    (fake_nan_drift, (0.3, 0.1), "t_err_percent"),
    (fake_one_diverged, (0.1, 0.2), "t_err_percent"),
    (fake_one_diverged, (0.1, 0.2), "ate_m"),
])
def test_grid_search_matches_reference(evaluate, depth, key):
    kw = dict(depth_thres=depth, reprojection_thres=(1.0, 1.6),
              shrubbery_weights=(0.9,), key=key)
    seen = []

    def recording(cfg):
        seen.append((cfg.robust.depth_thres, cfg.robust.reprojection_thres,
                     cfg.regularization.shrubbery_weight))
        return evaluate(cfg)

    pts = ttuning.grid_search(evaluate=recording, **kw)
    ref = jtuning.grid_search(evaluate=evaluate, **kw)
    assert [p.to_json() for p in pts] == [p.to_json() for p in ref]
    assert len(pts) == 4 and len(set(seen)) == 4
    if evaluate is fake_one_diverged and key == "t_err_percent":
        assert pts[0].depth_thres == 0.2 and pts[-1].depth_thres == 0.1
    if evaluate is fake_nan_drift:
        assert pts[0].depth_thres == 0.1          # ATE fallback


def test_grid_search_checks_key_first():
    def must_not_run(cfg):
        raise AssertionError("evaluated despite a bad key")

    with pytest.raises(ValueError, match="unknown sort key"):
        ttuning.grid_search(evaluate=must_not_run, key="t_err")
    with pytest.raises(ValueError, match="unknown sort key"):
        ttuning.grid_search_fused(key="t_err", device="cpu")


def test_apply_point_and_json():
    cfg = ttuning.apply_point(TLimoConfig(), 0.12, 1.3, 0.5)
    assert (cfg.robust.depth_thres, cfg.robust.reprojection_thres,
            cfg.regularization.shrubbery_weight) == (0.12, 1.3, 0.5)
    p = ttuning.GridPoint(0.1, 1.0, 0.9, 0.01, 0.8, 0.002)
    assert p.to_json() == jtuning.GridPoint(0.1, 1.0, 0.9, 0.01, 0.8,
                                            0.002).to_json()
    assert json.loads(p.to_json())["t_err_percent"] == 0.8
    assert ttuning.REFERENCE_DEPTH_THRES == jtuning.REFERENCE_DEPTH_THRES
    assert ttuning.REFERENCE_REPR_THRES == jtuning.REFERENCE_REPR_THRES


