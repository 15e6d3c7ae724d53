"""The port's tuning grid (``scan_odometry.run_tuning_grid``) with the
shrubbery column, against the reference package's in float64
(``torch_parity.assert_grid_equal``: decisions equal, poses within 1e-9,
costs within 1e-7 relative), and each grid point against the port's
``run_sequence`` under that point's config, bit for bit, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu.config import (CapacityConfig, LandmarkSelectionConfig,
                             LimoConfig)
from limo_tpu.pipeline import scan_odometry as jso
from limo_tpu_torch.pipeline import scan_odometry as tso
from limo_tpu_torch.pipeline import tuning as ttuning
from torch_parity import (TUNE_FRAMES, TUNE_ROWS, assert_grid_equal,
                          f64_rig, port_of, tuning_drive)


@pytest.fixture(scope="module")
def shrub_drive():
    """grid_search_fused's world at 30 frames x 256 rows (labelled
    vegetation with extra pixel jitter) and its config, in float64."""
    world, stamps, uvd, valid, labels, _ = ttuning.fused_grid_world(
        TUNE_FRAMES, 0, None, TUNE_ROWS)
    cfg = LimoConfig(
        capacity=CapacityConfig(max_keyframes=12, max_landmarks=TUNE_ROWS,
                                max_cameras=1),
        landmark_selection=LandmarkSelectionConfig(height_over_ground=1.65))
    return (stamps, uvd, valid), labels, f64_rig(world), cfg


@pytest.fixture(scope="module")
def grid_drive():
    return tuning_drive()


def test_tuning_grid_shrubbery_column_matches_reference(shrub_drive):
    """Three columns: the shrubbery weight enters the landmark weights."""
    chans, labels, rig, cfg = shrub_drive
    grid = np.array([[0.16, 1.6, 1.0], [0.10, 1.0, 0.2]])
    _, ref = jax.device_get(jso.run_tuning_grid(
        *chans, rig, cfg, grid, dtype=jnp.float64, labels=labels))
    trig, tcfg = port_of(rig, cfg)
    _, out = tso.run_tuning_grid(*chans, trig, tcfg, grid,
                                 dtype=torch.float64, labels=labels,
                                 device="cpu")
    assert_grid_equal(out, ref)


def test_tuning_grid_point_is_run_sequence(grid_drive):
    """Every point of a two-point grid, final state included, is the port's
    run_sequence under ``tuning.apply_point``'s config, bit for bit: the
    second point starts from the same initial state and channels as the
    first, and nothing of the first leaks into it."""
    (stamps, uvd, valid), rig, cfg = grid_drive
    trig, tcfg = port_of(rig, cfg)
    n = 10                                       # frames: a cut of the drive
    chans = (stamps[:n], uvd[:n], valid[:n])
    grid = np.array([[0.16, 1.6, 1.0], [0.10, 1.0, 0.3]])
    final, out = tso.run_tuning_grid(*chans, trig, tcfg, grid,
                                     dtype=torch.float64, device="cpu")
    for g, (d, r, s) in enumerate(grid.tolist()):
        pcfg = ttuning.apply_point(tcfg, d, r, s)
        one = tso.run_sequence(*chans, trig, pcfg, dtype=torch.float64,
                               device="cpu")
        for a, b in zip(tso.FrameOut(*[t[g] for t in out]), one[1]):
            assert torch.equal(a, b)
        assert torch.equal(final.window.poses[g], one[0].window.poses)


@pytest.mark.parametrize("shape", [(2, 4), (2, 1), (6,)])
def test_tuning_grid_rejects_bad_columns(grid_drive, shape):
    (stamps, uvd, valid), rig, cfg = grid_drive
    trig, tcfg = port_of(rig, cfg)
    with pytest.raises(ValueError, match="2 or 3 columns"):
        tso.run_tuning_grid(stamps[:2], uvd[:2], valid[:2], trig, tcfg,
                            np.ones(shape), dtype=torch.float64,
                            device="cpu")
