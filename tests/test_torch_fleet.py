"""``run_fleet`` (``limo_tpu_torch/pipeline/scan_odometry.py``) over CPU
devices against the port's ``run_batch``, bit for bit, and the port's
batch against the reference package's vmapped ``run_batch``, in float64,
on ``torch_parity.batch_drives()``.

Against the reference's run_batch every decision is equal and poses and
costs lie within 1e-9 (measured: 8.9e-13 in pose, 1.5e-12 in cost). The
reference's own batch tests (``tests/test_scan_odometry.py``) fail on
this tree; the port is held to that function's outputs, not to those
asserts. ``evaluation.evaluate_fleet_synthetic`` runs on CPU devices
against the reference's fleet gate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu.pipeline import scan_odometry as jso
from limo_tpu_torch.pipeline import evaluation as tev
from limo_tpu_torch.pipeline import scan_odometry as tso
from torch_parity import (BATCH_FRAMES, BATCH_SEEDS, SCAN_DISCRETE,
                          batch_drives, port_of, trees_equal)

POSE_ATOL = COST_RTOL = 1e-9


@pytest.fixture(scope="module")
def drives():
    return batch_drives()


@pytest.fixture(scope="module")
def port_fleet(drives):
    """The three drives dealt over four CPU devices."""
    sb, ub, vb, rig, cfg = drives
    trig, tcfg = port_of(rig, cfg)
    return tso.run_fleet(sb, ub, vb, trig, tcfg, dtype=torch.float64,
                         devices=["cpu"] * 4)


def test_run_fleet_equals_run_batch(drives, port_fleet):
    sb, ub, vb, rig, cfg = drives
    trig, tcfg = port_of(rig, cfg)
    batch = tso.run_batch(sb, ub, vb, trig, tcfg, dtype=torch.float64,
                          device="cpu")
    assert trees_equal(port_fleet, batch)
    assert port_fleet[1].pose.shape == (len(BATCH_SEEDS), BATCH_FRAMES, 7)


def test_fleet_matches_reference_run_batch(drives, port_fleet):
    sb, ub, vb, rig, cfg = drives
    _, ref = jax.device_get(jso.run_batch(sb[:2], ub[:2], vb[:2], rig, cfg,
                                          dtype=jnp.float64))
    out = port_fleet[1]
    for f in SCAN_DISCRETE:
        np.testing.assert_array_equal(getattr(out, f)[:2].numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(out.pose[:2].numpy(), np.asarray(ref.pose),
                               rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(out.cost[:2].numpy(), np.asarray(ref.cost),
                               rtol=COST_RTOL, atol=0)
    assert int(out.solved[:2].sum()) > 0


def test_fleet_devices():
    assert tso.fleet_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="empty device list"):
        tso.fleet_devices([])


def test_evaluate_fleet_synthetic_on_cpu_devices(tmp_path):
    """tests/test_evaluation.py::TestKittiIO::test_fleet_evaluator through
    the port, its fleet dealt over two CPU devices."""
    reps = tev.evaluate_fleet_synthetic(num_sequences=2, num_frames=25,
                                        devices=["cpu", "cpu"],
                                        out_dir=str(tmp_path))
    assert [r.name for r in reps] == ["fleet-0", "fleet-1"]
    for r in reps:
        assert r.ate < 0.5, r.to_json()
        assert r.fps > 0 and r.n_frames == 25
    assert (tmp_path / "00.txt").exists() and (tmp_path / "01.txt").exists()
