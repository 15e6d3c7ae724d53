"""Many sequences through the port's scan step: ``run_batch``
(``limo_tpu_torch/pipeline/scan_odometry.py``) against the reference
package's ``run_sequence``, in float64 on the CPU, on
``torch_parity.batch_drives()`` (three 30-frame, 256-row drives that
attempt and accept windowed solves). Tolerances: every decision equal;
poses within 1e-9 (the scan parity tests' standard; measured 8.9e-13) and
the rest of each frame's output within ``assert_frame_out``'s. The port's
batch is a loop over its run_sequence, so against the port itself the
comparison is bit for bit. ``run_fleet`` and the reference's ``run_batch``:
``test_torch_fleet.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu.pipeline import scan_odometry as jso
from limo_tpu_torch.pipeline import scan_odometry as tso
from torch_parity import (BATCH_SEEDS, SCAN_COST_RTOL, assert_frame_out,
                          batch_drives, element, port_of, trees_equal)

POSE_ATOL = 1e-9


@pytest.fixture(scope="module")
def drives():
    return batch_drives()


@pytest.fixture(scope="module")
def port_batch(drives):
    sb, ub, vb, rig, cfg = drives
    trig, tcfg = port_of(rig, cfg)
    return tso.run_batch(sb, ub, vb, trig, tcfg, dtype=torch.float64,
                         device="cpu")


@pytest.mark.parametrize("b", [0, 1])
def test_run_batch_matches_reference_run_sequence(drives, port_batch, b):
    sb, ub, vb, rig, cfg = drives
    _, ref = jax.device_get(jso.run_sequence(sb[b], ub[b], vb[b], rig, cfg,
                                             dtype=jnp.float64))
    out = element(port_batch[1], b)
    assert_frame_out(ref, out, SCAN_COST_RTOL["depth"], f"sequence {b}")
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(ref.pose),
                               rtol=0, atol=POSE_ATOL)
    assert int(out.solved.sum()) > 0       # the drive accepts solves


@pytest.mark.parametrize("b", range(len(BATCH_SEEDS)))
def test_run_batch_element_is_run_sequence(drives, port_batch, b):
    sb, ub, vb, rig, cfg = drives
    trig, tcfg = port_of(rig, cfg)
    one = tso.run_sequence(sb[b], ub[b], vb[b], trig, tcfg,
                           dtype=torch.float64, device="cpu")
    assert trees_equal(element(port_batch[0], b), one[0])
    assert trees_equal(element(port_batch[1], b), one[1])


def test_fleet_without_card_raises(drives, monkeypatch):
    """No visible card: a fleet with no devices named raises, and does not
    run on the CPU."""
    sb, ub, vb, rig, cfg = drives
    trig, tcfg = port_of(rig, cfg)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no visible CUDA device"):
        tso.run_fleet(sb, ub, vb, trig, tcfg)
