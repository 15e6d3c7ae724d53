"""The port's scan step (limo_tpu_torch.pipeline.scan_odometry) against the
reference package's, on the small lidar-depth drive in float64 on the CPU.

(a) step by step: before each frame the reference's state is handed to the
port, so every frame is compared from the same state (the drive is chaotic
enough that f32 and f64 trajectories part, so a free-running comparison
alone would not localize a fault); (b) free running: both packages'
run_sequence over the whole drive, compared frame by frame. Tolerances in
tests/torch_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu.pipeline import scan_odometry as jso
from limo_tpu_torch.pipeline import scan_odometry as tso
from limo_tpu_torch import state as tstate
from torch_parity import (SCAN_COST_RTOL, assert_frame_out, assert_scan_state,
                          port_of, scan_drive, scan_step_by_step)


def test_depth_drive_step_by_step():
    """Every frame of the depth drive from the reference's state: equal
    decisions, close poses, costs of the attempted solves within their
    tolerance, and the next state. The drive attempts solves (the guard
    rejects them all, as in the reference) and the step reads the host
    once per frame plus each solve's own reads."""
    outs, step = scan_step_by_step("depth")
    costs = np.array([float(o.cost) for o in outs])
    kf = np.array([bool(o.is_keyframe) for o in outs])
    assert (costs != 0).sum() == 6 and kf.sum() == 8
    assert len(step.stats.solves) == 6
    assert step.stats.frames == len(outs)
    assert step.stats.host_syncs == len(outs) + sum(
        i.n_host_syncs for i in step.stats.solves)


def test_depth_drive_free_running():
    """Both packages' run_sequence over the whole depth drive: no decision
    flips, every frame within the step-by-step tolerances, and the same
    final state."""
    chans, rig, cfg, world = scan_drive("depth")
    jst, jout = jso.run_sequence(rig=rig, cfg=cfg, dtype=jnp.float64,
                                 **chans)
    trig, tcfg = port_of(rig, cfg)
    tst, tout = tso.run_sequence(rig=trig, cfg=tcfg, dtype=torch.float64,
                                 device="cpu", **chans)
    assert_frame_out(jax.device_get(jout), tout, SCAN_COST_RTOL["depth"],
                     "depth free running")
    assert_scan_state(jax.device_get(jst), tstate.scan_state_to_numpy(tst),
                      "depth free running final state")
    np.testing.assert_allclose(tso.poses_kitti(tout),
                               jso.poses_kitti(jax.device_get(jout)),
                               rtol=0, atol=1e-8)


def test_prior_modes():
    """"identity" runs the step with no motion model: the prior of every
    frame after the first is the last pose; the 5-point "essential" prior
    runs (tests/test_torch_essential.py holds it to the reference); an
    unknown mode raises."""
    chans, rig, cfg, _ = scan_drive("depth", num_frames=4)
    trig, tcfg = port_of(rig, cfg)
    ess = tso.make_scan_step(trig, tcfg, prior_mode="essential")
    with pytest.raises(ValueError):
        tso.make_scan_step(trig, tcfg, prior_mode="bogus")
    step = tso.make_scan_step(trig, tcfg, prior_mode="identity")
    xs = tso.frame_arrays(chans["stamps"], chans["uvd_seq"],
                          chans["valid_seq"], tcfg, torch.float64,
                          stamp_dtype=torch.float64, device="cpu")
    st = tso.init_state(tcfg.capacity, torch.float64,
                        tcfg.prior.default_speed, "cpu")
    for i in range(4):
        last = st.cur_pose
        st, out = step(st, tuple(x[i] for x in xs))
        if i > 0:
            assert torch.equal(out.prior, last)
    st = tso.init_state(tcfg.capacity, torch.float64,
                        tcfg.prior.default_speed, "cpu")
    for i in range(4):
        st, out = ess(st, tuple(x[i] for x in xs))
        assert bool(torch.isfinite(out.pose).all())
