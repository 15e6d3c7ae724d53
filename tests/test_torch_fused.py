"""The port's fused pipeline (limo_tpu_torch.pipeline.fused) against the
reference package's, on test_fused.py's rendered world (16 frames, labels
on, ``small_configs()``: 12 × 768 slots, 256 features) in float64 on the
CPU.

The reference's ``run_fused`` fails in float64 (its scan carry's stamp type
changes), so its drive is built here from its own parts, as its runner
builds it: gamma + ``detect``, the label sampling and
``frontend_depth_plane`` per frame, then its jitted ``make_fused_step``
frame by frame.

(a) step by step: before each frame the reference's FusedState is handed to
the port, the reference's per-feature channels go to both steps, and the
FusedOut and the next state are compared; (b) the port's front end (the
runner's first two passes) against the reference's channels; (c) free
running: the port's ``run_fused`` whole and in chunks of 6 (the last one
padded by replaying its last frame) bit-identical, and against the
reference's drive. Tolerances in tests/torch_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu.frontend import tracker as jtrk
from limo_tpu.frontend.semantics import dilate_labels, sample_labels
from limo_tpu.pipeline import full as jfull
from limo_tpu.pipeline import fused as jfused
from limo_tpu.window_manager import DEFAULT_OUTLIER_LABELS
from limo_tpu_torch import state as tstate
from limo_tpu_torch.pipeline import fused as tfused
from torch_parity import (SCAN_ATOL, SCAN_RTOL, assert_close,
                          assert_scan_state, fused_world, pipeline_config_of)

N_FRAMES = 16
DISCRETE = ("is_keyframe", "solved", "po_ok", "n_usable", "n_rate",
            "n_tracks", "n_matches", "n_depth")
CONTINUOUS = ("pose", "prior", "refined", "speed_obs")
COST_RTOL = 1e-7


def _ref_channels(imgs_u8, clouds, labels, rig, pcfg):
    """The reference runner's first two passes in float64: per-frame
    (uv, desc, valid, depth, label, plane, plane_ok), each with a frame
    axis, as numpy."""
    tcfg, lcfg = pcfg.tracker, pcfg.lidar
    imgs = (jnp.asarray(imgs_u8, jnp.float64) / 255.0) ** (1.0 / pcfg.gamma)
    feats = jax.jit(jax.vmap(lambda im: jtrk.detect(im, tcfg)))(imgs)
    out_tab = jnp.asarray(sorted(DEFAULT_OUTLIER_LABELS), jnp.int32)

    @jax.jit
    def lab_one(li, uv):
        li = li.astype(jnp.int32)
        return sample_labels(dilate_labels(li, jnp.isin(li, out_tab)), uv)

    lab = jax.vmap(lab_one)(jnp.asarray(labels), feats.uv)
    W, H = imgs_u8.shape[2], imgs_u8.shape[1]
    depth_plane = jax.jit(lambda c, cv, uv: jfull.frontend_depth_plane(
        c, cv, rig.T_cam_veh[0], uv, rig.focal[0], rig.principal[0], (W, H),
        lcfg, pcfg.use_groundplane, tuple(pcfg.gp_band)))
    cloud, valid = jfused.pad_clouds(clouds, pcfg.cloud_capacity, np.float64)
    per_frame = [jax.device_get(depth_plane(cloud[i], valid[i], feats.uv[i]))
                 for i in range(len(clouds))]
    d, planes, planes_ok = (np.stack(x) for x in zip(*per_frame))
    feats = jax.device_get(feats)
    return (feats.uv, feats.desc, feats.valid, d, np.asarray(lab), planes,
            planes_ok)


@pytest.fixture(scope="module")
def drive():
    """The reference's drive: its channels, its FusedState before each frame
    and its FusedOut of each frame (numpy), and the port's configs."""
    world, stamps, imgs, clouds, labels, cfg, pcfg, rig = fused_world(N_FRAMES)
    chans = _ref_channels(imgs, clouds, labels, rig, pcfg)
    step = jax.jit(jfused.make_fused_step(rig, cfg, pcfg,
                                          tuple(world.image_size), True))
    st = jfused.init_fused_state(cfg, pcfg, jnp.float64)
    states, outs = [], []
    for i in range(N_FRAMES):
        states.append(jax.device_get(st))
        st, out = step(st, (jnp.asarray(stamps[i], jnp.float64),
                            *(jnp.asarray(c[i]) for c in chans)))
        outs.append(jax.device_get(out))
    tpcfg = pipeline_config_of(pcfg)
    return dict(world=world, stamps=stamps, imgs=imgs, clouds=clouds,
                labels=labels, chans=chans, states=states, outs=outs,
                end_state=jax.device_get(st), tcfg=tpcfg.limo, tpcfg=tpcfg,
                trig=tstate.rig_from_numpy(rig, "cpu"))


def assert_fused_out(ref, port, where):
    for f in DISCRETE:
        np.testing.assert_array_equal(np.asarray(getattr(port, f)),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{where} FusedOut.{f}")
    for f in CONTINUOUS:
        assert_close(getattr(port, f), getattr(ref, f), SCAN_RTOL, SCAN_ATOL,
                     f"{where} FusedOut.{f}")
    assert_close(port.cost, ref.cost, COST_RTOL, 0.0, f"{where} FusedOut.cost")


def _assert_fused_state(ref, port, where):
    assert_scan_state(ref.scan, port.scan, f"{where} scan")
    for name, a, b in zip(ref._fields[1:], ref[1:], port[1:]):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(b, a, err_msg=f"{where} {name}")
        else:
            assert_close(b, a, SCAN_RTOL, SCAN_ATOL, f"{where} {name}")


def test_fused_step_by_step(drive):
    """Every frame from the reference's state and channels: equal decisions
    and counts, close poses and costs, the same next state (slot map,
    previous features, match count included). The drive keyframes, runs
    windowed solves and reads the host once per frame plus the solves'."""
    step = tfused.make_fused_step(drive["trig"], drive["tcfg"],
                                  drive["tpcfg"])
    chans = [torch.as_tensor(np.array(c)) for c in drive["chans"]]
    stamps = torch.as_tensor(drive["stamps"], dtype=torch.float64)
    nxt = drive["states"][1:] + [drive["end_state"]]
    for i in range(N_FRAMES):
        st = tstate.fused_state_from_numpy(drive["states"][i], "cpu")
        st, out = step(st, (stamps[i], *(c[i] for c in chans)))
        assert_fused_out(drive["outs"][i], out, f"frame {i}")
        _assert_fused_state(nxt[i], tstate.fused_state_to_numpy(st),
                            f"frame {i} next state")
    kf = sum(bool(o.is_keyframe) for o in drive["outs"])
    attempted = sum(float(o.cost) != 0 for o in drive["outs"])
    assert kf >= 4 and attempted >= 1, (kf, attempted)
    assert step.stats.host_syncs == N_FRAMES + sum(
        i.n_host_syncs for i in step.stats.solves)


def test_front_end_passes(drive):
    """The port runner's first two passes (gamma + batched detect + labels,
    then depth and plane per frame) on the drive's first six frames: the
    reference's channels."""
    tpcfg = drive["tpcfg"]
    runner = tfused.make_fused_runner(drive["trig"], drive["tcfg"], tpcfg,
                                      tuple(drive["world"].image_size), True)
    _, xs = next(tfused.chunks(drive["stamps"], drive["imgs"],
                               drive["clouds"], tpcfg, drive["labels"], 6,
                               torch.float64, "cpu"))
    port = runner.front_end(xs, torch.float64)[1:]
    names = ("uv", "desc", "valid", "depth", "label", "plane", "plane_ok")
    for name, a, b in zip(names, drive["chans"], port):
        a, b = np.asarray(a)[:6], b.numpy()
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            assert_close(b, a, 1e-9, 1e-12, name)
    assert (drive["chans"][3][:6] > 0).sum() > 100


def test_run_fused_free_running(drive):
    """The port's run_fused: chunks of 6 (the last padded by replaying its
    last frame) bit-identical to one chunk, and every frame within the
    step-by-step tolerances of the reference's drive."""
    args = (drive["stamps"], drive["imgs"], drive["clouds"], drive["trig"],
            drive["tcfg"], drive["tpcfg"])
    kw = dict(label_images=drive["labels"], dtype=torch.float64,
              device="cpu")
    _, whole = tfused.run_fused(*args, **kw)
    _, chunked = tfused.run_fused(*args, chunk=6, **kw)
    for name, a, b in zip(tfused.FusedOut._fields, whole, chunked):
        assert a.shape[0] == N_FRAMES and torch.equal(a, b), name
    for i, ref in enumerate(drive["outs"]):
        assert_fused_out(ref, tfused.FusedOut(*[x[i] for x in whole]),
                         f"free running frame {i}")
    np.testing.assert_allclose(
        tfused.poses_kitti(whole),
        jfused.poses_kitti(jfused.FusedOut(
            *[np.stack(f) for f in zip(*drive["outs"])])),
        rtol=0, atol=1e-8)
