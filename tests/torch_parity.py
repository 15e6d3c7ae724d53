"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages: the
reference package (JAX, on the CPU) and the PyTorch port, through the
port's carry-over functions (``limo_tpu_torch.state.*_from_numpy``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import _make_problem
from limo_tpu.config import CapacityConfig, LimoConfig
from limo_tpu.geometry.camera import CameraRig as JaxRig
from limo_tpu.pipeline import scan_odometry as jso
from limo_tpu.pipeline.synthetic import dense_tracks, make_world
from limo_tpu.state import Window as JaxWindow
from limo_tpu_torch import state as tstate
from limo_tpu_torch.pipeline import scan_odometry as tso

# One intra-op thread per test process. The tier-1 run starts six workers
# on the CPU's cores, and every worker imports this module; PyTorch's
# default of one thread per core in each oversubscribed the cores many
# times over.
torch.set_num_threads(1)


def to_torch(w, sel, rig, cfg, device="cpu"):
    """The reference package's (window, sel, rig, cfg) as the port's."""
    return (tstate.window_from_numpy(w, device),
            tstate.selection_from_numpy(sel, device),
            tstate.rig_from_numpy(rig, device),
            tstate.config_from_dict(dataclasses.asdict(cfg)))


def rich_problem(seed=1, dtype=jnp.float64):
    """``_make_problem(8, 256, 6, 200)`` with every assembly family on:
    valid groundplanes, groundplane landmarks with ``gp_weight > 0``,
    label weights, and the scale regularizer. Returns the reference
    package's (window, sel, rig, cfg)."""
    w, sel, rig, cfg = _make_problem(8, 256, 6, 200, dtype, seed=seed)
    rng = np.random.default_rng(seed + 100)
    K_used, L_used, L = 6, 200, w.L
    planes = np.array(w.planes)
    n = np.array([0.0, 0.0, 1.0]) + rng.normal(0, 0.05, (K_used, 3))
    planes[:K_used, :3] = n / np.linalg.norm(n, axis=1, keepdims=True)
    planes[:K_used, 3] = rng.normal(-30.0, 2.0, K_used)
    plane_valid = np.zeros(w.K, bool)
    plane_valid[:K_used] = True
    is_gp = np.zeros(L, bool)
    is_gp[:L_used] = rng.uniform(size=L_used) < 0.3
    lm_weight = np.ones(L)
    lm_weight[:L_used] = rng.uniform(0.5, 1.0, L_used)
    gp_weight = np.where(is_gp, rng.uniform(0.2, 1.0, L), 0.0)
    gp_kf = rng.integers(0, K_used, L).astype(np.int32)
    t = np.array(w.poses)[:, 4:]
    w = w._replace(planes=jnp.asarray(planes, dtype),
                   plane_valid=jnp.asarray(plane_valid),
                   lm_is_gp=jnp.asarray(is_gp),
                   lm_weight=jnp.asarray(lm_weight, dtype))
    sel = sel._replace(
        gp_kf=jnp.asarray(gp_kf), gp_weight=jnp.asarray(gp_weight, dtype),
        scale_target=jnp.asarray(1.05 * np.linalg.norm(t[1] - t[0]), dtype),
        scale_weight=jnp.asarray(50.0, dtype))
    return w, sel, rig, cfg


def to_jax(w, rig):
    """The port's (window, rig) as the reference package's."""
    return (JaxWindow(*[jnp.asarray(x) for x in tstate.window_to_numpy(w)]),
            JaxRig(*[jnp.asarray(x.cpu().numpy()) for x in rig]))


def assert_close(actual, desired, rtol, atol=0.0, err_msg=""):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(desired, np.float64),
                               rtol=rtol, atol=atol, err_msg=err_msg)


# ---------------------------------------------------------------------------
# The scan step: small drives, handed to both packages
# ---------------------------------------------------------------------------

SCAN_ROWS = 256

# The drives of the scan tests. The reference's f64 run_sequence on each
# (measured): depth 8 keyframes, 6 attempted solves, 0 accepted; labels 15
# keyframes, 13 attempted; mono with external priors 12 keyframes, 5
# attempted, 5 accepted.
SCAN_DRIVES = {
    "depth": dict(world={}, with_depth=True, labels=False, priors=False),
    "labels": dict(world=dict(n_shrubbery=20, n_dynamic=15), with_depth=True,
                   labels=True, priors=False),
    "mono_prior": dict(world={}, with_depth=False, labels=False, priors=True),
}

# FrameOut.cost is the final cost of the frame's attempted windowed solve.
# On the labelled drive some solves pass through an ill-conditioned reduced
# system, where the f64 sum order alone moves an LM step: on the same input
# the reference's own solve lands 8e-6 (relative) from the port's, with the
# same accept/reject trace, iterations and trims. Elsewhere the gap is
# below 1e-8.
SCAN_COST_RTOL = {"depth": 1e-7, "labels": 1e-4, "mono_prior": 1e-7}
SCAN_DISCRETE = ("is_keyframe", "solved", "po_ok", "n_usable", "n_rate")
SCAN_CONTINUOUS = ("pose", "prior", "refined", "speed_obs")
SCAN_ATOL = SCAN_RTOL = 1e-8


def scan_drive(kind, num_frames=24):
    """The reference package's inputs for one small drive:
    (frame channels for ``frame_arrays`` as a dict, rig, cfg, world)."""
    spec = SCAN_DRIVES[kind]
    world = make_world(num_frames=num_frames, n_landmarks=150, n_ground=50,
                       seed=3, **spec["world"])
    tracks = dense_tracks(world, SCAN_ROWS, with_depth=spec["with_depth"],
                          seed=4, with_labels=spec["labels"])
    chans = dict(stamps=tracks[0], uvd_seq=tracks[1], valid_seq=tracks[2],
                 labels=tracks[3] if spec["labels"] else None, priors=None)
    if spec["priors"]:
        # test_scan_odometry.py::test_mono_with_external_prior's priors
        rng = np.random.default_rng(9)
        priors = np.asarray(world.poses_veh).copy()
        priors[:, 4:] += rng.normal(0, 0.05, priors[:, 4:].shape)
        chans["priors"] = priors
    cfg = LimoConfig(capacity=CapacityConfig(
        max_keyframes=8, max_landmarks=SCAN_ROWS, max_cameras=1))
    f64 = lambda a: jnp.asarray([a], jnp.float64)
    rig = JaxRig(focal=f64(world.focal), principal=f64(world.principal),
                 T_cam_veh=f64(world.T_cam_veh))
    return chans, rig, cfg, world


def port_of(rig, cfg):
    """The port's (rig, cfg) on the CPU."""
    return (tstate.rig_from_numpy(rig, "cpu"),
            tstate.config_from_dict(dataclasses.asdict(cfg)))


def assert_frame_out(ref, port, cost_rtol, where=""):
    """One frame's (or a stacked drive's) FrameOut: discrete fields equal,
    continuous fields within SCAN_ATOL/SCAN_RTOL, cost within cost_rtol."""
    for f in SCAN_DISCRETE:
        np.testing.assert_array_equal(np.asarray(getattr(port, f)),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{where} FrameOut.{f}")
    for f in SCAN_CONTINUOUS:
        assert_close(getattr(port, f), getattr(ref, f), SCAN_RTOL, SCAN_ATOL,
                     f"{where} FrameOut.{f}")
    assert_close(port.cost, ref.cost, cost_rtol, 0.0, f"{where} FrameOut.cost")


def scan_step_by_step(kind):
    """Run the reference's jitted scan step frame by frame in f64 on drive
    ``kind``; before each frame hand the reference's state to the port and
    run one port step from it. Asserts each frame's FrameOut and the next
    state. Returns the reference's FrameOuts (numpy) and the port step."""
    chans, rig, cfg, _ = scan_drive(kind)
    trig, tcfg = port_of(rig, cfg)
    st = jso.init_state(cfg.capacity, jnp.float64, cfg.prior.default_speed)
    jstep = jax.jit(jso.make_scan_step(rig, cfg))
    tstep = tso.make_scan_step(trig, tcfg)
    args = (chans["stamps"], chans["uvd_seq"], chans["valid_seq"])
    kw = dict(labels=chans["labels"], priors=chans["priors"])
    xs = jso.frame_arrays(*args, cfg, jnp.float64, stamp_dtype=jnp.float64,
                          **kw)
    txs = tso.frame_arrays(*args, tcfg, torch.float64,
                           stamp_dtype=torch.float64, device="cpu", **kw)
    outs = []
    for i in range(len(chans["stamps"])):
        port_st = tstate.scan_state_from_numpy(jax.device_get(st), "cpu")
        st, out = jstep(st, tuple(x[i] for x in xs))
        port_st, port_out = tstep(port_st, tuple(x[i] for x in txs))
        out = jax.device_get(out)
        assert_frame_out(out, port_out, SCAN_COST_RTOL[kind],
                         f"{kind} frame {i}")
        assert_scan_state(jax.device_get(st),
                          tstate.scan_state_to_numpy(port_st),
                          f"{kind} frame {i} next state")
        outs.append(out)
    return outs, tstep


def assert_scan_state(ref, port, where=""):
    """A ScanState (window included): masks and integers equal, continuous
    fields within SCAN_ATOL/SCAN_RTOL."""
    pairs = list(zip(ref.window._fields, ref.window, port.window)) + \
        list(zip(ref._fields[1:], ref[1:], port[1:]))
    for name, a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(b, a, err_msg=f"{where} {name}")
        else:
            assert_close(b, a, SCAN_RTOL, SCAN_ATOL, f"{where} {name}")


# ---------------------------------------------------------------------------
# The fused pipeline: test_fused.py's rendered world, handed to both packages
# ---------------------------------------------------------------------------

def fused_world(n_frames):
    """test_fused.py's rendered world, its first ``n_frames`` frames: (world,
    stamps [F], images_u8 [F,H,W], clouds (list of [Ni,3] vehicle-frame
    scans), label_images [F,H,W], cfg, pcfg, rig) with the reference
    package's configs ``small_configs()`` and a float64 rig."""
    from test_fused import FOCAL, H_IMG, W_IMG, render_sequence, small_configs
    world = make_world(num_frames=n_frames, speed=6.0, yaw_rate=0.012,
                       n_landmarks=360, n_ground=110, n_shrubbery=40,
                       n_dynamic=25, dynamic_speed=6.0, seed=9, focal=FOCAL,
                       pp=(W_IMG / 2.0, H_IMG / 2.0), image_size=(W_IMG, H_IMG))
    imgs, clouds, labels = render_sequence(world, n_frames,
                                           np.random.default_rng(11))
    cfg, pcfg = small_configs()
    f64 = lambda a: jnp.asarray([a], jnp.float64)
    rig = JaxRig(focal=f64(world.focal), principal=f64(world.principal),
                 T_cam_veh=f64(world.T_cam_veh))
    return (world, world.stamps[:n_frames], imgs, clouds, labels, cfg, pcfg,
            rig)


def pipeline_config_of(pcfg):
    """The port's LimoPipelineConfig from the reference package's."""
    from limo_tpu_torch.frontend.lidar_depth import LidarDepthConfig
    from limo_tpu_torch.frontend.tracker import TrackerConfig
    from limo_tpu_torch.pipeline.full import LimoPipelineConfig
    kw = dataclasses.asdict(pcfg)
    return LimoPipelineConfig(
        limo=tstate.config_from_dict(kw.pop("limo")),
        tracker=TrackerConfig(**kw.pop("tracker")),
        lidar=LidarDepthConfig(**kw.pop("lidar")),
        **{k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()})


# ---------------------------------------------------------------------------
# Many sequences: three small drives for run_batch / run_fleet
# ---------------------------------------------------------------------------

BATCH_FRAMES, BATCH_ROWS = 30, 256
BATCH_SEEDS = (2, 3, 5)


def batch_drives():
    """Three 30-frame, 256-row drives with lidar depth (different worlds and
    track noise) at 12 keyframe slots; each attempts and accepts windowed
    solves. Returns (stamps [3,F], uvd [3,F,R,3], valid [3,F,R], the
    reference package's f64 rig, cfg)."""
    tracks = []
    for s in BATCH_SEEDS:
        world = make_world(num_frames=BATCH_FRAMES, speed=8.0, yaw_rate=0.015,
                           n_landmarks=180, n_ground=50, seed=s)
        tracks.append(dense_tracks(world, BATCH_ROWS, with_depth=True,
                                   seed=s + 5))
    cfg = LimoConfig(capacity=CapacityConfig(
        max_keyframes=12, max_landmarks=BATCH_ROWS, max_cameras=1))
    f64 = lambda a: jnp.asarray([a], jnp.float64)
    rig = JaxRig(focal=f64(world.focal), principal=f64(world.principal),
                 T_cam_veh=f64(world.T_cam_veh))
    stack = lambda i: np.stack([t[i] for t in tracks])
    return stack(0), stack(1), stack(2), rig, cfg


def element(tree, b):
    """Element ``b`` of a batched (nested) named tuple of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree[b]
    items = [element(x, b) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def trees_equal(a, b):
    """Two (nested) named tuples of tensors equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# The tuning grid: small drives and the grid comparison
# ---------------------------------------------------------------------------

TUNE_ROWS, TUNE_FRAMES = 256, 30
TUNE_POSE_ATOL = 1e-9
TUNE_COST_RTOL = 1e-7


def f64_rig(world):
    """A world's single-camera rig as the reference package's, in f64."""
    f64 = lambda a: jnp.asarray([a], jnp.float64)
    return JaxRig(focal=f64(world.focal), principal=f64(world.principal),
                  T_cam_veh=f64(world.T_cam_veh))


def tuning_drive():
    """tests/test_tuning_transforms.py::test_fused_grid_matches_serial's
    drive: ((stamps, uvd, valid), f64 rig, cfg) at 12 x 256."""
    cfg = LimoConfig(capacity=CapacityConfig(
        max_keyframes=12, max_landmarks=TUNE_ROWS, max_cameras=1))
    world = make_world(num_frames=TUNE_FRAMES, speed=8.0, yaw_rate=0.015,
                       n_landmarks=180, n_ground=50, seed=2)
    stamps, uvd, valid = dense_tracks(world, TUNE_ROWS, with_depth=True,
                                      seed=7)
    return (stamps, uvd, valid), f64_rig(world), cfg


def assert_grid_equal(port, ref):
    """A tuning grid's FrameOut [G,F,...]: decisions equal, poses within
    TUNE_POSE_ATOL, costs within TUNE_COST_RTOL (relative)."""
    for f in SCAN_DISCRETE:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(port.pose.numpy(), np.asarray(ref.pose),
                               rtol=0, atol=TUNE_POSE_ATOL)
    np.testing.assert_allclose(port.cost.numpy(), np.asarray(ref.cost),
                               rtol=TUNE_COST_RTOL, atol=0)
