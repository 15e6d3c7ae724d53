"""The port's selection stack, triangulation and numpy instruments against
the reference package's, on numpy inputs made from a seed.

Masks and categories must be bit-exact: the landmark schemes break ties by
index (stable sorts), hash rows with wrapping uint32 arithmetic, and round
the hashes to float — the window below has a voxel with several candidates,
rows whose hashed scores tie, and caps that bind. Continuous outputs
(triangulated points, flows, distances) are compared in float64 at 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu import selection as jsel
from limo_tpu import window_manager as jwm
from limo_tpu.config import LandmarkSelectionConfig, LimoConfig
from limo_tpu.geometry import camera as jcam
from limo_tpu.geometry import pose_host as j_pose_host
from limo_tpu.geometry import triangulation as jtri
from limo_tpu.pipeline import metrics as j_metrics
from limo_tpu.pipeline import synthetic as j_syn
from limo_tpu.selection import landmark as jlm
from limo_tpu.state import Window as JaxWindow
from limo_tpu_torch import selection as tsel
from limo_tpu_torch import state as tstate
from limo_tpu_torch import window_manager as twm
from limo_tpu_torch.geometry import camera as tcam
from limo_tpu_torch.geometry import pose_host as t_pose_host
from limo_tpu_torch.geometry import triangulation as ttri
from limo_tpu_torch.pipeline import metrics as t_metrics
from limo_tpu_torch.pipeline import synthetic as t_syn
from limo_tpu_torch.selection import landmark as tlm
from torch_parity import assert_close

K, L = 8, 256
ACTIVE = np.array([3, 4, 6, 7, 0, 1])   # ring-allocated slots, oldest first
VOXEL_ROWS = np.arange(10, 16)          # six landmarks inside one voxel
TIE_ROWS = np.arange(20, 30)            # rows whose hashed scores tie
SMALL_CAPS = LandmarkSelectionConfig(max_number_landmarks_near_bin=20,
                                     max_number_landmarks_middle_bin=15,
                                     max_number_landmarks_far_bin=10,
                                     min_number_landmarks_gp=6)
RIG_NP = dict(focal=np.array([600.0]), principal=np.array([[300.0, 200.0]]),
              T_cam_veh=np.array([[1.0, 0, 0, 0, 0, 0, 0]]))


def _window_np(seed=0):
    """A numpy window of 8 keyframe slots (6 active, ring order) × 256
    landmark slots: near structure, far landmarks beyond the far ROI, a few
    behind the cameras, lidar depth, groundplane landmarks and planes."""
    rng = np.random.default_rng(seed)
    stamps = np.zeros(K)
    stamps[ACTIVE] = np.arange(len(ACTIVE)) * 0.4
    kf_valid = np.zeros(K, bool)
    kf_valid[ACTIVE] = True
    poses = np.tile([1.0, 0, 0, 0, 0, 0, 0], (K, 1))
    for i, k in enumerate(ACTIVE):
        q = np.array([1.0, *rng.normal(0, 0.01, 3)])
        poses[k, :4] = q / np.linalg.norm(q)
        poses[k, 4:] = [rng.normal(0, 0.05), 0.0, -1.2 * i]
    n = rng.uniform(size=L)
    lms = np.where((n < 0.65)[:, None],
                   rng.uniform([-10, -3, 6], [10, 3, 35], (L, 3)),
                   np.where((n < 0.9)[:, None],
                            rng.uniform([-70, -3, 5], [70, 3, 80], (L, 3)),
                            rng.uniform([-5, -2, -25], [5, 2, -2], (L, 3))))
    # six landmarks around the centre of one voxel of the newest keyframe's
    # grid (voxel 0.5 × 0.5 × 0.3 m; centre of cell (2, 1, 40))
    in_voxel = np.array([1.25, 0.75, 12.15]) \
        + rng.uniform(-0.05, 0.05, (len(VOXEL_ROWS), 3))
    lms[VOXEL_ROWS] = j_pose_host.apply(
        j_pose_host.inverse(poses[ACTIVE[-1]]), in_voxel)
    obs = np.zeros((L, K, 1, 3))
    obs[..., 2] = -1.0
    mask = np.zeros((L, K, 1), bool)
    for k in ACTIVE:
        pc = j_pose_host.apply(poses[k], lms)
        z = np.where(np.abs(pc[:, 2]) < 1e-3, 1e-3, pc[:, 2])
        obs[:, k, 0, :2] = 600 * pc[:, :2] / z[:, None] + [300, 200] \
            + rng.normal(0, 0.5, (L, 2))
        obs[:, k, 0, 2] = np.where(rng.uniform(size=L) < 0.5,
                                   pc[:, 2] + rng.normal(0, 0.05, L), -1.0)
        mask[:, k, 0] = rng.uniform(size=L) < 0.8
    lm_id = np.arange(L, dtype=np.int32)
    lm_id[TIE_ROWS] = 100 - TIE_ROWS            # row + lm_id = 100 for all
    lm_id[200:] = -1
    planes = np.tile([0.0, 0.0, 1.0, 0.0], (K, 1))
    planes[:, :3] += rng.normal(0, 0.05, (K, 3))
    planes[:, :3] /= np.linalg.norm(planes[:, :3], axis=1, keepdims=True)
    planes[:, 3] = rng.normal(1.6, 0.1, K)
    lm_valid = rng.uniform(size=L) < 0.92
    lm_valid[VOXEL_ROWS] = True
    mask[VOXEL_ROWS] = True
    return JaxWindow(
        stamps=stamps, poses=poses, kf_valid=kf_valid,
        fix_pose=np.arange(K) == ACTIVE[0], fix_scale=np.arange(K) == ACTIVE[1],
        planes=planes, plane_valid=kf_valid & (rng.uniform(size=K) < 0.8),
        lm_pos=lms, lm_valid=lm_valid,
        lm_weight=rng.uniform(0.5, 1.0, L),
        lm_has_depth=rng.uniform(size=L) < 0.6,
        lm_is_gp=rng.uniform(size=L) < 0.3, lm_id=lm_id,
        obs=obs, obs_mask=mask)


def _both(dtype=np.float64, seed=0):
    """(reference Window, port Window, reference rig, port rig)."""
    w = _window_np(seed)
    w = w._replace(**{f: getattr(w, f).astype(dtype) for f in
                      ("stamps", "poses", "planes", "lm_pos", "lm_weight",
                       "obs")})
    rig = jcam.CameraRig(*[jnp.asarray(RIG_NP[f], dtype)
                           for f in jcam.CameraRig._fields])
    return (JaxWindow(*[jnp.asarray(x) for x in w]),
            tstate.window_from_numpy(w, "cpu"), rig,
            tstate.rig_from_numpy(rig, "cpu"))


def _cfg(caps):
    return LimoConfig(landmark_selection=caps)


def _port_cfg(cfg):
    return tstate.config_from_dict(dataclasses.asdict(cfg))


def _eq(port, ref, what=""):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref),
                                  err_msg=what)


NEWEST, PREV = int(ACTIVE[-1]), int(ACTIVE[-2])


# ---------------------------------------------------------------------------
# Hash, top-k
# ---------------------------------------------------------------------------

def test_hash_u32_bit_exact():
    """The wrapping uint32 hash, emulated in int64, over edge values and
    random int32 rows (negative ones wrap through uint32 as in the
    reference)."""
    rng = np.random.default_rng(1)
    x = np.concatenate([[0, 1, -1, 2 ** 31 - 1, -2 ** 31, 65535, 65536],
                        rng.integers(-2 ** 31, 2 ** 31, 4000)]).astype(np.int32)
    ref = np.asarray(jlm._hash_u32(jnp.asarray(x)), np.int64)
    port = tlm._hash_u32(torch.as_tensor(x)).numpy()
    _eq(port, ref)
    # and rounded to float as the schemes use them
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        _eq(tlm._hash_u32(torch.as_tensor(x)).to(td).numpy(),
            np.asarray(jlm._hash_u32(jnp.asarray(x)).astype(jd)))


@pytest.mark.parametrize("k", [1, 5, 17, 40, 300])
def test_masked_topk_ties_by_index(k):
    """Top-k among masked entries with many tied scores: both packages keep
    the same lowest-index members of the tie at the cut."""
    rng = np.random.default_rng(k)
    scores = rng.integers(0, 6, L).astype(np.float64)
    mask = rng.uniform(size=L) < 0.7
    ref = jlm._masked_topk_mask(jnp.asarray(scores), jnp.asarray(mask), k)
    port = tlm._masked_topk_mask(torch.as_tensor(scores),
                                 torch.as_tensor(mask), k)
    _eq(port, ref)
    assert int(port.sum()) == min(k, int(mask.sum()))


# ---------------------------------------------------------------------------
# The landmark schemes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rejection_schemes_and_helpers(dtype):
    jw, tw, jrig, trig = _both(dtype)
    keep = tsel.cheirality_mask(tw, trig)
    _eq(keep, jsel.cheirality_mask(jw, jrig), "cheirality")
    assert 0 < int(keep.sum()) < L
    box = ((-20.0, -5.0, 0.0), (20.0, 5.0, 60.0))
    _eq(tsel.dimension_plausibility_mask(tw, torch.tensor(NEWEST), *box),
        jsel.dimension_plausibility_mask(jw, jnp.asarray(NEWEST), *box),
        "dimension plausibility")
    _eq(tsel.track_lengths(tw), jsel.track_lengths(jw), "track lengths")
    t_flow = tsel.landmark_flow(tw, torch.tensor(NEWEST), torch.tensor(PREV))
    j_flow = jsel.landmark_flow(jw, jnp.asarray(NEWEST), jnp.asarray(PREV))
    assert_close(t_flow[0], j_flow[0], 1e-6 if dtype == np.float32 else 1e-12)
    _eq(t_flow[1], j_flow[1])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("caps", ["small", "default"])
def test_voxel_scheme_bit_exact(dtype, caps):
    """Masks and categories of the production scheme, with the caps
    binding (small) and not (default): the six rows of one voxel leave one
    representative, and the rows with tied hashed scores split at the
    middle bin's cap by index."""
    cfg = _cfg(SMALL_CAPS if caps == "small" else LandmarkSelectionConfig())
    jw, tw, jrig, trig = _both(dtype)
    cand = np.array(jsel.cheirality_mask(jw, jrig))
    ref = jsel.voxel_scheme(jw, jnp.asarray(NEWEST), jnp.asarray(cand), cfg,
                            last_kf=jnp.asarray(PREV))
    port = tsel.voxel_scheme(tw, torch.tensor(NEWEST), torch.as_tensor(cand),
                             _port_cfg(cfg), last_kf=torch.tensor(PREV))
    _eq(port.selected, ref.selected, "selected")
    _eq(port.category, ref.category, "category")
    cat = np.asarray(ref.category)
    assert set(np.unique(cat)) >= {tsel.CAT_NEAR, tsel.CAT_MIDDLE,
                                   tsel.CAT_FAR}
    # one representative of the shared voxel
    assert (cat[VOXEL_ROWS] != tsel.CAT_NONE).sum() == (caps == "default")
    if caps == "small":
        assert (cat == tsel.CAT_MIDDLE).sum() == 15
    # slot-adjacency fallback for the flow anchor
    _eq(tsel.voxel_scheme(tw, torch.tensor(NEWEST), torch.as_tensor(cand),
                          _port_cfg(cfg)).category,
        jsel.voxel_scheme(jw, jnp.asarray(NEWEST), jnp.asarray(cand),
                          cfg).category, "fallback anchor")


def test_tied_hash_rows_split_by_index():
    """The tie rows share one hashed score; restricted to them, the middle
    bin's cap keeps the lowest-index rows in both packages."""
    jw, tw, _, _ = _both()
    middle = np.zeros(L, bool)
    middle[TIE_ROWS] = True
    j_scores = jlm._hash_u32(jnp.arange(L) + jw.lm_id).astype(jnp.float64)
    t_scores = tlm._hash_scores(tw, tw.lm_id, torch.float64)
    _eq(t_scores, j_scores)
    assert len(np.unique(np.asarray(j_scores)[TIE_ROWS])) == 1
    ref = jlm._masked_topk_mask(j_scores, jnp.asarray(middle), 4)
    port = tlm._masked_topk_mask(t_scores, torch.as_tensor(middle), 4)
    _eq(port, ref)
    assert list(np.flatnonzero(np.asarray(port))) == list(TIE_ROWS[:4])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_observability_random_add_depth_schemes(dtype):
    cfg = _cfg(SMALL_CAPS)
    jw, tw, jrig, trig = _both(dtype)
    cand = np.array(jsel.cheirality_mask(jw, jrig))
    ref = jsel.observability_scheme(jw, jnp.asarray(NEWEST), jnp.asarray(cand),
                                    cfg, last_kf=jnp.asarray(PREV))
    port = tsel.observability_scheme(tw, torch.tensor(NEWEST),
                                     torch.as_tensor(cand), _port_cfg(cfg),
                                     last_kf=torch.tensor(PREV))
    _eq(port.selected, ref.selected, "observability selected")
    _eq(port.category, ref.category, "observability category")
    for seed in (0, 7, 2 ** 20):
        _eq(tsel.random_scheme(tw, torch.as_tensor(cand), 40, seed=seed),
            jsel.random_scheme(jw, jnp.asarray(cand), 40, seed=seed),
            f"random seed {seed}")
    sel0 = np.array(ref.selected)
    comp = np.asarray(jw.lm_is_gp) & cand
    added = tsel.add_depth_scheme(tw, torch.as_tensor(sel0),
                                  torch.as_tensor(comp), 6)
    _eq(added, jsel.add_depth_scheme(jw, jnp.asarray(sel0), jnp.asarray(comp),
                                     6), "add depth")
    assert int(added.sum()) > int(sel0.sum())


def test_selection_for_solve_every_field():
    """The solve-time selector stack and its wiring, field by field, on the
    ring-ordered window with label outliers."""
    cfg = _cfg(SMALL_CAPS)
    jw, tw, jrig, trig = _both()
    rng = np.random.default_rng(3)
    outlier = rng.uniform(size=L) < 0.05
    k0, k1 = int(ACTIVE[0]), int(ACTIVE[1])
    ref, ref_cat = jax.jit(
        lambda w, o: jwm.selection_for_solve(w, jnp.int32(NEWEST),
                                             jnp.int32(k0), jnp.int32(k1),
                                             o, jrig, cfg))(
        jw, jnp.asarray(outlier))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    port, port_cat = twm.selection_for_solve(tw, i32(NEWEST), i32(k0), i32(k1),
                                             torch.as_tensor(outlier), trig,
                                             _port_cfg(cfg))
    _eq(port_cat, ref_cat, "categories")
    for f in ("lm_selected", "gp_kf", "scale_kf0", "scale_kf1",
              "plane_dist_fixed"):
        _eq(getattr(port, f), getattr(ref, f), f)
    for f in ("gp_weight", "scale_target", "scale_weight"):
        assert_close(getattr(port, f), getattr(ref, f), 1e-12, 1e-12, f)
    assert float(port.gp_weight.max()) > 0


# ---------------------------------------------------------------------------
# Keyframes, triangulation, viewing rays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flow,angle,dt,n_matches", [
    (0.5, 0.0, 0.1, 30),      # standstill: rejected
    (8.0, 0.0, 0.5, 30),      # time since the last keyframe
    (8.0, 0.05, 0.1, 30),     # curve: pose difference
    (8.0, 0.0, 0.1, 30),      # nothing fires
    (0.5, 0.05, 0.5, 0),      # no matches: flow cannot reject
])
def test_select_keyframe(flow, angle, dt, n_matches):
    cfg = LimoConfig()
    rng = np.random.default_rng(4)
    uv_last = rng.uniform(0, 600, (40, 2))
    step = rng.normal(size=(40, 2))
    uv_new = uv_last + flow * step / np.linalg.norm(step, axis=1,
                                                    keepdims=True)
    mask = np.arange(40) < n_matches
    q_last = np.array([1.0, 0.0, 0.0, 0.0])
    q_new = np.array([np.cos(angle / 2), 0.0, 0.0, np.sin(angle / 2)])
    args = (uv_new, uv_last, mask, q_new, q_last, 10.0 + dt, 10.0)
    ref = jsel.select_keyframe(*[jnp.asarray(a) for a in args], cfg)
    port = tsel.select_keyframe(*[torch.as_tensor(a) for a in args],
                                _port_cfg(cfg))
    for f in ref._fields:
        _eq(getattr(port, f), getattr(ref, f), f)
    assert_close(tsel.mean_flow(*[torch.as_tensor(a) for a in args[:3]])[0],
                 jsel.mean_flow(*[jnp.asarray(a) for a in args[:3]])[0],
                 1e-14)


def _rays_to(points, centers):
    d = points - centers
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_triangulate_batch_with_rank_deficient_rows():
    """Rows with one ray, with parallel rays, with none, and well-posed
    rows: the same points and the same ``ok`` flags; the guarded solve
    keeps the deficient rows finite."""
    rng = np.random.default_rng(5)
    Lr, N = 64, 6
    pts = rng.uniform(-10, 10, (Lr, 3)) + [0, 0, 30]
    centers = rng.uniform(-2, 2, (Lr, N, 3))
    rays = _rays_to(pts[:, None], centers) + rng.normal(0, 1e-3, (Lr, N, 3))
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    mask = rng.uniform(size=(Lr, N)) < 0.7
    mask[0] = [True] + [False] * (N - 1)        # one ray
    mask[1] = False                             # none
    mask[2] = True                              # parallel rays
    rays[2] = rays[2, 0]
    mask[3] = [True, True] + [False] * (N - 2)  # two rays, nearly parallel
    rays[3, 1] = rays[3, 0] + 1e-6
    rays[3, 1] /= np.linalg.norm(rays[3, 1])
    ref = jtri.triangulate_batch(jnp.asarray(rays), jnp.asarray(centers),
                                 jnp.asarray(mask))
    port = ttri.triangulate_batch(torch.as_tensor(rays),
                                  torch.as_tensor(centers),
                                  torch.as_tensor(mask))
    _eq(port[1], ref[1], "ok")
    assert not np.asarray(port[1])[:4].any() and np.asarray(port[1]).sum() > 40
    assert_close(port[0], ref[0], 1e-9, 1e-9)
    assert torch.isfinite(port[0]).all()
    one = ttri.triangulate_rays(torch.as_tensor(rays[10]),
                                torch.as_tensor(centers[10]),
                                torch.as_tensor(mask[10]))
    one_ref = jtri.triangulate_rays(jnp.asarray(rays[10]),
                                    jnp.asarray(centers[10]),
                                    jnp.asarray(mask[10]))
    assert_close(one[0], one_ref[0], 1e-9, 1e-9)
    _eq(one[1], one_ref[1])


def test_viewing_ray():
    rng = np.random.default_rng(6)
    uv = rng.uniform(0, 1200, (50, 7, 2))
    f = np.full((50, 7), 718.0)
    pp = np.array([607.0, 185.0])
    ref = jcam.viewing_ray(jnp.asarray(uv), jnp.asarray(f), jnp.asarray(pp))
    port = tcam.viewing_ray(torch.as_tensor(uv), torch.as_tensor(f),
                            torch.as_tensor(pp))
    assert_close(port, ref, 1e-15, 1e-15)


# ---------------------------------------------------------------------------
# Numpy instruments copied into the port
# ---------------------------------------------------------------------------

WORLDS = [
    dict(num_frames=30, seed=3),
    dict(num_frames=24, n_landmarks=150, n_ground=50, seed=3, n_shrubbery=20,
         n_dynamic=15),
    dict(num_frames=20, seed=5, speed_profile=np.r_[np.zeros(5),
                                                    np.full(15, 12.0)],
         yaw_rate_profile=np.linspace(-0.05, 0.05, 20)),
]
TRACKS = [
    dict(with_depth=True, seed=4),
    dict(with_depth=False, seed=4, with_labels=True),
    dict(with_depth=True, seed=7, depth_outlier_fraction=0.1,
         depth_dropout=(3, 9), shrubbery_px_noise=1.5, with_labels=True),
]


@pytest.mark.parametrize("world_kw", range(len(WORLDS)))
def test_synthetic_drive_bit_identical(world_kw):
    """The same seed gives the same world and track tensors, bit for bit."""
    kw = WORLDS[world_kw]
    jw, tw = j_syn.make_world(**kw), t_syn.make_world(**kw)
    for f in dataclasses.fields(jw):
        a, b = getattr(jw, f.name), getattr(tw, f.name)
        if isinstance(a, np.ndarray):
            _eq(b, a, f.name)
        else:
            assert a == b, f.name
    _eq(tw.kitti_gt(), jw.kitti_gt(), "kitti_gt")
    rows = tw.landmarks.shape[0] + 3
    for tk in TRACKS:
        for a, b in zip(j_syn.dense_tracks(jw, rows, **tk),
                        t_syn.dense_tracks(tw, rows, **tk)):
            assert a.dtype == b.dtype
            _eq(b, a, str(tk))


def test_pose_host_and_metrics_bit_identical():
    rng = np.random.default_rng(8)
    q = rng.normal(size=(20, 4))
    p = np.concatenate([q / np.linalg.norm(q, axis=1, keepdims=True),
                        rng.normal(size=(20, 3))], 1)
    x = rng.normal(size=(20, 3))
    for name, args in [("inverse", (p,)), ("compose", (p, p[::-1])),
                       ("relative", (p, p[::-1])), ("apply", (p, x)),
                       ("to_matrix", (p,)), ("qangle", (p[:, :4], q)),
                       ("from_matrix", (j_pose_host.to_matrix(p),))]:
        _eq(getattr(t_pose_host, name)(*args),
            getattr(j_pose_host, name)(*args), name)
    world = j_syn.make_world(num_frames=120, seed=2)
    gt = world.kitti_gt()
    est = gt.copy()
    est[:, :3, 3] += np.cumsum(rng.normal(0, 0.02, (120, 3)), axis=0)
    assert t_metrics.ate_rmse(gt, est) == j_metrics.ate_rmse(gt, est)
    assert t_metrics.kitti_drift(gt, est, lengths=(50.0, 100.0)) \
        == j_metrics.kitti_drift(gt, est, lengths=(50.0, 100.0))
