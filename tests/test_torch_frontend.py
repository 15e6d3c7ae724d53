"""The port's sensor front end (limo_tpu_torch.frontend, utils/eig3,
pipeline/full.frontend_depth_plane, pipeline/fused._assign_slots) against
the reference package's, in float64 on the CPU.

Inputs are test_fused.py's rendered world (images, label images, lidar
clouds) and numpy draws from a seed, handed to both packages. Discrete
outputs must agree exactly: the features kept (and their pixels), matches,
the neighbours gathered, depth validity, the RANSAC hypotheses and inliers,
labels and slots. Continuous outputs agree to 1e-9 (relative): the two
packages sum in other orders, nothing more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu.frontend import groundplane as jgp
from limo_tpu.frontend import lidar_depth as jld
from limo_tpu.frontend import semantics as jsem
from limo_tpu.frontend import tracker as jtrk
from limo_tpu.geometry import pose_host as j_pose_host
from limo_tpu.pipeline import full as jfull
from limo_tpu.pipeline import fused as jfused
from limo_tpu.utils import eig3 as jeig
from limo_tpu.window_manager import DEFAULT_OUTLIER_LABELS
from limo_tpu_torch.frontend import groundplane as tgp
from limo_tpu_torch.frontend import lidar_depth as tld
from limo_tpu_torch.frontend import semantics as tsem
from limo_tpu_torch.frontend import tracker as ttrk
from limo_tpu_torch.pipeline import full as tfull
from limo_tpu_torch.pipeline import fused as tfused
from limo_tpu_torch.utils import eig3 as teig
from torch_parity import assert_close, fused_world

RTOL = 1e-9
T = lambda a: torch.as_tensor(np.array(a))
J = lambda a: jnp.asarray(np.asarray(a))


@pytest.fixture(scope="module")
def scene():
    """Two rendered frames of test_fused.py's world: gamma-corrected float64
    images, label images, vehicle- and camera-frame clouds padded to 16384
    points, the camera, and the reference's features of both frames."""
    world, _, imgs, clouds, labels, _, pcfg, _ = fused_world(2)
    img = (imgs.astype(np.float64) / 255.0) ** (1.0 / 1.2)
    cloud, valid = (a[0] for a in jfused.pad_clouds(clouds[:1], 16384,
                                                     np.float64))
    tcv = np.asarray(world.T_cam_veh, np.float64)
    cloud_cam = j_pose_host.apply(tcv, cloud)
    cam = dict(f=float(world.focal), pp=np.asarray(world.principal, np.float64),
               size=tuple(world.image_size))
    tcfg = jtrk.TrackerConfig(max_features=256, border=8)
    feats = [jax.device_get(jtrk.detect(J(im), tcfg)) for im in img]
    return dict(img=img, labels=labels, cloud=cloud, valid=valid,
                cloud_cam=cloud_cam, tcv=tcv, feats=feats, tcfg=tcfg,
                lcfg=pcfg.lidar, **cam)


# ---------------------------------------------------------------------------
# utils/eig3.py and lidar_depth.eigh3_sym
# ---------------------------------------------------------------------------

_OBLIQUE_N = np.array([[1.0, 2.0, 2.0], [2.0, -1.0, 2.0], [3.0, 4.0, 0.0],
                       [1.0, 1.0, 1.0]])


def _eig_cases(kind):
    rng = np.random.default_rng(3)
    if kind == "spd":
        M = rng.normal(size=(500, 3, 3))
        return M @ M.transpose(0, 2, 1)
    if kind == "planar":                        # ~1e7 eigenvalue spread
        D = rng.normal(size=(500, 400, 3)) * [30.0, 8.0, 0.01]
        return np.einsum("nki,nkj->nij", D, D) / 400.0
    if kind == "near_planar":
        D = rng.normal(size=(500, 6, 3))
        D[..., 2] *= 1e-3
        return np.einsum("nki,nkj->nij", D, D)
    if kind == "degenerate":
        return np.stack([np.eye(3), np.zeros((3, 3)), np.diag([2.0, 2.0, 5.0]),
                         np.diag([3.0, 1.0, 2.0])])
    # repeated smallest eigenvalue, oblique eigenspace
    A = 2.0 * np.eye(3)[None] + np.einsum("ni,nj->nij", _OBLIQUE_N,
                                          _OBLIQUE_N)
    return np.concatenate([A, 1e-12 * A])


@pytest.mark.parametrize("kind", ["spd", "planar", "degenerate"])
def test_jacobi_eigh3(kind):
    """Cyclic Jacobi: eigenvalues, eigenvectors and the smallest pair."""
    A = _eig_cases(kind)
    ev, V = jeig.jacobi_eigh3(J(A))
    tev, tV = teig.jacobi_eigh3(T(A))
    scale = np.abs(np.asarray(ev)).max()
    assert_close(tev, ev, RTOL, 1e-12 * scale, "evals")
    assert_close(tV, V, 0.0, 1e-9, "eigenvectors")
    _, v = jeig.smallest_eigvec3(J(A))
    _, tv = teig.smallest_eigvec3(T(A))
    assert_close(tv, v, 0.0, 1e-9, "smallest eigenvector")


@pytest.mark.parametrize("kind", ["spd", "near_planar", "degenerate",
                                  "repeated_oblique"])
def test_eigh3_sym(kind):
    """The closed-form solver, incl. its degenerate fallbacks."""
    A = _eig_cases(kind)
    ev, v = jax.jit(jld.eigh3_sym)(J(A))
    tev, tv = tld.eigh3_sym(T(A))
    scale = np.abs(np.asarray(ev)).max()
    assert_close(tev, ev, 1e-7, 1e-9 * scale, "evals")
    v, tv = np.asarray(v), tv.numpy()
    if kind == "repeated_oblique":
        # any unit vector of the repeated eigenvalue's plane is right, and
        # rounding picks one: both must lie in the plane (⟂ n)
        n_hat = _OBLIQUE_N / np.linalg.norm(_OBLIQUE_N, axis=-1,
                                            keepdims=True)
        for vec in (v, tv):
            assert np.abs(np.sum(vec * np.tile(n_hat, (2, 1)), -1)).max() \
                < 1e-6
            assert_close(np.linalg.norm(vec, axis=-1), 1.0, 0.0, 1e-9)
        return
    # a repeated smallest eigenvalue leaves the vector's sign to rounding
    sign = np.sign(np.sum(v * tv, -1, keepdims=True))
    assert_close(tv * sign, v, 0.0, 1e-6, "smallest eigenvector")


# ---------------------------------------------------------------------------
# frontend/tracker.py
# ---------------------------------------------------------------------------

DETECT_CASES = {
    "flagship": (True, dict(max_features=384, border=8, nms_radius=5)),
    "small": (True, dict(max_features=256, border=8)),
    "defaults_random": (False, {}),
    "no_buckets_no_subpixel": (True, dict(max_features=128, bucket_size=0,
                                          subpixel=False)),
    "bucket_cap_pads": (True, dict(max_features=256, bucket_cap=2)),
}


@pytest.mark.parametrize("case", list(DETECT_CASES))
def test_detect(scene, case):
    """The features kept, their pixels, responses and descriptors, on a
    rendered 512 × 192 frame (several configurations) and a random image;
    also a batch of two frames at once, frame for frame."""
    rendered, kw = DETECT_CASES[case]
    img = scene["img"][0] if rendered else \
        np.random.default_rng(5).uniform(0, 1, (192, 512))
    ref = jax.device_get(jtrk.detect(J(img), jtrk.TrackerConfig(**kw)))
    tcfg = ttrk.TrackerConfig(**kw)
    port = ttrk.detect(T(img), tcfg)
    np.testing.assert_array_equal(port.valid.numpy(), ref.valid, "valid")
    assert ref.valid.sum() > 40
    assert_close(port.uv, ref.uv, 0.0, 1e-9, "uv")
    assert port.uv.dtype == (torch.float32 if not kw.get("subpixel", True)
                             else torch.float64)
    assert_close(port.response, ref.response, RTOL, 0.0, "response")
    assert_close(port.desc, ref.desc, RTOL, 1e-12, "desc")
    if rendered:
        both = ttrk.detect(T(scene["img"]), tcfg)
        for name in ttrk.Features._fields:
            assert torch.equal(getattr(both, name)[0], getattr(port, name)), name


@pytest.mark.parametrize("guided", [False, True])
def test_match(scene, guided):
    """Matches of frame 1's features to frame 0's, unguided (zero-flow
    prior, global median gate) and guided (a shifted prediction, half of it
    informed; the local flow gate)."""
    cur, prev = scene["feats"][1], scene["feats"][0]
    tcfg = scene["tcfg"]
    kw, tkw = {}, {}
    if guided:
        rng = np.random.default_rng(2)
        pred = np.asarray(prev.uv) + rng.normal([-3.0, 1.0], 0.5,
                                                prev.uv.shape)
        known = rng.uniform(size=prev.uv.shape[0]) < 0.5
        kw = dict(pred_uv=J(pred), pred_known=J(known))
        tkw = dict(pred_uv=T(pred), pred_known=T(known))
    ref = jax.device_get(jtrk.match(cur, prev, tcfg, **kw))
    port = ttrk.match(ttrk.Features(*map(T, cur)), ttrk.Features(*map(T, prev)),
                      ttrk.TrackerConfig(max_features=256, border=8), **tkw)
    np.testing.assert_array_equal(port.prev_index.numpy(), ref.prev_index)
    assert int(port.n_matches) == int(ref.n_matches) > 30


# ---------------------------------------------------------------------------
# frontend/lidar_depth.py
# ---------------------------------------------------------------------------

DEPTH_MODES = {
    "triangle_rect": {},
    "pca": dict(patch_mode="pca"),
    "region_growing": dict(segmentation_mode="region_growing"),
    "radius": dict(neighbor_mode="radius", radius_px=10.0),
    "radius_pca_32": dict(neighbor_mode="radius", patch_mode="pca",
                          max_neighbors=32),
}


def _cam_args(scene, pkg):
    to = J if pkg == "ref" else T
    return (to(scene["f"]), to(scene["pp"]))


@pytest.mark.parametrize("mode", list(DEPTH_MODES))
def test_estimate_depths(scene, mode):
    """The neighbours gathered (exact), then depth validity (exact) and
    depth in every neighbour, segmentation and patch mode."""
    kw = DEPTH_MODES[mode]
    uv = scene["feats"][0].uv
    args = lambda to: (to(scene["cloud_cam"]), to(scene["valid"]), to(uv))
    jcfg, tcfg = jld.LidarDepthConfig(**kw), tld.LidarDepthConfig(**kw)
    gref = jax.device_get(jld.gather_neighbors(
        *args(J), *_cam_args(scene, "ref"), scene["size"], jcfg))
    gport = tld.gather_neighbors(*args(T), *_cam_args(scene, "port"),
                                 scene["size"], tcfg)
    np.testing.assert_array_equal(gport[2].numpy(), gref[2], "mask")
    np.testing.assert_array_equal(gport[0].numpy(), gref[0], "pts")
    assert_close(gport[1], gref[1], 1e-12, 0.0, "uvs")

    ref = jax.device_get(jld.estimate_depths(
        *args(J), *_cam_args(scene, "ref"), scene["size"], jcfg))
    port = tld.estimate_depths(*args(T), *_cam_args(scene, "port"),
                               scene["size"], tcfg)
    np.testing.assert_array_equal(port.valid.numpy(), ref.valid, "valid")
    np.testing.assert_array_equal(port.n_neighbors.numpy(), ref.n_neighbors)
    assert ref.valid.sum() > 20
    assert_close(port.depth, ref.depth, RTOL, 0.0, "depth")


def _plane_cam(scene):
    """The reference's RANSAC plane of frame 0, in the camera frame."""
    gp = jax.device_get(jgp.estimate_groundplane(J(scene["cloud"]),
                                                 J(scene["valid"])))
    R = j_pose_host.to_matrix(scene["tcv"])[:3, :3]
    n_cam = R @ np.asarray(gp.normal)
    d_cam = float(gp.distance) - n_cam @ scene["tcv"][4:]
    return gp, n_cam, d_cam


@pytest.mark.parametrize("which", ["ground_patch", "ground_feature"])
def test_ground_depths(scene, which):
    """Ground-patch depths over the RANSAC inliers (M-estimator local
    planes) and the global-plane intersection."""
    gp, n_cam, d_cam = _plane_cam(scene)
    uv = scene["feats"][0].uv
    if which == "ground_patch":
        ref = jld.ground_patch_depths(
            J(scene["cloud_cam"]), J(gp.inliers), J(uv), J(n_cam), J(d_cam),
            *_cam_args(scene, "ref"), scene["size"], jld.LidarDepthConfig())
        port = tld.ground_patch_depths(
            T(scene["cloud_cam"]), T(gp.inliers), T(uv), T(n_cam), T(d_cam),
            *_cam_args(scene, "port"), scene["size"], tld.LidarDepthConfig())
    else:
        ref = jld.ground_feature_depths(J(n_cam), J(d_cam), J(uv),
                                        *_cam_args(scene, "ref"))
        port = tld.ground_feature_depths(T(n_cam), T(d_cam), T(uv),
                                         *_cam_args(scene, "port"))
    ref = jax.device_get(ref)
    np.testing.assert_array_equal(port[1].numpy(), ref[1], "valid")
    assert ref[1].sum() > 20
    assert_close(port[0], ref[0], RTOL, 0.0, "depth")


# ---------------------------------------------------------------------------
# frontend/groundplane.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed, n_points", [(0, None), (3, None), (0, 40)])
def test_estimate_groundplane(scene, seed, n_points):
    """The hash draws and the hypotheses they sample (exact), then the
    plane (1e-9), its inliers and ``ok`` (exact); on 40 points the fit
    must fail its 50-inlier minimum in both packages."""
    cloud, valid = scene["cloud"], scene["valid"].copy()
    if n_points is not None:
        valid[n_points:] = False
    i = np.arange(600, dtype=np.uint32)[:, None] + np.uint32(seed * 31337)
    j = np.arange(3, dtype=np.uint32)[None, :]
    r_ref = np.asarray(jgp._hash2(J(i), J(j)))
    r_port = tgp._hash2(T(i.astype(np.int64)), T(j.astype(np.int64)))
    np.testing.assert_array_equal(r_port.numpy(), r_ref.astype(np.int64))

    ref = jax.device_get(jgp.estimate_groundplane(J(cloud), J(valid),
                                                  seed=seed))
    port = tgp.estimate_groundplane(T(cloud), T(valid), seed=seed)
    np.testing.assert_array_equal(port.inliers.numpy(), ref.inliers)
    assert bool(port.ok) == bool(ref.ok) == (n_points is None)
    assert_close(port.normal, ref.normal, RTOL, 1e-12, "normal")
    assert_close(port.distance, ref.distance, RTOL, 0.0, "distance")


# ---------------------------------------------------------------------------
# frontend/semantics.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["rendered", "random"])
def test_labels(scene, source):
    """The dilation of the outlier classes and the 3×3 majority sample at
    the features (a batch of two frames, frame for frame)."""
    if source == "rendered":
        li = scene["labels"].astype(np.int32)
    else:
        li = np.random.default_rng(4).integers(0, 34, (2, 192, 512),
                                               dtype=np.int32)
    tab = np.asarray(sorted(DEFAULT_OUTLIER_LABELS), np.int32)
    prio = np.isin(li, tab)
    uv = np.stack([f.uv for f in scene["feats"]])
    port_d = tsem.dilate_labels(T(li), T(prio))
    port_s = tsem.sample_labels(port_d, T(uv))
    for b in range(2):
        ref_d = np.asarray(jsem.dilate_labels(J(li[b]), J(prio[b])))
        np.testing.assert_array_equal(port_d[b].numpy(), ref_d)
        ref_s = np.asarray(jsem.sample_labels(J(ref_d), J(uv[b])))
        np.testing.assert_array_equal(port_s[b].numpy(), ref_s)
    assert (ref_d != li[-1]).any()


# ---------------------------------------------------------------------------
# pipeline/full.frontend_depth_plane and pipeline/fused._assign_slots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_gp", [True, False])
def test_frontend_depth_plane(scene, use_gp):
    """The whole lidar front end of a frame: depths, plane, plane_ok."""
    uv = scene["feats"][0].uv
    lcfg = scene["lcfg"]

    def run(mod, to, cfg):
        return mod.frontend_depth_plane(
            to(scene["cloud"]), to(scene["valid"]), to(scene["tcv"]), to(uv),
            to(scene["f"]), to(scene["pp"]), scene["size"], cfg, use_gp,
            (-3.5, -1.0))

    ref = jax.device_get(run(jfull, J, lcfg))
    port = run(tfull, T, tld.LidarDepthConfig(**vars(lcfg)))
    np.testing.assert_array_equal(port[0].numpy() > 0, ref[0] > 0)
    assert_close(port[0], ref[0], RTOL, 0.0, "depth")
    assert_close(port[1], ref[1], RTOL, 1e-12, "plane")
    assert bool(port[2]) == bool(ref[2]) == use_gp


def _slot_cases():
    rng = np.random.default_rng(6)
    N, L = 64, 96
    prev_slot = np.where(rng.uniform(size=N) < 0.7,
                         rng.permutation(L)[:N], -1).astype(np.int32)
    prev_index = np.where(rng.uniform(size=N) < 0.6, rng.permutation(N),
                          -1).astype(np.int32)
    return {
        "inherit_and_allocate": (np.array([2, 0, -1, 1], np.int32),
                                 np.array([5, -1, 7, 3], np.int32),
                                 np.array([True, True, True, False]),
                                 np.isin(np.arange(10), [3, 5, 7])),
        "capacity_exhaustion": (np.full(6, -1, np.int32),
                                np.full(6, -1, np.int32), np.ones(6, bool),
                                np.arange(4) == 0),
        "random": (prev_index, prev_slot, rng.uniform(size=N) < 0.9,
                   rng.uniform(size=L) < 0.5),
    }


@pytest.mark.parametrize("case", ["inherit_and_allocate",
                                  "capacity_exhaustion", "random"])
def test_assign_slots(case):
    """The track table's slot update equals the reference's, incl.
    test_fused.py's two cases and their properties."""
    args = _slot_cases()[case]
    ref = np.asarray(jax.jit(jfused._assign_slots)(*map(J, args)))
    port = tfused._assign_slots(*map(T, args)).numpy()
    np.testing.assert_array_equal(port, ref)
    assert port.dtype == np.int32
    got = port[port >= 0]
    assert len(set(got)) == len(got)                      # injective
    if case == "inherit_and_allocate":
        assert port[0] == 7 and port[1] == 5 and port[3] == -1
        assert port[2] not in (3, 5, 7) and port[2] >= 0
    if case == "capacity_exhaustion":
        assert len(got) == 3 and 0 not in got
