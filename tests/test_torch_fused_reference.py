"""The port's fused front end against the benchmark's plain reference of
its semantics (``limo_bench/reference/frontend.py``, NumPy float64), and
the spans and counters the fused path keeps.

A small rendered KITTI-geometry drive (``limo_bench/traffic/hdl64.py``: a
320 × 96 camera, an 8-beam × 256-column scan, 6 frames), built once per
module into a temporary cache, on the CPU in float64. Both sides run in
float64, so each stage is held to the reference exactly or within a few
float64 roundings (each tolerance says why); the per-cell cap does not bind
at this density, so the grid search and the brute-force search see the
same neighbours. No JAX here.

    python -m pytest tests/test_torch_fused_reference.py -q
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from limo_bench import harness
from limo_bench.drivers import scan as scan_drv
from limo_bench.reference import frontend as ref
from limo_bench.traffic import hdl64
from limo_tpu_torch.frontend import lidar_depth as tld
from limo_tpu_torch.frontend import tracker as trk
from limo_tpu_torch.frontend.groundplane import estimate_groundplane
from limo_tpu_torch.frontend.semantics import dilate_labels, sample_labels
from limo_tpu_torch.pipeline import fused as tfused
from limo_tpu_torch.pipeline.full import frontend_depth_plane
from limo_tpu_torch.utils import profiling

DT = torch.float64
CPU = torch.device("cpu")
W = 320
FRAMES = 6
# float64 roundings of the same arithmetic in another order
REL = 1e-9


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """The fused.kitti cell cut to a 320 × 96 camera, an 8 × 256 scan and
    6 frames: (config, arrays, world)."""
    manifest = harness.load_manifest()
    _, _, traffic, config = harness.cell_files("fused.kitti", manifest)
    config, t = copy.deepcopy(config), dict(traffic["traffic"])
    s = W / config["camera"]["image_size"][0]
    cam = config["camera"]
    cam.update(focal=cam["focal"] * s,
               principal=[p * s for p in cam["principal"]],
               image_size=[W, int(round(cam["image_size"][1] * s))])
    config["sensor"].update(beams=8, columns=256)
    # the 8 x 256 scan is ~4x sparser along each image axis than the full
    # one (64 x 2048 at 4x the focal length): the rectangle grows with it
    config["lidar"].update(search_width=24.0, search_height=36.0)
    t["frames"] = FRAMES
    arrays, world, _ = hdl64.load(t, config["camera"], config["sensor"],
                                  cache=tmp_path_factory.mktemp("hdl64"))
    return config, arrays, world


def _cam(config, world):
    return scan_drv.reference_camera(world)


def _rig(world):
    from limo_tpu_torch.geometry.camera import CameraRig
    return scan_drv.make_rig(CameraRig, world, DT, CPU)


def _tcfg(config):
    return trk.TrackerConfig(**config["tracker"])


def _lcfg(config):
    return tld.LidarDepthConfig(**config["lidar"])


def _frame(cell, i):
    """(image float64 after gamma, label image, cloud [P,3], valid [P])."""
    config, (_, images, labels, points, counts), _ = cell
    o = int(np.sum(counts[:i]))
    cloud = points[o:o + counts[i]].astype(np.float64)
    img = torch.as_tensor(ref.gamma(images[i], config["gamma"]))
    return img, labels[i], cloud, np.ones(len(cloud), bool)


def _features(cell, i):
    config = cell[0]
    img = _frame(cell, i)[0]
    return trk.detect(img, _tcfg(config))


def test_detect_matches_the_reference(cell):
    """Features, sub-pixel positions and descriptors of every frame: no
    flip, positions exact (both refine in float64 from the same response
    map), descriptors within float64 rounding."""
    config = cell[0]
    for i in range(FRAMES):
        img = _frame(cell, i)[0]
        port = trk.detect(img, _tcfg(config))
        want = ref.detect(img.numpy(), config["tracker"])
        assert int(port.valid.sum()) >= 20
        flips, uv_px, desc_err = ref.compare_features(
            want, port.uv.numpy(), port.valid.numpy(), port.desc.numpy())
        assert flips == 0 and uv_px == 0.0, (i, flips, uv_px)
        assert desc_err <= 1e-12, (i, desc_err)


def test_labels_match_the_reference(cell):
    """Dilated, sampled labels at the port's features: exact (integers)."""
    config = cell[0]
    out = set()
    for i in range(FRAMES):
        _, lab, _, _ = _frame(cell, i)
        f = _features(cell, i)
        li = torch.as_tensor(lab.astype(np.int32))
        table = torch.as_tensor(sorted(config["outlier_labels"]),
                                dtype=torch.int32)
        port = sample_labels(dilate_labels(li, torch.isin(li, table)), f.uv)
        want = ref.labels(lab, f.uv.numpy(), config["outlier_labels"],
                          config["label_dilation_half_kernel"])
        assert np.array_equal(port.numpy(), want), i
        out |= set(want[f.valid.numpy()].tolist())
    assert {7, 26} <= out or {7, 11} <= out, out


def test_match_matches_the_reference(cell):
    """Guided matching of consecutive frames at a prediction (the previous
    positions moved 3 px, half of them known): the same previous index
    for every feature."""
    config = cell[0]
    tc = _tcfg(config)
    g = torch.Generator().manual_seed(5)
    for i in range(1, FRAMES):
        cur, prev = _features(cell, i), _features(cell, i - 1)
        pred = prev.uv + torch.tensor([3.0, 0.5], dtype=DT)
        known = torch.rand(prev.valid.shape, generator=g) < 0.5
        port = trk.match(cur, prev, tc, pred_uv=pred, pred_known=known)
        want = ref.match(cur.uv, cur.desc, cur.valid, prev.uv, prev.desc,
                         prev.valid, pred, known, config["tracker"])
        assert np.array_equal(port.prev_index.numpy(), want), i
        assert int(port.n_matches) >= 5, i


def test_prediction_matches_the_reference(cell):
    """The guided prediction from a fused state: the previous features
    moved by the state's motion at their depths (or the anchor depth)."""
    config, _, world = cell
    from limo_tpu_torch import config as config_mod
    cfg = scan_drv.limo_config(config_mod, config)
    rig = _rig(world)
    from limo_tpu_torch.pipeline.full import LimoPipelineConfig
    pcfg = LimoPipelineConfig(limo=cfg, tracker=_tcfg(config),
                              lidar=_lcfg(config))
    st = tfused.init_fused_state(cfg, pcfg, DT, CPU)
    f = _features(cell, 0)
    depth = torch.where(torch.arange(len(f.uv)) % 3 == 0,
                        torch.full_like(f.uv[:, 0], -1.0),
                        5.0 + f.uv[:, 1] / 10)
    q = torch.tensor([0.99995, 0.0, 0.0, 0.01], dtype=DT)
    vel = torch.cat([q / torch.linalg.norm(q),
                     torch.tensor([-1.0, 0.02, 0.0], dtype=DT)])
    st = st._replace(prev_uv=f.uv, prev_depth=depth,
                     prev_matches=torch.tensor(40, dtype=torch.int32),
                     scan=st.scan._replace(vel=vel, n_kf=torch.tensor(
                         1, dtype=torch.int32)))
    pred, known = tfused.predict_uv(st, rig, _tcfg(config))
    want, wknown = ref.predict(f.uv.numpy(), depth.numpy(), vel.numpy(), 40,
                               1, _cam(config, world), config["tracker"])
    np.testing.assert_allclose(pred.numpy(), want, rtol=REL, atol=1e-9)
    assert np.array_equal(known.numpy(), wknown)


def test_depths_match_the_brute_force_search(cell):
    """Object depths through the port's grid search against the
    reference's search over every return: the same valid set, the same
    depths (float64 roundings of one intersection), and no return past the
    per-cell cap at this density."""
    config, _, world = cell
    cam = _cam(config, world)
    size = tuple(config["camera"]["image_size"])
    n_valid = 0
    for i in range(FRAMES):
        _, _, cloud, ok = _frame(cell, i)
        f = _features(cell, i)
        pc = ref.to_camera(cloud, cam.T_cam_veh)
        res = tld.estimate_depths(
            torch.as_tensor(pc), torch.as_tensor(ok), f.uv,
            torch.tensor(cam.focal, dtype=DT),
            torch.as_tensor(np.asarray(cam.principal)), size, _lcfg(config))
        assert int(res.overflow.sum()) == 0
        nb, _ = ref.neighbours(pc, ok, f.uv.numpy(), cam, size,
                               config["lidar"])
        want = np.array([ref.object_depth(pc[nb[a]], f.uv[a].numpy(), cam,
                                          config["lidar"])[0]
                         for a in range(len(f.uv))])
        port = res.depth.numpy()
        assert np.array_equal(port > 0, want > 0), i
        np.testing.assert_allclose(port, want, rtol=REL)
        n_valid += int(np.sum(want > 0))
    assert n_valid >= 5


def test_groundplane_matches_the_reference(cell):
    """The RANSAC plane, its refinement and inliers: the same hypotheses
    (the uint32 hash), the same inliers, the plane within float64
    roundings of two eigensolvers."""
    config = cell[0]
    g = config["ground_plane"]
    for i in range(FRAMES):
        _, _, cloud, ok = _frame(cell, i)
        port = estimate_groundplane(torch.as_tensor(cloud),
                                    torch.as_tensor(ok),
                                    z_band=tuple(g["z_band_m"]))
        n, d, inl, pok = ref.groundplane(cloud, ok, g)
        assert bool(port.ok) == pok and pok
        assert np.array_equal(port.inliers.numpy(), inl)
        np.testing.assert_allclose(port.normal.numpy(), n, atol=1e-9)
        assert abs(float(port.distance) - d) <= 1e-9
        assert abs(n[2]) > 0.999 and abs(d - 1.65) < 0.02


def test_depth_plane_matches_the_reference(cell):
    """The whole lidar front end of a frame (object depths, the plane and
    the ground patches for features without an object depth) against the
    reference's ``depths``."""
    config, _, world = cell
    cam = _cam(config, world)
    rig = _rig(world)
    size = tuple(config["camera"]["image_size"])
    n_ground = 0
    for i in range(FRAMES):
        _, _, cloud, ok = _frame(cell, i)
        f = _features(cell, i)
        d, plane, pok, over = frontend_depth_plane(
            torch.as_tensor(cloud), torch.as_tensor(ok), rig.T_cam_veh[0],
            f.uv, rig.focal[0], rig.principal[0], size, _lcfg(config), True,
            tuple(config["ground_plane"]["z_band_m"]))
        want, _, (n, dv, wok) = ref.depths(cloud, ok, f.uv.numpy(), cam,
                                          size, config["lidar"],
                                          config["ground_plane"])
        assert bool(pok) == wok and int(over) == 0
        np.testing.assert_allclose(plane.numpy(), np.r_[n, dv], atol=1e-9)
        port = d.numpy()
        assert np.array_equal(port > 0, want > 0), i
        # the ground patch's 3x3 eigensolver (cyclic Jacobi against LAPACK)
        np.testing.assert_allclose(port, want, rtol=1e-7)
        n_ground += int(np.sum((port > 0) & (f.uv[:, 1].numpy() > 60)))
    assert n_ground >= 5


def _runner(cell):
    config, arrays, world = cell
    from limo_tpu_torch import config as config_mod
    from limo_tpu_torch.pipeline.full import LimoPipelineConfig
    cfg = scan_drv.limo_config(config_mod, config)
    pcfg = LimoPipelineConfig(
        limo=cfg, tracker=_tcfg(config), lidar=_lcfg(config),
        gamma=config["gamma"], use_groundplane=True,
        gp_band=tuple(config["ground_plane"]["z_band_m"]),
        cloud_capacity=4096)
    rig = _rig(world)
    runner = tfused.make_fused_runner(
        rig, cfg, pcfg, tuple(config["camera"]["image_size"]), True,
        outlier_labels=frozenset(config["outlier_labels"]))
    return runner, cfg, pcfg


def _clouds(cell):
    _, (_, _, _, points, counts), _ = cell
    return np.split(points.astype(np.float64), np.cumsum(counts)[:-1])


def test_fused_runner_frame_matches_the_reference(cell, monkeypatch):
    """One whole ``make_fused_runner`` frame after the first, chunk 1: the
    step's features, labels, depths and plane are the reference's from the
    frame's image, label image and scan, and its matches the reference's
    from the first frame's features and the state."""
    config, (stamps, images, labels, _, _), world = cell
    runner, cfg, pcfg = _runner(cell)
    seen = {}
    match = trk.match

    def keep(*a, **k):
        seen["match"] = match(*a, **k)
        return seen["match"]
    monkeypatch.setattr(trk, "match", keep)
    st = tfused.init_fused_state(cfg, pcfg, DT, CPU)
    xs = list(tfused.chunks(stamps[:2], images[:2], _clouds(cell)[:2], pcfg,
                            labels[:2], 1, DT, CPU))
    st, _ = runner(st, xs[0][1])
    before = st
    frame = runner.front_end(xs[1][1], DT)
    st, out = runner(st, xs[1][1])
    _, uv, desc, valid, d, lab, plane, pok = (x[0] for x in frame)
    img, lab_img, cloud, ok = _frame(cell, 1)
    want = ref.detect(img.numpy(), config["tracker"])
    assert ref.compare_features(want, uv.numpy(), valid.numpy(),
                                desc.numpy())[:2] == (0.0, 0.0)
    assert np.array_equal(lab.numpy(), ref.labels(
        lab_img, uv.numpy(), config["outlier_labels"],
        config["label_dilation_half_kernel"]))
    cam = _cam(config, world)
    dr, _, (n, dv, wok) = ref.depths(cloud, ok, uv.numpy(), cam,
                                     tuple(config["camera"]["image_size"]),
                                     config["lidar"], config["ground_plane"])
    np.testing.assert_allclose(d.numpy(), dr, rtol=1e-7)
    assert bool(pok) == wok
    np.testing.assert_allclose(plane.numpy(), np.r_[n, dv], atol=1e-9)
    pred, known = ref.predict(before.prev_uv.numpy(),
                              before.prev_depth.numpy(),
                              before.scan.vel.numpy(),
                              int(before.prev_matches), int(before.scan.n_kf),
                              cam, config["tracker"])
    m = ref.match(uv, desc, valid, before.prev_uv, before.prev_desc,
                  before.prev_valid, pred, known, config["tracker"])
    assert np.array_equal(seen["match"].prev_index.numpy(), m)
    assert int(out.n_matches[0]) == int((m >= 0).sum()) >= 5


def test_front_stats_count_on_the_device(cell):
    """The runner's counters over a 3-frame drive: features detected, with
    a depth and plane frames as the front end's outputs sum them, read in
    one copy; no return dropped at this density."""
    config, (stamps, images, labels, _, _), _ = cell
    runner, cfg, pcfg = _runner(cell)
    st = tfused.init_fused_state(cfg, pcfg, DT, CPU)
    want = dict(detected=0, with_depth=0, plane_ok=0)
    for _, xs in tfused.chunks(stamps[:3], images[:3], _clouds(cell)[:3],
                               pcfg, labels[:3], 1, DT, CPU,
                               runner.front_stats):
        f = runner.front_end(xs, DT)
        want["detected"] += int(f[3].sum())
        want["with_depth"] += int((f[3] & (f[4] > 0)).sum())
        want["plane_ok"] += int(f[7].sum())
        st, _ = runner(st, xs)
    got = runner.front_stats.read()
    assert got["frames"] == 6 and got["cloud_overflow"] == 0
    assert got["cell_overflow"] == 0
    for k, v in want.items():       # front_end ran twice a frame
        assert got[k] == 2 * v, (k, got, want)


def test_pad_clouds_counts_the_overflow():
    """Returns past the capacity are dropped, and counted."""
    stats = tfused.FrontStats()
    clouds = [np.ones((130, 3)), np.ones((40, 3)), np.ones((100, 3))]
    buf, msk = tfused.pad_clouds(clouds, 100, np.float32, stats)
    assert stats.cloud_overflow == 30
    assert msk.sum(1).tolist() == [100, 40, 100]
    stats = tfused.FrontStats()
    list(tfused.chunks(np.arange(3.0), np.zeros((3, 4, 4), np.uint8), clouds,
                       dataclasses.replace(
                           _pcfg_default(), cloud_capacity=64),
                       chunk=3, device=CPU, stats=stats))
    assert stats.cloud_overflow == (130 - 64) + 0 + (100 - 64)


def _pcfg_default():
    from limo_tpu_torch.config import LimoConfig
    from limo_tpu_torch.pipeline.full import LimoPipelineConfig
    return LimoPipelineConfig(limo=LimoConfig(), tracker=trk.TrackerConfig(),
                              lidar=tld.LidarDepthConfig())


def test_cell_cap_overflow_is_counted():
    """A feature whose 8 px cell holds 40 returns: 16 are searched, 24
    reported dropped; a feature whose cells hold fewer reports none."""
    cfg = tld.LidarDepthConfig()
    g = torch.Generator().manual_seed(1)
    # 40 returns projecting into the cell [8, 16) x [8, 16) at 10 m
    uv = 8.0 + 8.0 * torch.rand((40, 2), generator=g, dtype=DT)
    f, pp = 100.0, torch.tensor([50.0, 50.0], dtype=DT)
    z = torch.full((40, 1), 10.0, dtype=DT)
    far = torch.tensor([[60.0, 60.0]], dtype=DT)
    pts = torch.cat([(torch.cat([uv, far]) - pp) / f
                     * torch.cat([z, z[:1]]), torch.cat([z, z[:1]])], 1)
    feats = torch.tensor([[12.0, 12.0], [60.0, 60.0]], dtype=DT)
    _, _, mask, over = tld.gather_neighbors(
        pts, torch.ones(41, dtype=torch.bool), feats,
        torch.tensor(f, dtype=DT), pp, (100, 100), cfg)
    assert over.tolist() == [24, 0]
    assert int(mask[0].sum()) <= cfg.points_per_cell


def test_scan_model_returns(cell):
    """The scan model: every return within range, the road's returns at the
    road within the range noise along their rays, and a count in the band
    the model predicts (each ray that meets the road within range returns,
    none returns more than once)."""
    config, (_, _, _, points, counts), world = cell
    sensor = config["sensor"]
    lo = hdl64.ground_rays(sensor, world.cam_height)
    hi = sensor["beams"] * sensor["columns"]
    assert all(lo <= n <= hi for n in counts), (lo, hi, counts)
    s = np.asarray(sensor["mount_veh_m"])
    p = points.astype(np.float64) - s
    r = np.linalg.norm(p, axis=1)
    assert r.max() <= sensor["max_range_m"] + 0.2
    road = np.abs(points[:, 2] + world.cam_height) < 0.15
    sin_el = -p[road, 2] / r[road]
    # the range error along the ray, from the height error
    err = (points[road, 2] + world.cam_height) / sin_el
    assert road.sum() >= 0.9 * lo * len(counts)
    assert abs(np.mean(err)) < 0.005 and 0.015 < np.std(err) < 0.025


def test_fused_spans_nest(cell):
    """The fused path's spans: ``limo.upload`` once per chunk, outside the
    step; ``limo.lidar_depth`` and ``limo.groundplane`` inside each
    ``limo.depth_plane``, whose self time and its children's sum to its
    duration; every span closed."""
    config, (stamps, images, labels, _, _), _ = cell
    runner, cfg, pcfg = _runner(cell)
    rec = profiling.SpanRecorder()
    rec.start()
    try:
        tfused.run_fused(stamps[:2], images[:2], _clouds(cell)[:2],
                         _rig(cell[2]),
                         cfg, pcfg, labels[:2], chunk=1, dtype=DT,
                         device=CPU, runner=runner)
    finally:
        rec.stop()
    spans = rec.snapshot()
    own = profiling.self_ns(spans)
    names = [s.name for s in spans]
    assert names.count("limo.upload") == 2
    assert all(s.parent == -1 for s in spans if s.name == "limo.upload")
    assert all(s.end_ns >= s.start_ns for s in spans)
    for k, s in enumerate(spans):
        if s.name != "limo.depth_plane":
            continue
        kids = [j for j, c in enumerate(spans) if c.parent == k]
        assert sorted(spans[j].name for j in kids) == [
            "limo.groundplane", "limo.lidar_depth"]
        sub = [j for j in range(len(spans)) if _under(spans, j, k)]
        assert own[k] + sum(own[j] for j in sub) == s.end_ns - s.start_ns
    assert names.count("limo.depth_plane") == 2
    assert names.count("limo.fused_step") == 2


def _under(spans, j, k):
    p = spans[j].parent
    while p >= 0:
        if p == k:
            return True
        p = spans[p].parent
    return False
