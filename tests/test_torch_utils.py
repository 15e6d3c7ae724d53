"""Parity of the port's host utilities with the reference package's:
``utils/transforms.py``, ``utils/viz.py``, ``utils/checkpoint.py`` (a
checkpoint written by either package loads in the other) and
``utils/profiling.py``'s ``StageTimer`` and ``device_trace``.

They are numpy code on both sides, so every comparison is exact unless it
says otherwise."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from limo_tpu.config import LimoConfig
from limo_tpu.utils import checkpoint as jckpt
from limo_tpu.utils import transforms as jtf
from limo_tpu.utils import viz as jviz
from limo_tpu.window_manager import BundleAdjuster
from limo_tpu_torch import state as tstate
from limo_tpu_torch.utils import checkpoint as tckpt
from limo_tpu_torch.utils import profiling as tprof
from limo_tpu_torch.utils import transforms as ttf
from limo_tpu_torch.utils import viz as tviz
from limo_tpu_torch.window_manager import BundleAdjuster as TBundleAdjuster

from test_utils import build_ba
from test_window_manager import RIG


def yaw_T(yaw=0.0, t=(0, 0, 0)):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = t
    return T


# ---------------------------------------------------------------------------
# TransformTree: tests/test_tuning_transforms.py's cases through both
# packages, each lookup equal bit for bit
# ---------------------------------------------------------------------------

def tree_cases(mod):
    """The same edges and lookups on one package's TransformTree; returns
    the looked-up transforms and the frames."""
    out = []
    tree = mod.TransformTree()
    tree.set_transform("a", "b", yaw_T(0.3, (1, 2, 0)))
    tree.set_transform("b", "c", yaw_T(-0.1, (0, 0, 3)))
    out += [tree.lookup("a", "c"), tree.lookup("c", "a"), tree.lookup("b", "b")]
    tree.set_transform("world", "vehicle", yaw_T(0.2, (5, 0, 0)))
    tree.set_transform("vehicle", "camera", yaw_T(0.0, (0.5, 0, 1.2)))
    out.append(tree.alias("vehicle", "camera", "estimate/vehicle",
                          "estimate/camera"))
    out.append(tree.lookup("estimate/vehicle", "estimate/camera"))
    tree.set_transform("c", "b", yaw_T(0.0, (0, 99, 0)))   # reverse wins
    out += [tree.lookup("b", "c"), tree.lookup("a", "c")]
    tree.set_transform("s", "a", np.diag([2.0, 2.0, 2.0, 1.0]))  # non-rigid
    out.append(tree.lookup("a", "s"))
    return out, tree.frames()


def test_transform_tree_matches_reference():
    port, port_frames = tree_cases(ttf)
    ref, ref_frames = tree_cases(jtf)
    assert port_frames == ref_frames
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)
    np.testing.assert_allclose(port[-1], np.diag([0.5, 0.5, 0.5, 1.0]),
                               atol=1e-12)


@pytest.mark.parametrize("target,source", [("a", "zz"), ("zz", "zz"),
                                           ("world", "estimate/camera")])
def test_transform_lookup_errors(target, source):
    trees = []
    for mod in (ttf, jtf):
        tree = mod.TransformTree()
        tree.set_transform("a", "b", np.eye(4))
        tree.set_transform("world", "vehicle", np.eye(4))
        tree.alias("world", "vehicle", "estimate/world", "estimate/camera")
        trees.append((mod, tree))
    for mod, tree in trees:
        with pytest.raises(mod.TransformLookupError):
            tree.lookup(target, source)
    with pytest.raises(ValueError, match="expected 4x4"):
        ttf.TransformTree().set_transform("a", "b", np.eye(3))


# ---------------------------------------------------------------------------
# viz: colors, the flow image and the exporters over the same adjuster
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def adjusters():
    """test_utils.build_ba()'s 3-keyframe adjuster (the reference's) and the
    port's holding the same host state."""
    ref = build_ba()
    return ref, tstate.bundle_adjuster_from_numpy(ref, "cpu")


@pytest.mark.parametrize("num_colors", [16, 10, 7])
def test_color_by_index_hsv(num_colors):
    ids = np.arange(-3, 40)
    c = tviz.color_by_index_hsv(ids, num_colors)
    np.testing.assert_array_equal(c, jviz.color_by_index_hsv(ids, num_colors))
    np.testing.assert_array_equal(c[ids == 0][0], [234, 22, 123])
    assert len({tuple(x) for x in c[(ids >= 1) & (ids <= num_colors)]}) \
        == num_colors


def test_flow_image(adjusters):
    ref, port = adjusters
    img = tviz.flow_image(port, shape=(600, 1300))
    np.testing.assert_array_equal(img, jviz.flow_image(ref, shape=(600, 1300)))
    n_meas = int(port._obs_mask[:, port._kf_order, 0].sum())
    lit = np.flatnonzero(img.any(-1))
    assert 0 < lit.size <= 5 * n_meas
    assert img.dtype == np.uint8 and img.shape == (600, 1300, 3)


def test_exporters_match_reference(adjusters, tmp_path):
    ref, port = adjusters
    for pkg, ba in (("port", port), ("ref", ref)):
        viz = tviz if pkg == "port" else jviz
        assert viz.export_landmarks(ba, str(tmp_path / f"{pkg}.ply")) > 0
        viz.export_paths(ba, str(tmp_path / f"{pkg}_paths.json"))
        viz.export_planes(ba, str(tmp_path / f"{pkg}_planes.json"))
    for name in (".ply", "_paths.json", "_planes.json"):
        assert (tmp_path / f"port{name}").read_text() \
            == (tmp_path / f"ref{name}").read_text()
    assert len(json.loads((tmp_path / "port_paths.json").read_text())
               ["active"]) == 3


def test_accumulate_map_matches_reference(tmp_path):
    rng = np.random.default_rng(42)
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[:, 0, 3] = np.arange(3) * 2.0
    clouds = [rng.uniform(-1, 1, (100, 3)) for _ in range(3)]
    n = tviz.accumulate_map(poses, clouds, np.eye(4),
                            str(tmp_path / "port.ply"), voxel=0.25)
    m = jviz.accumulate_map(poses, clouds, np.eye(4),
                            str(tmp_path / "ref.ply"), voxel=0.25)
    assert n == m > 100
    assert (tmp_path / "port.ply").read_text() \
        == (tmp_path / "ref.ply").read_text()


# ---------------------------------------------------------------------------
# checkpoint: written by either package, loaded by the other
# ---------------------------------------------------------------------------

def assert_mirrors_equal(a, b):
    for f in jckpt._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a._kf_order == b._kf_order and a._lm_slot == b._lm_slot
    assert a._archive.keys() == b._archive.keys()
    for k in a._archive:
        np.testing.assert_array_equal(a._archive[k], b._archive[k])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_loads_in_the_other_package(adjusters, tmp_path, writer):
    ref, port = adjusters
    path = str(tmp_path / "ckpt.npz")
    if writer == "reference":
        jckpt.save_adjuster(ref, path)
        loaded = TBundleAdjuster(port.rig, port.cfg, port.dtype, "cpu")
        tckpt.load_adjuster(loaded, path)
        assert_mirrors_equal(loaded, ref)
        # the resumed port adjuster solves
        loaded.deactivate_keyframes()
        info = loaded.solve()
        assert np.isfinite(float(info.final_cost))
    else:
        tckpt.save_adjuster(port, path)
        loaded = BundleAdjuster(RIG, LimoConfig(), jnp.float64)
        jckpt.load_adjuster(loaded, path)
        assert_mirrors_equal(loaded, port)


def test_dump_map_matches_reference(adjusters, tmp_path):
    ref, port = adjusters
    tckpt.dump_map(port, str(tmp_path / "port.json"))
    jckpt.dump_map(ref, str(tmp_path / "ref.json"))
    port_map = json.loads((tmp_path / "port.json").read_text())
    assert port_map == json.loads((tmp_path / "ref.json").read_text())
    assert len(port_map["keyframes"]) == 3 and port_map["landmarks"]


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_stage_timer():
    t = tprof.StageTimer()
    for name in ("a", "a", "b"):
        with t.stage(name):
            pass
    assert t.counts == {"a": 2, "b": 1}
    assert "a:" in t.report() and "n=2" in t.report()
    t.reset()
    assert not t.totals and not t.counts


def test_device_trace(tmp_path):
    import torch
    with tprof.device_trace(None) as prof:
        assert prof is None
    with tprof.device_trace(str(tmp_path / "trace")) as prof:
        with torch.profiler.record_function("limo.test_range"):
            torch.ones(8).sum()
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    assert "limo.test_range" in files[0].read_text()
