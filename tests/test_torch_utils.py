"""Parity of the port's host utilities with the reference package's:
``utils/transforms.py``, ``utils/viz.py``, ``utils/checkpoint.py`` (a
checkpoint written by either package loads in the other) and
``utils/profiling.py``'s ``device_trace``; and the port's span recorder
(``utils/profiling.py``: spans, self times, host reads), alone and over a
scan drive with solves.

They are numpy code on both sides, so every comparison is exact unless it
says otherwise."""

import contextlib
import json
import re
import time
from collections import defaultdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

@contextlib.contextmanager
def recording(capacity=1 << 20):
    rec = tprof.SpanRecorder(capacity)
    rec.start()
    try:
        yield rec
    finally:
        rec.stop()


@tprof.traced("limo.test_leaf")
def leaf():
    time.sleep(1e-4)


def frame_work(frame):
    """A frame's spans: top (frame id set) > two mids > leaves."""
    with tprof.span("limo.test_top", frame=frame):
        for _ in range(2):
            with tprof.span("limo.test_mid"):
                leaf()
                leaf()
                time.sleep(1e-4)


def test_span_nesting_and_self_times():
    with recording() as rec:
        frame_work(0)
    spans = rec.snapshot()
    assert [s.name for s in spans] == ["limo.test_top"] + [
        "limo.test_mid", "limo.test_leaf", "limo.test_leaf"] * 2
    own = tprof.self_ns(spans)
    top = spans[0]
    assert sum(own) == top.end_ns - top.start_ns
    for s, o in zip(spans, own):
        assert s.start_ns <= s.end_ns and 0 <= o <= s.end_ns - s.start_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    # a leaf has no children; a mid's self time is its own sleep
    assert own[2] == spans[2].end_ns - spans[2].start_ns
    assert own[1] >= 100_000


def test_span_parent_and_frame_ids():
    leaf()                                  # outside any frame, unrecorded
    with recording() as rec:
        leaf()
        frame_work(7)
        frame_work(8)
    spans = rec.snapshot()
    assert spans[0].name == "limo.test_leaf"
    assert (spans[0].parent, spans[0].frame) == (-1, -1)
    tops = [i for i, s in enumerate(spans) if s.name == "limo.test_top"]
    assert [spans[i].frame for i in tops] == [7, 8]
    for i, s in enumerate(spans[1:], 1):
        if s.name == "limo.test_mid":
            assert spans[s.parent].name == "limo.test_top"
        if s.name == "limo.test_leaf":
            assert spans[s.parent].name == "limo.test_mid"
        # each span's top ancestor holds the frame it inherits
        j = i
        while spans[j].parent >= 0:
            j = spans[j].parent
        assert j in tops and spans[j].frame == s.frame


def test_recorder_drops_past_capacity():
    with recording(capacity=4) as rec:
        frame_work(0)
        frame_work(1)
    spans = rec.snapshot()
    assert len(spans) == 4 and rec.dropped == 2 * 7 - 4
    assert [s.parent for s in spans] == [-1, 0, 1, 1]
    assert all(s.end_ns >= s.start_ns >= 0 for s in spans)
    assert "dropped 10 spans past 4" in rec.report()


def test_recorder_start_stop():
    rec, other = tprof.SpanRecorder(), tprof.SpanRecorder()
    with pytest.raises(RuntimeError):
        rec.stop()
    rec.start()
    try:
        with pytest.raises(RuntimeError):
            other.start()
        assert tprof.host_read(torch.ones((), dtype=torch.bool)) is True
    finally:
        rec.stop()
    assert tprof.host_read(torch.zeros((), dtype=torch.bool)) is False
    leaf()
    assert [s.name for s in rec.snapshot()] == ["limo.sync"]


def test_recorder_off_opens_no_profiler_range(monkeypatch):
    """With no recorder and no profiler, a span opens no profiler range
    and nothing is kept; under a profiler the limo.* ranges are in its
    trace, the recorder off."""
    from torch.profiler import ProfilerActivity, profile
    opened = []
    real = tprof._range

    def counting(name, *a):
        opened.append(name)
        return real(name, *a)

    monkeypatch.setattr(tprof, "_range", counting)
    frame_work(0)
    tprof.host_read(torch.ones((), dtype=torch.bool))
    assert opened == []
    assert tprof.span("limo.test_top") is tprof.span("limo.test_mid")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frame_work(0)
        tprof.host_read(torch.ones((), dtype=torch.bool))
    assert opened == ["limo.test_top"] + ["limo.test_mid", "limo.test_leaf",
                                          "limo.test_leaf"] * 2 + ["limo.sync"]
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    for name in ("limo.test_top", "limo.test_mid", "limo.test_leaf",
                 "limo.sync"):
        assert name in names


def test_span_times_on_the_profiler_clock():
    """A span recorded under the profiler starts and ends within 50 us of
    the profiler's own event for it (past the process's first ranges, which
    pay the profiler's own set-up: up to ~1 ms on this CPU)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frame_work(-1)
        t0 = time.time_ns()
        with recording() as rec:
            for i in range(3):
                frame_work(i)
    events = sorted(((e.name(), e.start_ns(), e.end_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("limo.test_")
                     and e.start_ns() > t0),
                    key=lambda e: e[1])
    spans = sorted(rec.snapshot(), key=lambda s: s.start_ns)
    assert [e[0] for e in events] == [s.name for s in spans]
    gaps = [max(abs(s.start_ns - e[1]), abs(s.end_ns - e[2]))
            for s, e in zip(spans, events)]
    assert max(gaps) < 50_000, gaps


def test_recorder_report():
    with recording() as rec:
        frame_work(0)
    lines = rec.report().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "limo.test_top", "limo.test_mid", "limo.test_leaf"]
    top, mid, lf = (re.match(
        r".*: n=(\d+), total ([\d.]+) ms, self ([\d.]+) ms, mean ([\d.]+) ms$",
        ln).groups() for ln in lines)
    assert (top[0], mid[0], lf[0]) == ("1", "2", "4")
    assert float(lf[1]) == float(lf[2]) >= 0.4
    assert float(mid[1]) == pytest.approx(2 * float(mid[3]), abs=2e-3)
    assert float(top[1]) == pytest.approx(
        float(top[2]) + float(mid[2]) + float(lf[2]), abs=2e-3)


def test_scan_drive_spans_and_host_reads():
    """The port's scan step over a CPU drive with two solves, recorded: one
    limo.sync span per counted host read (ScanStats.host_syncs), every span
    inside its frame's limo.scan_step, and each frame's self times summing
    to that span's duration."""
    import torch_parity as tp
    from limo_tpu_torch.pipeline import scan_odometry as tso
    F = 10
    chans, rig, cfg, _ = tp.scan_drive("depth", F)
    trig, tcfg = tp.port_of(rig, cfg)
    xs = tso.frame_arrays(chans["stamps"], chans["uvd_seq"],
                          chans["valid_seq"], tcfg, torch.float64,
                          stamp_dtype=torch.float64, device="cpu")
    st = tso.init_state(tcfg.capacity, torch.float64,
                        tcfg.prior.default_speed, "cpu")
    step = tso.make_scan_step(trig, tcfg)
    with recording() as rec:
        for i in range(F):
            st, _ = step(st, tuple(x[i] for x in xs))
    spans = rec.snapshot()
    names = {s.name for s in spans}
    assert len(step.stats.solves) >= 2 and rec.dropped == 0
    assert {"limo.solve_trimmed", "limo.trim", "limo.sync",
            "limo.selection"} <= names
    assert sum(s.name == "limo.sync" for s in spans) \
        == step.stats.host_syncs \
        == F + sum(i.n_host_syncs for i in step.stats.solves)
    assert sum(s.name == "limo.solve_trimmed" for s in spans) \
        == len(step.stats.solves)
    tops = {s.frame: s for s in spans if s.name == "limo.scan_step"}
    assert sorted(tops) == list(range(F))
    own = defaultdict(int)
    for s, o in zip(spans, tprof.self_ns(spans)):
        top = tops[s.frame]
        assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
        assert (s.parent == -1) == (s is top)
        own[s.frame] += o
    for f, top in tops.items():
        assert own[f] == top.end_ns - top.start_ns


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
