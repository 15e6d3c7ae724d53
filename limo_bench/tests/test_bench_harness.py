"""The benchmark's frame on the CPU: the manifest and the files found by
name, each metric's arithmetic on a synthetic frame log and trace, the
result line, the import check and the reference's independence.

    python -m pytest limo_bench/tests -q
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from limo_bench import harness, peaks
from limo_bench import trace as tr

BENCH = Path(harness.BENCH)
ROOT = Path(harness.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_manifest_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["limo_bench"]
    assert 1 <= manifest["run_seconds"] <= 51
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    for group in groups:
        names = [e["name"] for e in manifest[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_files_found_by_name(manifest):
    cells = {c["name"]: c for c in manifest["workloads"]}
    for name, cell in cells.items():
        c, config, traffic, config_file = harness.cell_files(name, manifest)
        assert traffic["config"] == cell["config"]
        harness.driver(traffic["driver"])
        assert len(traffic["why"]) <= 200 and len(cell["why"]) <= 200
    for config in manifest["configs"]:
        path = ROOT / config["file"]
        assert path.is_file() and path.parts[len(ROOT.parts)] == "limo_bench"
        assert json.loads(path.read_text())["reduced"] == config["reduced"]
        assert any(c["config"] == config["name"] for c in cells.values())
    for name in cells:
        for trace in (False, True):
            metrics = harness.metrics_of(name, manifest, trace)
            assert metrics, (name, trace)
            for m in metrics:
                harness.reader(m["name"], trace)
        assert any(m["name"] == "setup_s"
                   for m in harness.metrics_of(name, manifest, False))
        assert len(harness.metrics_of(name, manifest, False)) >= 2


def test_every_cell_reports_what_its_metrics_move(manifest):
    for m in manifest["per_layer"]:
        for cell in m.get("workloads", [c["name"]
                                        for c in manifest["workloads"]]):
            moved = [e["name"] for e in
                     harness.metrics_of(cell, manifest, False)]
            assert m["moves"] in moved, (m["name"], cell)


def _record(trace=None):
    # two solve frames of 1000 and 3000 ms among eight frames of 10-80 ms
    ms = [10.0, 20.0, 1000.0, 30.0, 40.0, 3000.0, 50.0, 60.0, 70.0, 80.0]
    kinds = ["solve" if m >= 1000 else "track" for m in ms]
    return harness.Record(
        frame_ms=ms, frame_kind=kinds, window_s=sum(ms) / 1e3 + 0.64,
        setup_s=12.5, counters={"frames": 10, "host_syncs": 48, "solves": 2,
                                "lm_iterations": 40},
        solves=[{"K": 10, "L": 600, "C": 1, "iterations": 20, "rounds": 1},
                {"K": 12, "L": 700, "C": 1, "iterations": 20, "rounds": 1}],
        trace=trace)


def _trace():
    ms = 1_000_000
    spans = [("limo.assemble", 0, 10 * ms),
             ("limo.regularizers", 2 * ms, 5 * ms),
             ("limo.compute_cost", 20 * ms, 21 * ms),
             ("limo.pose_only", 30 * ms, 70 * ms)]
    return {"window_s": 10.0, "busy_s": 0.5, "device_ops": 1234,
            "ranges": {"limo.pose_only": {"count": 10, "host_ms": 400.0,
                                          "device_ms": 1.0},
                       "limo.assemble_obs": {"count": 40, "host_ms": 5.0,
                                             "device_ms": 0.5},
                       "limo.cost_obs": {"count": 84, "host_ms": 5.0,
                                         "device_ms": 0.42},
},
            "spans": spans, "breakdown": {"device_ops": [],
                                          "idle_gaps": []}}


def test_end_to_end_arithmetic():
    rec = _record()
    read = lambda n: harness.reader(n, False)(rec)
    assert read("frames_per_s") == pytest.approx(10 / 5.0)
    assert read("keyframe_ms") == pytest.approx(2000.0)
    assert read("setup_s") == 12.5
    rec.frame_kind = ["track"] * 10
    assert read("keyframe_ms") is None


def test_per_layer_arithmetic():
    rec = _record(_trace())
    read = lambda n: harness.reader(n, True)(rec)
    assert read("host_syncs_per_frame") == pytest.approx(4.8)
    assert read("pose_only_ms") == pytest.approx(40.0)
    assert read("track_ms_p50") == pytest.approx(45.0)
    assert read("lm_iterations_per_solve") == pytest.approx(20.0)
    # the outermost of the assembly ranges: 10 ms + 1 ms, over two solves
    assert read("assembly_ms_per_solve") == pytest.approx(5.5)
    assert read("device_idle_share") == pytest.approx(95.0)
    assert read("device_ops_per_frame") == pytest.approx(123.4)
    least = sum(20 * peaks.obs_bytes("assemble_obs", s["K"], s["L"], 1)
                for s in rec.solves) / peaks.HBM_BYTES_PER_S
    assert read("assemble_obs_roofline") == pytest.approx(
        100 * least / 0.5e-3)
    least = sum(22 * peaks.obs_bytes("cost_obs", s["K"], s["L"], 1)
                for s in rec.solves) / peaks.HBM_BYTES_PER_S
    assert read("cost_obs_roofline") == pytest.approx(100 * least / 0.42e-3)
    # a kernel whose launching call the trace lacks is read by its name
    unlinked = _trace()
    unlinked["ranges"]["limo.assemble_obs"]["device_ms"] = 0.0
    unlinked["unlinked_ms"] = {"assemble_obs_kernel(float const*)": 0.5}
    assert harness.reader("assemble_obs_roofline", True)(_record(
        unlinked)) == pytest.approx(100 * sum(
            20 * peaks.obs_bytes("assemble_obs", s["K"], s["L"], 1)
            for s in rec.solves) / peaks.HBM_BYTES_PER_S / 0.5e-3)
    # nothing to read: no trace, no solves
    empty = _record()
    empty.counters["solves"] = 0
    empty.solves = []
    for name in ("assemble_obs_roofline", "cost_obs_roofline",
                 "device_idle_share", "pose_only_ms",
                 "assembly_ms_per_solve", "lm_iterations_per_solve"):
        assert harness.reader(name, True)(empty) is None, name


def test_byte_counts_of_the_bench_window():
    assert peaks.obs_bytes("assemble_obs", 20, 1536, 1) == 2_928_928
    assert peaks.obs_bytes("cost_obs", 20, 1536, 1) == 640_000


def test_trace_helpers():
    import numpy as np
    merged = tr._merge(np.array([[0, 5], [3, 8], [10, 12], [11, 11]]))
    assert merged.tolist() == [[0, 8], [10, 12]]
    spans = [("a", 0, 100), ("b", 10, 20), ("c", 30, 40)]
    assert tr._innermost(spans, [5, 15, 25, 35, 150]) == [
        "a", "b", "a", "c", tr.OTHER]


def test_result_line_format(manifest):
    rec = _record(_trace())
    compared = [("pose_m", 1e-6, 1e-3), ("flips", 0.0, 0.0)]
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": 1, "memory_peak_bytes": 123}
    line = harness.result_line(rec, harness.metrics_of(
        "scan.drive", manifest, False), False, compared, device, None)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["attempted"] == 10
    assert line["metrics"]["frames_per_s"]["unit"] == "frames/s"
    json.loads(json.dumps(line))
    bad = harness.result_line(rec, [], False, [("pose_m", 2e-3, 1e-3)],
                              device, None)
    assert bad["correct"] is False
    nan = harness.result_line(rec, [], False, [("pose_m", float("nan"),
                                                1e-3)], device, None)
    assert nan["correct"] is False


def test_forbidden_modules_compared_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "limo_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert "limo_tpu" not in harness.forbidden_loaded()
    assert "jax" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "limo_tpu.solver", object())
    assert "limo_tpu" in harness.forbidden_loaded()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "limo_tpu"), (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("__future__", "dataclasses",
                                          "numpy"), (path, name)
    code = ("import sys; import limo_bench.reference.plain; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(ast.literal_eval(out.strip()))
    assert not tops & {"limo_tpu_torch", "limo_tpu", "jax", "jaxlib",
                       "torch"}


def test_every_cell_file_is_a_data_file():
    for path in (BENCH / "workloads").iterdir():
        assert path.suffix == ".json", path
    for path in (BENCH / "configs").iterdir():
        assert path.suffix == ".json", path


def test_start_flips_counts_initial_state_fields_that_differ():
    import torch
    from limo_tpu_torch.config import LimoConfig
    from limo_tpu_torch.pipeline import scan_odometry as so
    from limo_bench import follow
    st = so.init_state(LimoConfig().capacity, torch.float32, 13.0, "cpu")
    assert follow.start_flips(follow.to_np(st), 13.0) == 0
    moved = st._replace(speed=st.speed + 1, n_kf=st.n_kf + 1)
    assert follow.start_flips(follow.to_np(moved), 13.0) == 2


def test_spread_arithmetic():
    import statistics
    from limo_bench import spread
    a = [10.0, 11.0, 12.0, 13.0, 30.0, 11.5]
    q1, _, q3 = statistics.quantiles(a, n=4)
    assert spread.spread(a) == pytest.approx((q3 - q1) / 11.75)
    rest = [10.0, 11.0, 12.0, 13.0, 11.5]
    assert spread.without_farthest(a) == pytest.approx(spread.spread(rest))
    line = lambda v: {"metrics": {"m": {"value": v, "unit": "ms"}}}
    rows = spread.report([line(v) for v in a], [line(v) for v in rest])
    assert rows["m"]["median_change"] == pytest.approx(11.5 / 11.75 - 1)
    assert rows["m"]["trimmed_mean"] == pytest.approx(
        (spread.without_farthest(a) + spread.without_farthest(rest)) / 2)
