"""The port's long-horizon evaluators (``pipeline/evaluation.py``) and the
row-packed track tensors they run on (``synthetic.dense_tracks_packed``)
against the reference package's, on the CPU.

``dense_tracks_packed`` is numpy on both sides: equal exactly. The long
drive runs in float64, cut in length so that rows are reused, against the
reference's run of the same drive: every decision equal, poses within
1e-9, the reports within 1e-9. The full-length gates (240 frames, float32)
are marked slow, as the reference's own are."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu.pipeline import evaluation as jev
from limo_tpu.pipeline import synthetic as jsyn
from limo_tpu_torch.io import kitti as tkitti
from limo_tpu_torch.pipeline import evaluation as tev
from limo_tpu_torch.pipeline import scan_odometry as tso
from limo_tpu_torch.pipeline import synthetic as tsyn

GAP = 40
LONG_FRAMES, LONG_ROWS = 110, 768      # rows are first reused at ~101
REPORT_ATOL = 1e-9


def packed_world(mod):
    """tests/test_evaluation.py::TestPackedTracks' world."""
    return mod.make_world(num_frames=160, speed=10.0, yaw_rate=0.008,
                          n_landmarks=500, n_ground=150, seed=5)


@pytest.mark.parametrize("kw", [
    dict(with_depth=True, seed=9),
    dict(with_depth=True, seed=9, min_run=1),
    dict(with_depth=False, seed=4, with_labels=True, shrubbery_px_noise=1.5,
         depth_outlier_fraction=0.1),
])
def test_dense_tracks_packed_matches_reference(kw):
    got = tsyn.dense_tracks_packed(packed_world(tsyn), 448,
                                   reuse_gap_frames=GAP, **kw)
    want = jsyn.dense_tracks_packed(packed_world(jsyn), 448,
                                    reuse_gap_frames=GAP, **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    runs = got[4]
    assert got[3] == 0 and (np.bincount(runs[:, 3]) > 1).any()


def test_long_drive_reuses_rows():
    """The cut drive of the next test reuses rows: some row's track column
    holds two runs (two landmarks), the second after a gap."""
    cfg = tev._long_drive_config(LONG_ROWS)
    _, _, _, valid, _ = tev._long_drive_inputs(LONG_FRAMES, 10.0, LONG_ROWS,
                                               0, 4.0, 1.0, cfg)
    starts = (valid[1:] & ~valid[:-1]).sum(axis=0) + valid[0]
    assert valid.shape == (LONG_FRAMES, LONG_ROWS) and (starts > 1).any()


def recording(monkeypatch, module):
    """Record the (final state, FrameOut) of ``module.run_sequence``."""
    runs, inner = [], module.run_sequence

    def recorded(*args, **kw):
        runs.append(inner(*args, **kw))
        return runs[-1]

    monkeypatch.setattr(module, "run_sequence", recorded)
    return runs


def test_evaluate_long_drive_matches_reference(tmp_path, monkeypatch):
    """The port's evaluate_long_drive in float64 against the reference's on
    the same cut drive (12 x 768 rows, rows reused): every decision of
    its scan step equal, the pose files and reports within 1e-9."""
    from limo_tpu.pipeline import scan_odometry as jso
    from torch_parity import SCAN_DISCRETE

    port_runs, ref_runs = recording(monkeypatch, tso), recording(monkeypatch,
                                                                 jso)
    got = tev.evaluate_long_drive(num_frames=LONG_FRAMES, dtype=torch.float64,
                                  out_poses=str(tmp_path / "port.txt"),
                                  device="cpu")
    want = jev.evaluate_long_drive(num_frames=LONG_FRAMES, dtype=jnp.float64,
                                   out_poses=str(tmp_path / "ref.txt"))
    out, ref = port_runs[0][1], ref_runs[0][1]
    for f in SCAN_DISCRETE:
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert int(out.is_keyframe.sum()) > 12          # the ring turned over
    assert got.name == want.name and got.n_frames == want.n_frames
    np.testing.assert_allclose(tkitti.read_poses(str(tmp_path / "port.txt")),
                               tkitti.read_poses(str(tmp_path / "ref.txt")),
                               rtol=0, atol=REPORT_ATOL)
    np.testing.assert_allclose(got.ate, want.ate, rtol=0, atol=REPORT_ATOL)
    assert got.drift.keys() == want.drift.keys()
    for k in want.drift:
        np.testing.assert_allclose(got.drift[k], want.drift[k], rtol=0,
                                   atol=REPORT_ATOL, err_msg=k)


def test_render_streams_cached(tmp_path, monkeypatch):
    """A cache hit returns the miss's streams exactly; the files go where
    RENDER_CACHE_DIR points."""
    monkeypatch.setattr(tev, "RENDER_CACHE_DIR", str(tmp_path / "cache"))
    world, _ = tev.make_km_rendered_world(8, seed=3, n_dynamic=5)
    miss = tev._render_streams_cached(world, 8, 3, {"n_dynamic": 5}, None)
    files = list((tmp_path / "cache").glob("km_*.npz"))
    assert len(files) == 1
    hit = tev._render_streams_cached(world, 8, 3, {"n_dynamic": 5}, None)
    np.testing.assert_array_equal(hit[0], miss[0])
    np.testing.assert_array_equal(hit[1], miss[1])
    assert len(hit[2]) == len(miss[2]) == 8
    for a, b in zip(hit[2], miss[2]):
        np.testing.assert_array_equal(a, b.astype(np.float32))
    # another world (its own arrays in the key) misses
    other, _ = tev.make_km_rendered_world(8, seed=4, n_dynamic=5)
    tev._render_streams_cached(other, 8, 3, {"n_dynamic": 5}, None)
    assert len(list((tmp_path / "cache").glob("km_*.npz"))) == 2


def test_rendered_drive_config_matches_reference():
    """The flagship km-drive configuration, field by field."""
    from limo_tpu.config import LimoConfig
    from limo_tpu.frontend.lidar_depth import LidarDepthConfig
    from limo_tpu.frontend.tracker import TrackerConfig
    from limo_tpu.pipeline.full import LimoPipelineConfig
    got = dataclasses.asdict(tev.rendered_drive_config())
    limo = dataclasses.asdict(LimoConfig())
    limo["landmark_selection"]["height_over_ground"] = 1.65
    limo["prior"]["default_speed"] = 12.0
    want = dataclasses.asdict(LimoPipelineConfig(
        limo=LimoConfig(), tracker=TrackerConfig(
            max_features=384, border=8, nms_radius=5),
        lidar=LidarDepthConfig(), use_groundplane=True,
        cloud_capacity=16384))
    want["limo"] = limo
    assert got == want


# ---------------------------------------------------------------------------
# Slow: the reference's full-length gates through the port (float32, CPU)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_long_drive_drift_gate():
    """tests/test_evaluation.py::test_long_drive_drift through the port:
    240 m with row reuse, KITTI drift on 100/200 m segments under the
    reference's 0.93 %."""
    rep = tev.evaluate_long_drive(num_frames=240, speed=10.0,
                                  landmark_rows=768, seed=3, device="cpu")
    assert rep.drift["num_segments"] > 0
    assert rep.drift["t_err_percent"] < 0.93, rep.to_json()
    assert rep.ate < 1.0, rep.to_json()


@pytest.mark.slow
def test_long_drive_fleet_gate(tmp_path):
    """tests/test_evaluation.py::test_long_drive_fleet through the port: two
    240-frame drives as one fleet (two CPU devices)."""
    reports = tev.evaluate_long_drive_fleet(
        2, num_frames=240, speed=10.0, landmark_rows=768,
        devices=["cpu", "cpu"], out_dir=str(tmp_path))
    assert len(reports) == 2
    for rep in reports:
        assert rep.drift["num_segments"] > 0
        assert rep.drift["t_err_percent"] < 0.93, rep.to_json()
        assert rep.ate < 1.0, rep.to_json()
    est0 = tkitti.read_poses(str(tmp_path / "00.txt"))
    est1 = tkitti.read_poses(str(tmp_path / "01.txt"))
    assert not np.allclose(est0[:, :3, 3], est1[:, :3, 3], atol=1.0)


@pytest.mark.slow
def test_km_rendered_drive_gate():
    """tests/test_kitti_eval.py::TestKmRenderedDrive through the port's
    evaluate_rendered_long_drive (1000 rendered frames, the fused engine,
    float32). The thresholds are the reference's, measured before its
    lidar band came (ROADMAP 10.2)."""
    rep, out, still = tev.evaluate_rendered_long_drive(num_frames=1000,
                                                       chunk=64, device="cpu")
    assert rep.n_frames == 1000
    assert rep.drift["num_segments"] >= 100
    assert rep.drift["t_err_percent"] < 1.5, rep.drift
    assert rep.drift["r_err_deg_per_m"] < 0.008, rep.drift
    assert np.isfinite(rep.ate) and rep.ate < 3.5, rep.ate
    kf = out.is_keyframe.numpy()
    lo, hi = still
    assert kf[lo + 10:hi].sum() <= 2, kf[lo:hi]
    est = out.pose.numpy()
    assert np.linalg.norm(est[hi, 4:] - est[lo, 4:]) < 1.0
    assert int(out.n_tracks[10:].min()) > 40
    assert np.all(np.isfinite(est))
