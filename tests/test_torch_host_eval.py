"""The port's KITTI-layout evaluation (limo_tpu_torch.pipeline.evaluation)
against the reference package's, on the CPU.

- ``evaluate_kitti_sequence(engine="host")`` on a 12-frame on-disk
  sequence (``entry.kitti_host_drive``: the reference's host-engine gate
  world, written by the port's codec and read by each package's own
  reader) in float64 throughout on both sides (the reference's image path
  is float32 whatever its caller's type, so it is given a float64 gamma
  and detect), the port given the 5-point prior's reference basis
  (tests/test_torch_essential.py): the same keyframes and solves on every
  frame, poses within 1e-4 (the 5-point prior's conditioning; measured
  7.6e-6) and ATE within 1e-5 relative (measured 7e-7); the port's
  default float32 run of the same sequence gives finite poses and the
  reference mini gate's ATE bound (3 m);
- ``engine="fused"``: the same sequence through ``run_fused``, bit for bit
  the fused pipeline's own run of the loaded arrays;
- ``evaluate_synthetic_sequence`` (16 frames, float64, a 1024-landmark
  capacity) against the reference's: equal ATE and drift within 1e-6
  relative; ``batch_evaluate_synthetic`` runs one report per seed;
- marked slow: the reference's 200-frame rendered drift gate
  (``tests/test_kitti_eval.py``'s asserts) through the port.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu.config import CapacityConfig, LandmarkSelectionConfig, LimoConfig
from limo_tpu.frontend import tracker as jtr
from limo_tpu.pipeline import evaluation as jev
from limo_tpu.pipeline import full as jfull
from limo_tpu_torch import entry
from limo_tpu_torch import state as tstate
from limo_tpu_torch.frontend import essential as te
from limo_tpu_torch.io import kitti as tkitti
from limo_tpu_torch.pipeline import evaluation as tev
from limo_tpu_torch.pipeline import full as tfull
from limo_tpu_torch.pipeline import fused as tfused
from test_torch_essential import reference_basis
from torch_parity import assert_close

N_FRAMES = 12


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti") / "00")
    gt, pcfg = entry.kitti_host_drive(N_FRAMES, root)
    return root, gt, pcfg


def reference_config(pcfg):
    """The reference package's LimoPipelineConfig equal to the port's."""
    from limo_tpu.config import LimoConfig as JLimoConfig
    from limo_tpu.frontend.lidar_depth import LidarDepthConfig
    from limo_tpu.frontend.tracker import TrackerConfig
    kw = dataclasses.asdict(pcfg)
    limo = kw.pop("limo")
    groups = {f.name: type(getattr(JLimoConfig(), f.name))(
        **{k: tuple(v) if isinstance(v, list) else v
           for k, v in limo[f.name].items()})
        for f in dataclasses.fields(JLimoConfig)}
    return jfull.LimoPipelineConfig(
        limo=JLimoConfig(**groups), tracker=TrackerConfig(**kw.pop("tracker")),
        lidar=LidarDepthConfig(**kw.pop("lidar")),
        **{k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()})


def recorded(monkeypatch, cls):
    """Each frame's FrameResult of ``cls.process``."""
    frames, inner = [], cls.process

    def process(self, *a, **k):
        r = inner(self, *a, **k)
        frames.append(r)
        return r
    monkeypatch.setattr(cls, "process", process)
    return frames


def test_host_engine_float64(sequence, tmp_path, monkeypatch):
    root, gt, pcfg = sequence
    monkeypatch.setattr(te, "_nullspace_basis", reference_basis)
    monkeypatch.setattr(jev, "LimoPipeline", functools.partial(
        jfull.LimoPipeline, dtype=jnp.float64))
    monkeypatch.setattr(jfull, "_gamma_u8_device", lambda img, gamma: (
        img.astype(jnp.float64) / 255.0) ** (1.0 / gamma))
    inner = jtr._detect_and_match
    monkeypatch.setattr(jtr, "_detect_and_match", lambda img, *a: inner(
        img.astype(jnp.float64), *a))
    monkeypatch.setattr(tev, "LimoPipeline", functools.partial(
        tfull.LimoPipeline, dtype=torch.float64))
    ref_frames = recorded(monkeypatch, jfull.LimoPipeline)
    port_frames = recorded(monkeypatch, tfull.LimoPipeline)
    ref = jev.evaluate_kitti_sequence(root, str(tmp_path / "ref.txt"), gt,
                                      cfg=reference_config(pcfg))
    port = tev.evaluate_kitti_sequence(root, str(tmp_path / "port.txt"), gt,
                                       cfg=pcfg, device="cpu")
    assert port.n_frames == ref.n_frames == N_FRAMES
    assert len(port_frames) == len(ref_frames) == N_FRAMES
    for i, (r, p) in enumerate(zip(ref_frames, port_frames)):
        assert (p.is_keyframe, p.solved) == (r.is_keyframe, r.solved), i
        assert_close(p.pose, r.pose, 0, 1e-4, f"frame {i}")
    assert sum(r.solved for r in ref_frames) >= 2
    np.testing.assert_allclose(port.ate, ref.ate, rtol=1e-5)
    np.testing.assert_allclose(tkitti.read_poses(str(tmp_path / "port.txt")),
                               tkitti.read_poses(str(tmp_path / "ref.txt")),
                               rtol=0, atol=1e-4)


def test_host_engine_float32(sequence, tmp_path):
    root, gt, pcfg = sequence
    rep = tev.evaluate_kitti_sequence(root, str(tmp_path / "p.txt"), gt,
                                      cfg=pcfg, device="cpu")
    est = tkitti.read_poses(str(tmp_path / "p.txt"))
    assert est.shape == (N_FRAMES, 4, 4) and np.all(np.isfinite(est))
    np.testing.assert_allclose(est[0], np.eye(4), atol=1e-9)
    assert np.isfinite(rep.ate) and rep.ate < 3.0, rep.ate
    assert rep.fps > 0 and '"ate_m"' in rep.to_json()


def test_fused_engine(sequence, tmp_path):
    root, gt, pcfg = sequence
    rep = tev.evaluate_kitti_sequence(root, str(tmp_path / "f.txt"), gt,
                                      cfg=pcfg, engine="fused", chunk=5,
                                      device="cpu")
    seq = tkitti.KittiSequence.open(root, gt)
    Tr = seq.calib.Tr_cam_velo
    imgs = np.stack([(seq.load_image(i) * 255.0).astype(np.uint8)
                     for i in range(N_FRAMES)])
    clouds = [(seq.load_velodyne(i)[:, :3] @ Tr[:3, :3].T) + Tr[:3, 3]
              for i in range(N_FRAMES)]
    labels = np.stack([seq.load_labels(i) for i in range(N_FRAMES)])
    from limo_tpu_torch.geometry.camera import CameraRig
    rig = CameraRig.single(seq.calib.focal, *seq.calib.principal,
                           device="cpu")
    _, out = tfused.run_fused(seq.times, imgs, clouds, rig, pcfg.limo, pcfg,
                              label_images=labels, chunk=5, device="cpu")
    direct = str(tmp_path / "direct.txt")
    tkitti.write_poses(direct, tfused.poses_kitti(out))
    np.testing.assert_array_equal(tkitti.read_poses(str(tmp_path / "f.txt")),
                                  tkitti.read_poses(direct))
    assert rep.n_frames == N_FRAMES and np.isfinite(rep.ate)
    with pytest.raises(ValueError):
        tev.evaluate_kitti_sequence(root, str(tmp_path / "x.txt"), gt,
                                    cfg=pcfg, engine="bogus", device="cpu")


def test_evaluate_synthetic_sequence(monkeypatch):
    monkeypatch.setattr(te, "_nullspace_basis", reference_basis)
    cfg = LimoConfig(
        capacity=CapacityConfig(max_keyframes=8, max_landmarks=1024),
        landmark_selection=dataclasses.replace(LandmarkSelectionConfig(),
                                               height_over_ground=1.65))
    ref = jev.evaluate_synthetic_sequence(16, seed=1, cfg=cfg,
                                          dtype=jnp.float64)
    port = tev.evaluate_synthetic_sequence(
        16, seed=1, cfg=tstate.config_from_dict(dataclasses.asdict(cfg)),
        dtype=torch.float64, device="cpu")
    assert port.name == ref.name and port.n_frames == 16
    np.testing.assert_allclose(port.ate, ref.ate, rtol=1e-6)
    for k in ("t_err_percent", "r_err_deg_per_m"):
        np.testing.assert_allclose(port.drift[k], ref.drift[k], rtol=1e-6)
    assert port.drift["num_segments"] == ref.drift["num_segments"]
    reps = tev.batch_evaluate_synthetic(2, num_frames=6, device="cpu",
                                        cfg=tstate.config_from_dict(
                                            dataclasses.asdict(cfg)))
    assert [r.name for r in reps] == ["synthetic-0", "synthetic-1"]


@pytest.mark.slow
def test_rendered_sequence_drift_gate(tmp_path):
    """The reference's 200-frame rendered drift gate
    (tests/test_kitti_eval.py::test_rendered_sequence_drift_gate), its
    asserts, through the port's host engine."""
    root = str(tmp_path / "01")
    gt, pcfg = entry.kitti_host_drive(200, root)
    out = str(tmp_path / "poses01.txt")
    rep = tev.evaluate_kitti_sequence(root, out, gt, cfg=pcfg,
                                      drift_kw=entry.KITTI_HOST_DRIFT_KW,
                                      device="cpu")
    assert rep.n_frames == 200
    assert rep.drift["num_segments"] >= 40
    assert rep.drift["t_err_percent"] < 2.0, rep.drift
    assert rep.drift["r_err_deg_per_m"] < 0.05, rep.drift
    assert np.isfinite(rep.ate) and rep.ate < 1.0, rep.ate
    est = tkitti.read_poses(out)
    assert est.shape[0] == 200 and np.all(np.isfinite(est))
    np.testing.assert_allclose(est[0], np.eye(4), atol=1e-9)
