"""The port's multi-process helpers (``limo_tpu_torch.parallel.multihost``)
against the reference package's: the one-process no-op, the batch
arithmetic, and two ``gloo`` processes on the CPU running the reference's
``tests/mh_worker.py`` scenario and a sequence fleet through the global
machinery. Started once for the module (``parallel.spawn``)."""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from limo_tpu import parallel as jparallel
from limo_tpu_torch.config import CapacityConfig, LimoConfig
from limo_tpu_torch.geometry.camera import CameraRig
from limo_tpu_torch.parallel import (global_mesh, host_local_to_global,
                                     initialize, pad_rows,
                                     process_local_batch, spawn)
from limo_tpu_torch.pipeline import scan_odometry as so
from limo_tpu_torch.pipeline.synthetic import dense_tracks, make_world
from torch_dist_worker import diverge, mh_scenario
import torch_parity  # noqa: F401  (one torch thread, as in the ranks)

SEEDS = (6, 7, 8)          # three sequences over two processes: one padded


@pytest.fixture(scope="module")
def fleet_inputs():
    world = make_world(num_frames=15, n_landmarks=150, n_ground=50, seed=5)
    cfg = LimoConfig(capacity=CapacityConfig(
        max_keyframes=8, max_landmarks=256, max_cameras=1))
    f64 = lambda a: torch.as_tensor(np.asarray(a)[None], dtype=torch.float64)
    rig = CameraRig(focal=f64(world.focal), principal=f64(world.principal),
                    T_cam_veh=f64(world.T_cam_veh))
    seqs = [dense_tracks(world, 256, with_depth=True, seed=s) for s in SEEDS]
    return rig, cfg, seqs


@pytest.fixture(scope="module")
def ranks(fleet_inputs):
    rig, cfg, seqs = fleet_inputs
    return spawn(mh_scenario, 2, "gloo", args=(rig, cfg, seqs),
                 timeout_s=600)


def test_initialize_noop_single_process(monkeypatch):
    for key in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert initialize("gloo") is False
    assert jparallel.initialize() is False


def test_helpers_without_process_group(monkeypatch):
    """One process and no launcher: global_mesh is one rank's layout, the
    process loads the whole batch, and host_local_to_global is a put on
    the device, as the reference's is with one process."""
    for key in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert initialize("gloo") is False and not dist.is_initialized()
    mesh = global_mesh(devices="cpu")
    assert (mesh.size(0), mesh.size(1)) == (1, 1)
    assert mesh.get_group("data") is None
    with pytest.raises(ValueError, match="1 ranks"):
        global_mesh(data=2, model=1, devices="cpu")
    assert process_local_batch(3, mesh) == (0, 3, 3)
    rows = np.arange(6.0).reshape(3, 2)
    got = host_local_to_global({"x": rows, "t": (torch.ones(3, 4),)}, mesh)
    assert isinstance(got["x"], torch.Tensor)
    assert got["x"].device.type == "cpu"
    np.testing.assert_array_equal(got["x"].numpy(), rows)
    assert torch.equal(got["t"][0], torch.ones(3, 4))


def test_initialize_backend_checks(tmp_path, monkeypatch):
    """NCCL is refused for more ranks than cards on the host, before it is
    asked; a second initialisation is tolerated with the same backend
    only."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(torch.cuda.device_count() + 1))
    with pytest.raises(RuntimeError, match="one rank per card"):
        initialize("nccl", f"file://{tmp_path}/nccl", 2, 0)
    assert not dist.is_initialized()
    assert initialize("gloo", f"file://{tmp_path}/gloo", 1, 0) is True
    try:
        assert initialize("gloo") is False          # already up, one rank
        with pytest.raises(RuntimeError, match="already initialised"):
            initialize("nccl")
    finally:
        dist.destroy_process_group()


def test_divergent_ranks_fail_not_hang():
    """A rank that waits in a collective the other never enters ends in an
    error (the process group's timeout, or the failed rank's report)."""
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        spawn(diverge, 2, "gloo", timeout_s=10)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("B", [1, 3, 11])
def test_batch_arithmetic_matches_reference(B):
    assert process_local_batch(B) == jparallel.process_local_batch(B) \
        == (0, B, B)
    x = np.arange(3 * B * 2).reshape(3 * B, 2) if B > 1 else np.ones((1, 2))
    for total in (x.shape[0], x.shape[0] + 2):
        np.testing.assert_array_equal(pad_rows(x, total),
                                      jparallel.pad_rows(x, total))


def test_two_process_global_batch(ranks):
    """mh_worker.py's scenario: B = 3 over 2 processes → 2 rows each,
    padded to 4 by replay; every process holds the global batch and its
    sum."""
    rows = np.arange(4, dtype=np.float32) % 3
    assert [r["batch"] for r in ranks] == [(0, 2, 4), (2, 4, 4)]
    for out in ranks:
        assert out["global_shape"] == (4, 8)
        np.testing.assert_array_equal(out["global"], rows[:, None]
                                      * np.ones((1, 8), np.float32))
        assert out["sum"] == float(rows.sum())


def test_fleet_through_global_machinery(ranks, fleet_inputs):
    """Each process runs its rows of the fleet (run_fleet on its CPU) and
    gathers the rest: every row, on both processes, is run_sequence of
    its sequence bit for bit; the padded row replays sequence 0."""
    rig, cfg, seqs = fleet_inputs
    assert [r["fleet_rows"] for r in ranks] == [(0, 2, 4), (2, 4, 4)]
    for b, seq in enumerate(seqs + [seqs[0]]):
        final, out = so.run_sequence(*seq, rig, cfg, dtype=torch.float64,
                                     device="cpu")
        for r, got in enumerate(ranks):
            window, frames = got["fleet"]
            for name, want in out._asdict().items():
                np.testing.assert_array_equal(
                    frames[name][b], want.numpy(), f"rank {r} row {b} {name}")
            for name, want in final.window._asdict().items():
                np.testing.assert_array_equal(
                    window[name][b], want.numpy(), f"rank {r} row {b} {name}")
