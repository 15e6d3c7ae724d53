"""The port's CUDA kernel wrappers: CPU dispatch, operand checks, the
evaluation counts of the solve, and — on a card — each kernel against its
plain version and the bench solve through both kernels.

This file needs neither JAX nor the reference package, so the card's
tests run where only PyTorch is installed (the repository's
tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m gpu

Tolerances on the card are the reference's own kernel tolerances
(tests/test_pallas_assemble.py:84-89): the kernel sums in another order
than the plain version's einsums. The two kernels' costs must be equal.
"""

import contextlib
import ctypes
import dataclasses
import re
import shutil
import subprocess
import types
from pathlib import Path

import pytest
import torch

from limo_tpu_torch.config import LimoConfig
from limo_tpu_torch.entry import kernel_check_windows, make_problem, \
    rolled_window, scan_drive, two_camera_window
from limo_tpu_torch.pipeline import scan_odometry as so
from limo_tpu_torch.solver import ba_core as t_ba
from limo_tpu_torch.solver import cuda_assemble as ca
from limo_tpu_torch.solver import solve_trimmed as t_solve_trimmed


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _port_problem():
    return make_problem(6, 200, 5, 150, torch.float32, seed=3, device="cpu")


def test_assembly_plan_and_cpu_dispatch():
    """The device alone picks the path: the plain one on the CPU, the
    kernels on a card, which has no plain path (a card window that is not
    float32, or a config that turns the kernels off, raises). On CPU
    tensors the wrappers run their plain versions without launching
    anything."""
    w, sel, rig, cfg = _port_problem()
    off = cfg.replace(solver=dataclasses.replace(cfg.solver,
                                                 use_pallas_assembly=False))
    for dtype in (torch.float32, torch.float64):
        for c in (cfg, off):
            assert t_ba.assembly_plan(dtype, "cpu", c) == "plain(cpu)"
    for dtype, c in ((torch.float32, off), (torch.float64, cfg),
                     (torch.float16, cfg)):
        with pytest.raises(ValueError):
            t_ba.assembly_plan(dtype, "cuda", c)
    with pytest.raises(ValueError):
        t_ba.assembly_plan(torch.float32, "meta", cfg)
    ops, sizes = t_ba._obs_kernel_args(w, sel, rig, cfg)
    before = dict(ca.launches)
    blocks, plain = ca.assemble_obs(*ops, **sizes), ca.assemble_obs_plain(
        *ops, **sizes)
    for field in blocks._fields:
        assert torch.equal(getattr(blocks, field), getattr(plain, field))
    assert torch.equal(ca.cost_obs(*ops, **sizes),
                       ca.cost_obs_plain(*ops, **sizes))
    assert ca.launches == before


def test_solve_evaluation_counts(monkeypatch):
    """One assembly per LM iteration; one cost evaluation for the initial
    cost, one per iteration and one per trim round — the launch counts
    that chip_smoke.py asserts for the kernels on the card."""
    calls = {"assemble": 0, "cost": 0}

    def counted(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ca, "assemble_obs_plain",
                        counted(ca.assemble_obs_plain, "assemble"))
    monkeypatch.setattr(ca, "cost_obs_plain",
                        counted(ca.cost_obs_plain, "cost"))
    w, sel, rig, cfg = make_problem(8, 300, 6, 200, torch.float32, seed=2,
                                    device="cpu")
    _, _, info = t_solve_trimmed(w, sel, rig, cfg)
    assert info.n_rounds == 1 and int(info.n_trimmed) > 0
    assert calls["assemble"] == info.n_iterations
    assert calls["cost"] == 1 + info.n_iterations + info.n_rounds
    assert 0 < info.n_host_syncs <= info.n_iterations


def test_rolled_window_fills_slots_past_32():
    """The K > 32 check window: its keyframes in use sit in slots 28-39, so
    slots 32 and above hold observations, and L = 999 fills no tile of
    landmarks. Its plain assembly is the unrolled window's, with the
    keyframe axis rolled by 28."""
    w, sel, rig, cfg = rolled_window(device="cpu")
    assert w.K == 40 and w.L % 32 != 0
    assert w.kf_valid[28:].all() and not w.kf_valid[:28].any()
    assert w.obs_mask[:, 32:].any()

    def plain(problem):
        ops, sizes = t_ba._obs_kernel_args(*problem)
        return ca.assemble_obs_plain(*ops, **sizes)

    out = plain((w, sel, rig, cfg))
    ref = plain(make_problem(40, 999, 12, 700, torch.float32, seed=3,
                             device="cpu"))
    assert out.W[:, 32:].abs().sum() > 0
    torch.testing.assert_close(out.W, torch.roll(ref.W, 28, 1))
    torch.testing.assert_close(out.U, torch.roll(ref.U, 28, 0))
    torch.testing.assert_close(out.b_pose, torch.roll(ref.b_pose, 28, 0))
    for field in ("V", "b_l", "cost"):
        torch.testing.assert_close(getattr(out, field), getattr(ref, field))


def _f32_error_over_tolerance(problem):
    """max over the assembly's fields of |f32 plain - f64 plain| over the
    kernels' tolerance at the f64 value, on the same f32 operands."""
    ops, sizes = t_ba._obs_kernel_args(*problem)
    f32 = ca.assemble_obs_plain(*ops, **sizes)
    f64 = ca.assemble_obs_plain(*[t.double() for t in ops], **sizes)
    ratio = 0.0
    for field in f32._fields:
        rtol, atol = ca.TOLERANCES[field]
        a, b = getattr(f32, field).double(), getattr(f64, field)
        ratio = max(ratio, float(((a - b).abs() / (atol + rtol * b.abs()))
                                 .max()))
    return ratio


def test_rolled_window_within_tolerance_of_f64():
    """The K > 32 check window keeps float32 rounding well inside the
    kernels' tolerance (its f32 plain assembly lies within half of it of
    the f64 one), so kernel and plain cannot differ by more than the
    tolerance from rounding alone. The same roll of 20 keyframes would not:
    over 20 frames the drive brings landmarks to 4 m, and the f32 plain
    assembly itself falls outside the tolerance of the f64 one."""
    assert _f32_error_over_tolerance(rolled_window(device="cpu")) < 0.5
    assert _f32_error_over_tolerance(make_problem(
        40, 999, 20, 700, torch.float32, seed=2, device="cpu")) > 1.0


def test_wrapper_rejects_bad_operands():
    """The launch path checks shapes, dtype and contiguity before it
    touches a pointer (the checks run on any device)."""
    w, sel, rig, cfg = _port_problem()
    ops, sizes = t_ba._obs_kernel_args(w, sel, rig, cfg)
    K, C = sizes["K"], sizes["C"]
    ca._kernel_args(ops, K, C)                       # well-formed: no raise
    bad = [
        (0, ops[0].double()),                        # dtype
        (3, ops[3][:, :-1]),                         # shape (L mismatch)
        (5, ops[5].T.contiguous().T),                # not contiguous
    ]
    for i, t in bad:
        broken = list(ops)
        broken[i] = t
        with pytest.raises(ValueError):
            ca._kernel_args(broken, K, C)
    with pytest.raises(ValueError):
        ca._on_cpu([ops[0], ops[1].to("meta")])


def test_ticket_counter_per_stream(monkeypatch):
    """Each (device, stream) has its own cross-block ticket counter, zeroed
    when it is made and then reused: launches on a second stream never
    share the first stream's counter."""
    monkeypatch.setattr(ca, "_counters", {})
    cpu = torch.device("cpu")
    first, second = ca._counter(cpu, 1), ca._counter(cpu, 2)
    assert first is not second
    assert ca._counter(cpu, 1) is first
    assert int(first) == 0 and first.dtype == torch.int32


def _emulated_kernels(tmp_path):
    """``csrc/assemble.cu`` compiled for the CPU against tests/cuda_emu.h
    (or a skip where there is no g++), bound like the nvcc build."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    src = ca._SRC.read_text()
    src = src.replace("#include <cuda_runtime.h>",
                      f'#include "{Path(__file__).with_name("cuda_emu.h")}"')
    src = src.replace("extern __shared__ float smem[];",
                      "float* smem = emu_dyn_smem();")
    src = re.sub(r"(\w+)<<<(.*?)>>>", r"emu_launcher(\1, \2)", src,
                 flags=re.S)
    cpp, so = tmp_path / "assemble_emu.cpp", tmp_path / "libassemble_emu.so"
    cpp.write_text(src)
    # -ffp-contract=off stands for nvcc's -fmad=false
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-Wno-unknown-pragmas", "-o",
                    str(so), str(cpp)], check=True, capture_output=True)
    return ca.bind(ctypes.CDLL(str(so)))


def test_kernel_source_emulated_on_cpu(tmp_path, monkeypatch):
    """The kernels' own source, run on the CPU (one thread per CUDA thread,
    tests/cuda_emu.h) through the wrappers' launch path: on the 2-camera
    window and the K > 32 window, every output within TOLERANCES of the
    plain version and the two costs equal (compare_with_plain), a second
    launch bit-identical, and the ticket counter back at 0."""
    lib = _emulated_kernels(tmp_path)
    monkeypatch.setattr(ca, "_build", ca.Build(lib=lib, path=Path(),
                                               seconds=0.0, log=""))
    monkeypatch.setattr(ca, "_counters", {})
    monkeypatch.setattr(ca, "_on_cpu", lambda ops: False)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    w, sel, rig = two_camera_window(device="cpu")
    for problem in ((w, sel, rig, LimoConfig()), rolled_window(device="cpu")):
        ops, sizes = t_ba._obs_kernel_args(*problem)
        ca.compare_with_plain(ops, sizes)
        first, again = (ca.assemble_obs(*ops, **sizes) for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        assert int(ca._counters[(torch.device("cpu"), 0)]) == 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda):
    for name, (w, sel, rig, cfg) in kernel_check_windows(cuda):
        errs = ca.compare_with_plain(*t_ba._obs_kernel_args(w, sel, rig, cfg))
        torch.cuda.synchronize()
        assert set(errs) == {"assemble_obs", "cost_obs"}, name


@pytest.mark.gpu
def test_kernels_on_k40_ragged_window(cuda):
    """K = 40 keyframe slots, observed in slots 28-39 (past one warp's 32),
    and L = 999, which fills no tile: both kernels against their plain
    versions, with nonzero cross blocks in the slots past 32."""
    w, sel, rig, cfg = rolled_window(cuda)
    ops, sizes = t_ba._obs_kernel_args(w, sel, rig, cfg)
    ca.compare_with_plain(ops, sizes)
    assert ca.assemble_obs(*ops, **sizes).W[:, 32:].abs().sum() > 0


@pytest.mark.gpu
def test_repeated_launches_bit_identical(cuda):
    """20 launches on the same inputs give the same bits: the cross-block
    counter resets and the in-kernel sums run in a fixed order."""
    for _, (w, sel, rig, cfg) in kernel_check_windows(cuda):
        ops, sizes = t_ba._obs_kernel_args(w, sel, rig, cfg)
        first, cost = ca.assemble_obs(*ops, **sizes), ca.cost_obs(*ops, **sizes)
        for _ in range(19):
            again = ca.assemble_obs(*ops, **sizes)
            assert all(torch.equal(a, b) for a, b in zip(first, again))
            assert torch.equal(ca.cost_obs(*ops, **sizes), cost)


@pytest.mark.gpu
def test_public_output_layouts(cuda):
    """The kernel writes the public layouts: contiguous tensors with the
    shapes of ObsBlocks, on the card, and a 0-d cost."""
    w, sel, rig, cfg = rolled_window(cuda)
    ops, sizes = t_ba._obs_kernel_args(w, sel, rig, cfg)
    K, L = sizes["K"], w.L
    out = ca.assemble_obs(*ops, **sizes)
    shapes = {"V": (L, 3, 3), "b_l": (L, 3), "W": (L, K, 6, 3),
              "U": (K, 6, 6), "b_pose": (K, 6), "cost": ()}
    for field, shape in shapes.items():
        t = getattr(out, field)
        assert tuple(t.shape) == shape and t.is_contiguous(), field
        assert t.device.type == "cuda" and t.dtype == torch.float32, field
    assert torch.equal(out.U, out.U.transpose(1, 2))
    cost = ca.cost_obs(*ops, **sizes)
    assert cost.shape == () and cost.is_contiguous()


@pytest.mark.gpu
def test_solve_trimmed_on_card(cuda):
    """The bench fixture on the card goes through both kernels and lands
    on the reference's f64 solve (77 trimmed, cost 1612.6406 ± 1e-4)."""
    w, sel, rig, cfg = make_problem(20, 1536, 12, 800, torch.float32,
                                    seed=1, device=cuda)
    assert t_ba.assembly_plan(torch.float32, cuda, cfg).startswith("cuda")
    before = dict(ca.launches)
    _, _, info = t_solve_trimmed(w, sel, rig, cfg)
    assert ca.launches["assemble_obs"] - before["assemble_obs"] \
        == info.n_iterations
    assert ca.launches["cost_obs"] - before["cost_obs"] \
        == 1 + info.n_iterations + info.n_rounds
    assert info.n_rounds == 1 and int(info.n_trimmed) == 77
    assert abs(float(info.final_cost) - 1612.640648) / 1612.640648 < 1e-4


@pytest.mark.gpu
def test_scan_drive_repeats_on_card(cuda):
    """Ten frames of the full-width scan drive (20 x 1536 x 1, f32) on the
    card, twice: the same keyframes, solves, pose-only decisions and
    landmark counts, and the same poses bit for bit."""
    stamps, uvd, valid, rig, cfg, _ = scan_drive(num_frames=10, device=cuda)
    runs = [so.run_sequence(stamps, uvd, valid, rig, cfg, device=cuda)[1]
            for _ in range(2)]
    for field in ("is_keyframe", "solved", "po_ok", "n_usable", "n_rate",
                  "pose", "cost"):
        assert torch.equal(getattr(runs[0], field), getattr(runs[1], field))
    assert int(runs[0].is_keyframe.sum()) >= 2


def _projected_drive(n_kf=4, n_lm=60, seed=0):
    """test_window_manager.py's drive: keyframes 1.2 m apart along z and
    landmarks ahead, as tracklets of their exact projections and depths
    (newest stamp first). Returns (poses, stamps, Tracklets)."""
    import numpy as np
    from limo_tpu_torch.geometry import pose_host
    from limo_tpu_torch.pipeline.tracklets import Tracklets
    rng = np.random.default_rng(seed)
    lms = rng.uniform(-1, 1, (n_lm, 3)) * [10.0, 6.0, 4.0] + [0, 0, 25.0]
    poses = [np.array([1.0, 0, 0, 0, 0, 0, -1.2 * k]) for k in range(n_kf)]
    stamps = [0.4 * k for k in range(n_kf)]
    uvd = np.zeros((n_lm, n_kf, 3))
    for col, k in enumerate(reversed(range(n_kf))):
        pc = pose_host.apply(poses[k], lms)
        uvd[:, col, :2] = 600.0 * pc[:, :2] / pc[:, 2:3] + [300.0, 200.0]
        uvd[:, col, 2] = pc[:, 2]
    return poses, stamps, Tracklets(
        stamps=np.asarray(stamps[::-1]), uvd=uvd,
        mask=np.ones((n_lm, n_kf), bool), ids=np.arange(n_lm),
        age=np.full(n_lm, n_kf, np.int32), is_outlier=np.zeros(n_lm, bool),
        label=np.full(n_lm, -2, np.int32))


@pytest.mark.gpu
def test_bundle_adjuster_solve_on_card(cuda):
    """The host engine's BundleAdjuster on the card: a perturbed 4-keyframe
    window with depth solved through both kernels (the launch identity),
    to a lower cost and near the true poses, as the reference package's
    tests/test_window_manager.py asserts."""
    import numpy as np
    from limo_tpu_torch.geometry.camera import CameraRig
    from limo_tpu_torch.window_manager import (FIX_NONE, FIX_POSE,
                                               BundleAdjuster)
    poses, stamps, tl = _projected_drive()
    rng = np.random.default_rng(42)
    ba = BundleAdjuster(CameraRig.single(600.0, 300.0, 200.0, device=cuda),
                        LimoConfig(), torch.float32, cuda)
    for k in range(4):
        p = poses[k].copy()
        if k >= 2:
            p[4:] += rng.normal(0, 0.1, 3)
        ba.push(stamps[k], tl, p, FIX_POSE if k == 0 else FIX_NONE)
    ba.deactivate_keyframes()
    before = dict(ca.launches)
    info = ba.solve()
    assert ca.launches["assemble_obs"] - before["assemble_obs"] \
        == info.n_iterations
    assert ca.launches["cost_obs"] - before["cost_obs"] \
        == 1 + info.n_iterations + info.n_rounds
    assert float(info.final_cost) <= float(info.initial_cost)
    for k, s in enumerate(ba._kf_order):
        assert np.linalg.norm(ba._poses[s][4:] - poses[k][4:]) < 0.05


@pytest.mark.gpu
def test_estimate_essential_on_card(cuda):
    """One batched 5-point RANSAC (256 hypotheses: batched SVDs of
    [256,5,9], determinants of [256,24,10,10], solves of [256,10,9,9]) on
    the card in f64 and f32 against the CPU's f64 call on
    test_essential.py's rotation + translation scene. The nullspace basis
    the card's linear algebra returns is its own, so the results are held
    as tests/test_torch_essential.py holds two bases: ok equal, rotation
    within 5e-3 rad (f32: 1e-2), translation direction within 8e-2 rad
    (f32: 0.15), at most 6 (f32: 12) of 200 inlier flags flipped."""
    import numpy as np
    from limo_tpu_torch.frontend.essential import estimate_essential
    rng = np.random.default_rng(42)
    a = 0.05
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.2, 0.0, -1.0]) / np.linalg.norm([0.2, 0.0, -1.0])
    pts = rng.uniform(-1, 1, (200, 3)) * [8.0, 5.0, 6.0] + [0, 0, 15.0]
    x1 = pts @ R.T + t
    uv0 = 600.0 * pts[:, :2] / pts[:, 2:] + [300.0, 200.0]
    uv1 = 600.0 * x1[:, :2] / x1[:, 2:] + [300.0, 200.0]
    uv0 = uv0 + rng.normal(0, 0.3, uv0.shape)
    uv1 = uv1 + rng.normal(0, 0.3, uv1.shape)

    def run(device, dtype):
        on = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        return estimate_essential(on(uv0), on(uv1),
                                  torch.ones(200, dtype=torch.bool,
                                             device=device),
                                  on(600.0), on([300.0, 200.0]))

    ref = run("cpu", torch.float64)
    assert bool(ref.ok)
    for dtype, rot, tra, flips in ((torch.float64, 5e-3, 8e-2, 6),
                                   (torch.float32, 1e-2, 0.15, 12)):
        got = run(cuda, dtype)
        q0, q1 = ref.q.numpy(), got.q.double().cpu().numpy()
        t0, t1 = ref.t.numpy(), got.t.double().cpu().numpy()
        assert bool(got.ok)
        assert 2 * np.arccos(min(abs(float(np.dot(q0, q1))), 1.0)) <= rot
        assert np.arccos(min(float(np.dot(t0, t1)), 1.0)) <= tra
        assert int((got.inliers.cpu() != ref.inliers).sum()) <= flips
