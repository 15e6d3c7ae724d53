"""Hand-written CUDA kernels for BA normal-equation assembly, with their
plain PyTorch versions — the counterpart of the reference package's
``solver/pallas_assemble.py``.

Two kernels (``csrc/assemble.cu``), both over the lane-major operands of
:func:`limo_tpu_torch.solver.ba_core._kernel_inputs`:

- :func:`assemble_obs` (kernel ``assemble_obs_kernel``): residuals, IRLS
  weights and analytic Jacobians (:mod:`limo_tpu_torch.solver.analytic`)
  in registers, writing only the reduced blocks

      V  [L,3,3]  landmark Hessian blocks
      b_l[L,3]
      W  [L,K,6,3] pose↔landmark cross blocks
      U  [K,6,6]  pose blocks        (per-block partials, summed here)
      b_pose [K,6]
      cost scalar (robust, per-block partials)

- :func:`cost_obs` (kernel ``cost_obs_kernel``): the robust observation
  cost only, for LM accept/reject and the trim rounds. On the same inputs
  it equals :func:`assemble_obs`'s cost bit for bit.

Each wrapper runs its plain version (:func:`assemble_obs_plain`,
:func:`cost_obs_plain`) when it is given CPU tensors; on CUDA tensors it
launches the kernel or raises. ``launches`` counts the kernel launches.

The kernels are built at first use with ``nvcc`` for ``sm_90a`` into
``build/limo_tpu_torch/`` of the checkout and bound through a plain C
interface with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from ..utils.profiling import traced
from .analytic import obs_residual_jac

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "assemble.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "limo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

launches = {"assemble_obs": 0, "cost_obs": 0}

# (rtol, atol) of a kernel's outputs against its plain version: the
# reference package's own tolerances for its Pallas kernel against its
# einsum path (tests/test_pallas_assemble.py:84-89, :173). Per-landmark
# blocks sum K·C terms; U/b_pose sum over every landmark, in another order.
TOLERANCES = {"V": (2e-4, 2e-3), "b_l": (2e-4, 2e-3), "W": (2e-4, 2e-3),
              "U": (2e-3, 0.1), "b_pose": (2e-3, 0.1), "cost": (1e-4, 0.0),
              "cost_obs": (2e-5, 0.0)}


class ObsBlocks(NamedTuple):
    V: torch.Tensor        # [L,3,3]
    b_l: torch.Tensor      # [L,3]
    W: torch.Tensor        # [L,K,6,3]
    U: torch.Tensor        # [K,6,6]
    b_pose: torch.Tensor   # [K,6]
    cost: torch.Tensor     # scalar


class Build(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float         # nvcc wall time (0.0 when the library was cached)
    log: str               # nvcc's report (-Xptxas -v: registers, spills)


_build: Build | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (shutil.which("nvcc"),
                 CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def build() -> Build:
    """Compile ``csrc/assemble.cu`` (once per source and flags) and load it."""
    global _build
    if _build is not None:
        return _build
    tag = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so = _BUILD_DIR / f"libassemble-{tag}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(_SRC)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ins = [ptr] * 7 + [i32, i32, i32, f32, f32]
    lib.limo_assemble_obs.argtypes = ins + [ptr] * 5 + [ptr]
    lib.limo_assemble_obs.restype = i32
    lib.limo_cost_obs.argtypes = ins + [ptr] + [ptr]
    lib.limo_cost_obs.restype = i32
    lib.limo_block_size.argtypes = []
    lib.limo_block_size.restype = i32
    _build = Build(lib=lib, path=so, seconds=seconds, log=log)
    return _build


def block_size() -> int:
    """Threads (= landmarks) per block of both kernels."""
    return build().lib.limo_block_size()


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any float dtype, any device)
# ---------------------------------------------------------------------------

def _plain_terms(obs_t, repr_base, depth_base, lm_t, wlm, pose_mats, cam_mats,
                 K, C, a2r, a2d):
    """Per-observation residuals, masks, Jacobians and robust cost on the
    [L,K,C] grid, from the closed forms of solver/analytic.py."""
    L = obs_t.shape[1]
    uvd = obs_t.reshape(K, C, 3, L).permute(3, 0, 1, 2)          # [L,K,C,3]
    r, valid, Jp, Jl = obs_residual_jac(
        pose_mats[:, :9].reshape(1, K, 1, 3, 3),
        pose_mats[:, 9:].reshape(1, K, 1, 3),
        lm_t.T.reshape(L, 1, 1, 3), uvd,
        cam_mats[:, 12].reshape(1, 1, C),
        cam_mats[:, 13:15].reshape(1, 1, C, 2),
        cam_mats[:, :9].reshape(1, 1, C, 3, 3),
        cam_mats[:, 9:12].reshape(1, 1, C, 3))
    z = r[..., 2] + uvd[..., 2]
    m_repr = repr_base.reshape(K, C, L).permute(2, 0, 1) * valid
    m_depth = depth_base.reshape(K, C, L).permute(2, 0, 1) * (z > 0)
    s_repr = r[..., 0] ** 2 + r[..., 1] ** 2
    s_dep = r[..., 2] ** 2
    w = wlm.reshape(L, 1, 1)
    cost = 0.5 * torch.sum(w * (m_repr * a2r * torch.log1p(s_repr / a2r)
                                + m_depth * a2d * torch.log1p(s_dep / a2d)))
    w_r = m_repr * w / (1.0 + s_repr / a2r)
    w_d = m_depth * w / (1.0 + s_dep / a2d)
    row_w = torch.stack([w_r, w_r, w_d], -1)                     # [L,K,C,3]
    return r, row_w, Jp, Jl, cost


def assemble_obs_plain(obs_t, repr_base, depth_base, lm_t, wlm, pose_mats,
                       cam_mats, K: int, C: int, a2r: float, a2d: float
                       ) -> ObsBlocks:
    """Plain version of :func:`assemble_obs`: the same blocks by einsum."""
    r, row_w, Jp, Jl, cost = _plain_terms(
        obs_t, repr_base, depth_base, lm_t, wlm, pose_mats, cam_mats,
        K, C, a2r, a2d)
    Jp_w = Jp * row_w[..., None]
    Jl_w = Jl * row_w[..., None]
    return ObsBlocks(
        V=torch.einsum("lkcri,lkcrj->lij", Jl_w, Jl),
        b_l=-torch.einsum("lkcri,lkcr->li", Jl_w, r),
        W=torch.einsum("lkcri,lkcrj->lkij", Jp_w, Jl),
        U=torch.einsum("lkcri,lkcrj->kij", Jp_w, Jp),
        b_pose=-torch.einsum("lkcri,lkcr->ki", Jp_w, r),
        cost=cost)


def cost_obs_plain(obs_t, repr_base, depth_base, lm_t, wlm, pose_mats,
                   cam_mats, K: int, C: int, a2r: float, a2d: float
                   ) -> torch.Tensor:
    """Plain version of :func:`cost_obs`."""
    return _plain_terms(obs_t, repr_base, depth_base, lm_t, wlm, pose_mats,
                        cam_mats, K, C, a2r, a2d)[-1]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _on_cpu(ops) -> bool:
    """True for CPU operands, False for CUDA f32 ones the kernels take;
    raises on anything else."""
    devices = {t.device for t in ops}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return False


def _kernel_args(ops, K, C):
    obs_t, repr_base, depth_base, lm_t, wlm, pose_mats, cam_mats = ops
    L = obs_t.shape[1]
    shapes = {"obs_t": (K * C * 3, L), "repr_base": (K * C, L),
              "depth_base": (K * C, L), "lm_t": (3, L), "wlm": (1, L),
              "pose_mats": (K, 12), "cam_mats": (C, 15)}
    for (name, shape), t in zip(shapes.items(), ops):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes "
                             f"float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if L < 1 or K < 1 or C < 1:
        raise ValueError(f"empty problem: K={K} C={C} L={L}")
    return L, [t.data_ptr() for t in ops]


def kernel_outputs(name: str, K: int, L: int, device) -> tuple:
    """Uninitialised lane-major outputs of kernel ``name``: for
    ``assemble_obs`` V [9,L], b_l [3,L], W [K*18,L], the per-block U/b_pose
    partials [n_blocks,K,42] and cost partials [n_blocks]; for
    ``cost_obs`` the cost partials only."""
    nb = -(-L // block_size())
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=device)
    if name == "assemble_obs":
        return new(9, L), new(3, L), new(K * 18, L), new(nb, K, 42), new(nb)
    return (new(nb),)


def launcher(name: str, ops, outs, K: int, C: int, a2r: float, a2d: float):
    """Check the card operands of kernel ``name`` once and return a call
    that launches it into ``outs`` (:func:`kernel_outputs`) on the current
    stream, raises on a failed launch and counts each launch."""
    L, ptrs = _kernel_args(ops, K, C)
    fn = getattr(build().lib, f"limo_{name}")
    args = (*ptrs, K, C, L, a2r, a2d, *(t.data_ptr() for t in outs))
    device = ops[0].device

    def launch():
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: kernel launch failed with CUDA "
                               f"error {rc}")
        launches[name] += 1
    return launch


@traced("limo.assemble_obs")
def assemble_obs(obs_t, repr_base, depth_base, lm_t, wlm, pose_mats,
                 cam_mats, K: int, C: int, a2r: float, a2d: float
                 ) -> ObsBlocks:
    """Observation blocks of the normal equations (see module docstring).

    obs_t [K*C*3, L]; repr/depth_base [K*C, L] 0/1; lm_t [3,L]; wlm [1,L];
    pose_mats [K,12] (R row-major + t); cam_mats [C,15] (R_cv + t_cv +
    f,cx,cy). L takes any value ≥ 1."""
    ops = (obs_t, repr_base, depth_base, lm_t, wlm, pose_mats, cam_mats)
    if _on_cpu(ops):
        return assemble_obs_plain(*ops, K, C, a2r, a2d)
    L = obs_t.shape[1]
    outs = kernel_outputs("assemble_obs", K, L, obs_t.device)
    launcher("assemble_obs", ops, outs, K, C, a2r, a2d)()
    V_t, bl_t, W_t, up, cost_p = outs
    ub = up.sum(0)                                              # [K,42]
    return ObsBlocks(V=V_t.T.reshape(L, 3, 3), b_l=bl_t.T,
                     W=W_t.T.reshape(L, K, 6, 3),
                     U=ub[:, :36].reshape(K, 6, 6), b_pose=ub[:, 36:],
                     cost=cost_p.sum())


@traced("limo.cost_obs")
def cost_obs(obs_t, repr_base, depth_base, lm_t, wlm, pose_mats, cam_mats,
             K: int, C: int, a2r: float, a2d: float) -> torch.Tensor:
    """Robust observation cost only (same operands as :func:`assemble_obs`)."""
    ops = (obs_t, repr_base, depth_base, lm_t, wlm, pose_mats, cam_mats)
    if _on_cpu(ops):
        return cost_obs_plain(*ops, K, C, a2r, a2d)
    outs = kernel_outputs("cost_obs", K, obs_t.shape[1], obs_t.device)
    launcher("cost_obs", ops, outs, K, C, a2r, a2d)()
    return outs[0].sum()


def compare_with_plain(ops, sizes) -> dict:
    """Run both kernels and their plain versions on the same operands and
    raise AssertionError unless every output agrees within
    :data:`TOLERANCES` and the two kernels' costs are equal. Returns
    ``{kernel: (max_abs_err, max_rel_err)}`` over its outputs."""
    out, cost = assemble_obs(*ops, **sizes), cost_obs(*ops, **sizes)
    ref = assemble_obs_plain(*ops, **sizes)
    outputs = {
        "assemble_obs": [(f, getattr(out, f), getattr(ref, f))
                         for f in out._fields],
        "cost_obs": [("cost_obs", cost, cost_obs_plain(*ops, **sizes))],
    }
    errs = {}
    for kernel, fields in outputs.items():
        abs_err = rel_err = 0.0
        for field, a, b in fields:
            rtol, atol = TOLERANCES[field]
            torch.testing.assert_close(
                a, b, rtol=rtol, atol=atol,
                msg=lambda m, f=field: f"{kernel} {f}: {m}")
            err = float((a - b).abs().max())
            abs_err = max(abs_err, err)
            rel_err = max(rel_err, err / max(float(b.abs().max()), 1e-30))
        errs[kernel] = (abs_err, rel_err)
    if not torch.equal(cost, out.cost):
        raise AssertionError(f"cost kernel {float(cost)} != assembly "
                             f"kernel cost {float(out.cost)}")
    return errs
