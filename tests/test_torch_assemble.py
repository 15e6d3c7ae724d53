"""Assembly of the PyTorch port against the reference package.

- The plain versions of the two CUDA kernels against the reference's
  Pallas kernels in interpret mode, on the same f32 operands, with the
  reference's own kernel tolerances (``cuda_assemble.TOLERANCES``, from
  tests/test_pallas_assemble.py:84-89, :173): V/b_l/W rtol 2e-4 atol 2e-3,
  U/b_pose rtol 2e-3 atol 0.1 (sums over all landmarks in another order),
  cost rtol 1e-4, cost kernel rtol 2e-5.
- The port's full ``assemble`` (plain path) against the reference's
  autodiff einsum path in f64, every NormalEqs field, rtol 1e-9 with an
  atol of 1e-9 × the field's largest entry (entries that cancel to ~0).

The kernels themselves are held against these plain versions on the card
in tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_problem
from limo_tpu.solver import ba_core as j_ba
from limo_tpu.solver import analytic as j_analytic
from limo_tpu.solver.pallas_assemble import assemble_obs_pallas, cost_obs_pallas
from limo_tpu_torch.entry import two_camera_window
from limo_tpu_torch.solver import analytic as t_analytic
from limo_tpu_torch.solver import ba_core as t_ba
from limo_tpu_torch.solver import cuda_assemble as ca
from torch_parity import assert_close, rich_problem, to_jax, to_torch


def _jax_operands(case):
    """Lane-major f32 operands of the reference's _kernel_inputs, numpy."""
    if case == "c2":
        tw, _, trig = two_camera_window(K=2, L=128, seed=4, device="cpu")
        w, rig = to_jax(tw, trig)
        active = w.lm_valid
    else:
        w, sel, rig, _ = _make_problem(3, 128, 3, 100, jnp.float32,
                                       with_depth=case == "c1_depth", seed=3)
        active = w.lm_valid & sel.lm_selected
    ins = j_ba._kernel_inputs(w, rig, active)[:7]
    return [np.asarray(x) for x in ins], w.K, w.C


@pytest.mark.parametrize("case", ["c1_depth", "c1_nodepth", "c2"])
def test_plain_matches_pallas_interpret(case):
    ins, K, C = _jax_operands(case)
    a2r, a2d = 1.6 ** 2, 0.16 ** 2
    ref = assemble_obs_pallas(*[jnp.asarray(x) for x in ins], K=K, C=C,
                              a2r=a2r, a2d=a2d, interpret=True, tl=128)
    ref_cost = cost_obs_pallas(*[jnp.asarray(x) for x in ins], K=K, C=C,
                               a2r=a2r, a2d=a2d, interpret=True, tl=128)
    t_ins = [torch.tensor(x) for x in ins]
    out = ca.assemble_obs_plain(*t_ins, K, C, a2r, a2d)
    for field in out._fields:
        assert_close(getattr(out, field), getattr(ref, field),
                     *ca.TOLERANCES[field], err_msg=field)
    assert_close(ca.cost_obs_plain(*t_ins, K, C, a2r, a2d), ref_cost,
                 *ca.TOLERANCES["cost_obs"])


def _with_mode(cfg, mode):
    return cfg.replace(solver=dataclasses.replace(
        cfg.solver, motion_parameterization=mode))


@pytest.mark.parametrize("mode", ["full_dof", "fix_rotation", "circular_2d"])
def test_assemble_matches_einsum_f64(mode):
    w, sel, rig, cfg = rich_problem()
    cfg = _with_mode(cfg, mode)
    ref, _ = jax.jit(lambda a, b: j_ba.assemble(a, b, rig, cfg))(w, sel)
    tw, tsel, trig, tcfg = to_torch(w, sel, rig, cfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    out = t_ba.assemble(tw, tsel, trig, tcfg)
    assert set(out._fields) == set(ref._fields)
    for field in out._fields:
        a, b = getattr(out, field).numpy(), np.asarray(getattr(ref, field))
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            assert_close(a, b, 1e-9, 1e-9 * max(np.abs(b).max(), 1e-300),
                         err_msg=field)


def test_cost_and_stats_match_f64():
    w, sel, rig, cfg = rich_problem(seed=2)
    tw, tsel, trig, tcfg = to_torch(w, sel, rig, cfg)
    ref_cost = jax.jit(lambda a, b: j_ba.compute_cost(a, b, rig, cfg))(w, sel)
    assert_close(t_ba.compute_cost(tw, tsel, trig, tcfg), ref_cost, 1e-9)
    ref = jax.jit(lambda a, b: j_ba.residual_stats(a, b, rig, cfg))(w, sel)
    out = t_ba.residual_stats(tw, tsel, trig, tcfg)
    for field in out._fields:
        a, b = getattr(out, field).numpy(), np.asarray(getattr(ref, field))
        if b.dtype == bool or b.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            assert_close(a, b, 1e-9, 1e-12, err_msg=field)


def test_kernel_inputs_and_jacobians_match_f64():
    """The operand layout the kernels read and the closed-form Jacobians
    they compute, against the reference's."""
    w, sel, rig, cfg = rich_problem(seed=3)
    tw, tsel, trig, _ = to_torch(w, sel, rig, cfg)
    active = w.lm_valid & sel.lm_selected
    ref = j_ba._kernel_inputs(w, rig, active)[:7]
    out = t_ba._kernel_inputs(tw, trig, tw.lm_valid & tsel.lm_selected)
    for a, b in zip(out, ref):
        assert a.is_contiguous()
        assert_close(a, b, 1e-12, 1e-12)
    R, t = np.asarray(ref[5])[:, :9].reshape(-1, 3, 3), np.asarray(ref[5])[:, 9:]
    x, uvd = np.asarray(w.lm_pos)[:40, None], np.asarray(w.obs)[:40, :, 0]
    cam = np.asarray(ref[6])[0]
    args = (R[None], t[None], x, uvd, cam[12], cam[13:15], cam[:9].reshape(3, 3),
            cam[9:12])
    j_out = j_analytic.obs_residual_jac(*[jnp.asarray(a) for a in args])
    t_out = t_analytic.obs_residual_jac(*[torch.tensor(a) for a in args])
    for a, b in zip(t_out, j_out):
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert_close(a, b, 1e-12, 1e-9)
