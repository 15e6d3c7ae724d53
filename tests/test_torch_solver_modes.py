"""The windowed solver's modes in the PyTorch port against the reference
package, in f64 on the CPU, on ``torch_parity.rich_problem`` (the
reference's ``_make_problem(8, 256, 6, 200)`` with every assembly family
on):

- ``assemble`` and ``compute_cost`` with rotation-compensated (RotRocc)
  residuals, the motion-only mode (``pose_only``: landmarks held fixed, only
  the speed regularizer kept) and the speed regularizer, and with the
  kernels turned off: every NormalEqs block within rtol 1e-9 (atol 1e-9 ×
  the field's largest entry), the cost within rtol 1e-9;
- ``residual_stats`` on RotRocc residuals: scores within 1e-9, masks and
  counts exact;
- the windowed motion-only solve (``run_lm(pose_only=True, speed_reg,
  initial_lambda=1e-3)``): landmarks exactly unchanged, poses within 1e-9,
  the accepted steps equal;
- ``solve_trimmed(compensate_rotation=True)``: rounds, trims, accepted
  steps, iterations and the trimmed mask exact, the final cost within
  rtol 1e-9; and over two ranks (``gloo``) equal to the single solve within
  1e-9 with the same mask;
- the motion-only assembly in f32 against the reference's Pallas kernel in
  interpret mode (the kernel tolerances of ``cuda_assemble.TOLERANCES``;
  the landmark blocks that the mode masks exactly I and 0);
- ``assembly_plan``'s reasons, the reference's ``einsum(<reason>)`` as
  ``torch(<reason>)``.

The reference's results are computed once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu.solver import ba_core as j_ba
from limo_tpu.solver import lm as j_lm
from limo_tpu.solver.trimmed import solve_trimmed as j_solve_trimmed
from limo_tpu_torch.entry import speed_regularizer
from limo_tpu_torch.parallel import spawn
from limo_tpu_torch.solver import ba_core as t_ba
from limo_tpu_torch.solver import cuda_assemble as ca
from limo_tpu_torch.solver import lm as t_lm
from limo_tpu_torch.solver import solve_trimmed as t_solve_trimmed
from torch_dist_worker import rotrocc_sharded_solve
from torch_parity import assert_close, rich_problem, to_torch

TOL = 1e-9
# (compensate_rotation, pose_only, speed regularizer, kernels on)
MODES = {"rotrocc": (True, False, False, True),
         "pose_only_speed": (False, True, True, True),
         "speed": (False, False, True, True),
         "rotrocc_pose_only_speed": (True, True, True, True),
         "disabled": (False, False, False, False)}


def _off(cfg):
    return cfg.replace(solver=dataclasses.replace(cfg.solver,
                                                  use_pallas_assembly=False))


def speed_regs(tw):
    """The motion-only speed regularizer of the port's window
    (``entry.speed_regularizer``: the newest active keyframe, from its pose
    before the solve): (the reference's tuple, the port's)."""
    tsr = speed_regularizer(tw)
    return (tsr[0], *[jnp.asarray(x.numpy()) for x in tsr[1:3]],
            *tsr[3:]), tsr


@pytest.fixture(scope="module")
def problem():
    """(reference's (w, sel, rig, cfg), port's, speed regs)."""
    ref = rich_problem()
    port = to_torch(*ref)
    return ref, port, speed_regs(port[0])


@pytest.fixture(scope="module")
def reference(problem):
    """The reference's assembly and cost in every mode."""
    (w, sel, rig, cfg), _, (jsr, _) = problem
    out = {}
    for name, (rot, po, sp, on) in MODES.items():
        kw = dict(compensate_rotation=rot, pose_only=po,
                  speed_reg=jsr if sp else None)
        c = cfg if on else _off(cfg)
        eqs, _ = jax.jit(lambda a, b: j_ba.assemble(a, b, rig, c, **kw))(w,
                                                                         sel)
        cost = jax.jit(lambda a, b: j_ba.compute_cost(a, b, rig, c, **kw))(
            w, sel)
        out[name] = jax.device_get((eqs, cost))
    return out


def assert_eqs(out, ref, rtol=TOL):
    for field in out._fields:
        a, b = getattr(out, field).numpy(), np.asarray(getattr(ref, field))
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            assert_close(a, b, rtol, rtol * max(np.abs(b).max(), 1e-300),
                         err_msg=field)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_assemble_and_cost_modes(problem, reference, mode):
    _, (tw, tsel, trig, tcfg), (_, tsr) = problem
    rot, po, sp, on = MODES[mode]
    c = tcfg if on else _off(tcfg)
    kw = dict(compensate_rotation=rot, pose_only=po,
              speed_reg=tsr if sp else None)
    ref_eqs, ref_cost = reference[mode]
    out = t_ba.assemble(tw, tsel, trig, c, **kw)
    assert_eqs(out, ref_eqs)
    assert_close(t_ba.compute_cost(tw, tsel, trig, c, **kw), ref_cost, TOL)
    if po:
        # the landmarks are held: identity landmark blocks, no coupling
        assert not out.lm_mask.any()
        assert torch.equal(out.V, torch.eye(3, dtype=out.V.dtype).expand_as(
            out.V))
        assert not out.b_l.any() and not out.W6.any() and not out.Wp.any()


def test_residual_stats_rotrocc(problem):
    (w, sel, rig, cfg), (tw, tsel, trig, tcfg), _ = problem
    ref = jax.jit(lambda a, b: j_ba.residual_stats(
        a, b, rig, cfg, compensate_rotation=True))(w, sel)
    out = t_ba.residual_stats(tw, tsel, trig, tcfg, compensate_rotation=True)
    plain = t_ba.residual_stats(tw, tsel, trig, tcfg)
    assert not torch.equal(out.repr_score, plain.repr_score)
    for field in out._fields:
        a, b = getattr(out, field).numpy(), np.asarray(getattr(ref, field))
        if b.dtype == bool or b.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            assert_close(a, b, TOL, 1e-12, err_msg=field)


def test_windowed_motion_only_solve(problem):
    """run_lm in the motion-only mode with the speed regularizer, from a
    caller's λ: the landmarks do not move, the poses do."""
    (w, sel, rig, cfg), (tw, tsel, trig, tcfg), (jsr, tsr) = problem
    n = cfg.solver.pose_only_max_iterations
    kw = dict(pose_only=True, initial_lambda=1e-3)
    ref_w, ref_cost, ref_lam, ref_acc = jax.jit(lambda a, b: j_lm.run_lm(
        a, b, rig, cfg, n, speed_reg=jsr, **kw))(w, sel)
    out_w, cost, lam, acc = t_lm.run_lm(tw, tsel, trig, tcfg, n,
                                        speed_reg=tsr, **kw)
    assert torch.equal(out_w.lm_pos, tw.lm_pos)
    assert not torch.equal(out_w.poses, tw.poses)
    assert int(acc) == int(ref_acc) > 0
    assert_close(out_w.poses, ref_w.poses, TOL, TOL)
    assert_close(cost, ref_cost, TOL)
    assert_close(lam, ref_lam, TOL)


@pytest.fixture(scope="module")
def rotrocc_single(problem):
    _, port, _ = problem
    return t_solve_trimmed(*port, compensate_rotation=True)


def test_rotrocc_trimmed_solve(problem, rotrocc_single):
    (w, sel, rig, cfg), _, _ = problem
    ref_w, ref_sel, ref = jax.device_get(jax.jit(lambda a, b: j_solve_trimmed(
        a, b, rig, cfg, compensate_rotation=True))(w, sel))
    out_w, out_sel, info = rotrocc_single
    assert (info.n_rounds, int(info.n_trimmed), int(info.n_accepted),
            info.n_iterations) == (int(ref.n_rounds), int(ref.n_trimmed),
                                   int(ref.n_accepted), int(ref.n_iterations))
    assert int(info.n_trimmed) > 0
    np.testing.assert_array_equal(out_sel.lm_selected.numpy(),
                                  ref_sel.lm_selected)
    for f in ("trimmed_repr", "trimmed_depth", "trimmed_gp", "accept_trace"):
        np.testing.assert_array_equal(getattr(info, f).numpy(),
                                      getattr(ref, f), err_msg=f)
    assert_close(info.final_cost, ref.final_cost, TOL)
    assert_close(info.initial_cost, ref.initial_cost, TOL)
    assert_close(out_w.poses, ref_w.poses, 1e-8, 1e-8)


def test_rotrocc_trimmed_solve_sharded(problem, rotrocc_single):
    """Two ranks, each solving its half of the landmarks (gloo on the
    CPU), against the single solve."""
    _, port, _ = problem
    ranks = spawn(rotrocc_sharded_solve, 2, "gloo", args=port, timeout_s=300)
    out_w, out_sel, info = rotrocc_single
    for r in ranks:
        np.testing.assert_array_equal(r["selected"],
                                      out_sel.lm_selected.numpy())
        assert r["info"]["n_iterations"] == info.n_iterations
        assert int(r["info"]["n_trimmed"]) == int(info.n_trimmed)
        assert_close(r["info"]["final_cost"], info.final_cost, TOL)
        for f in ("poses", "lm_pos", "planes"):
            assert_close(r["window"][f], getattr(out_w, f), TOL, TOL,
                         err_msg=f)


def test_motion_only_against_pallas_interpret():
    """The motion-only assembly with the speed regularizer in f32: the
    port's kernel route (plain versions on the CPU) against the
    reference's Pallas kernel in interpret mode. The mode's masks act after
    the kernel's blocks."""
    w, sel, rig, cfg = rich_problem(dtype=jnp.float32)
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver,
                                                 pallas_interpret=True))
    tw, tsel, trig, tcfg = to_torch(w, sel, rig, cfg)
    jsr, tsr = speed_regs(tw)
    assert j_ba.assembly_plan(w.L, w.poses.dtype, cfg).startswith("pallas")
    kw = dict(pose_only=True)
    ref, _ = jax.jit(lambda a, b: j_ba.assemble(a, b, rig, cfg, speed_reg=jsr,
                                                **kw))(w, sel)
    ref_cost = jax.jit(lambda a, b: j_ba.compute_cost(
        a, b, rig, cfg, speed_reg=jsr, **kw))(w, sel)
    assert t_ba.assembly_plan(torch.float32, "cpu", tcfg) == "plain(cpu)"
    out = t_ba.assemble(tw, tsel, trig, tcfg, speed_reg=tsr, **kw)
    tol = {"H_pp": ca.TOLERANCES["U"], "b_p": ca.TOLERANCES["b_pose"],
           "cost": ca.TOLERANCES["cost"]}
    for field in out._fields:
        a, b = getattr(out, field).numpy(), np.asarray(getattr(ref, field))
        if field in tol:
            assert_close(a, b, *tol[field], err_msg=field)
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)
    assert_close(t_ba.compute_cost(tw, tsel, trig, tcfg, speed_reg=tsr, **kw),
                 ref_cost, *ca.TOLERANCES["cost"])


def test_assembly_plan_reasons(problem, monkeypatch):
    """The reference's einsum(<reason>) is the port's torch(<reason>) on
    either device; otherwise the kernels' route. The reference on the CPU
    names the reasons of the cases it routes past its kernel."""
    monkeypatch.setattr(ca, "block_size", lambda: 512)
    (w, _, _, cfg), (_, _, _, tcfg), _ = problem
    off, t_off = _off(cfg), _off(tcfg)
    f32, f64 = torch.float32, torch.float64
    cases = [  # (dtype, device, port cfg, rotrocc, reference cfg, want)
        (f32, "cpu", tcfg, False, None, "plain(cpu)"),
        (f64, "cpu", tcfg, False, None, "plain(cpu)"),
        (f32, "cpu", t_off, False, off, "torch(disabled)"),
        (f64, "cpu", tcfg, True, cfg, "torch(rotation-compensated)"),
        (f32, "cpu", t_off, True, off, "torch(disabled)"),
        (f32, "cuda", tcfg, False, None, "cuda[block=512]"),
        (f64, "cuda", tcfg, False, cfg, "torch(dtype)"),
        (f32, "cuda", t_off, False, off, "torch(disabled)"),
        (f32, "cuda", tcfg, True, cfg, "torch(rotation-compensated)"),
        (f64, "cuda", tcfg, True, cfg, "torch(rotation-compensated)"),
    ]
    for dtype, device, c, rot, ref_cfg, want in cases:
        assert t_ba.assembly_plan(dtype, device, c, rot) == want
        if ref_cfg is not None:
            j_dtype = jnp.float64 if dtype == f64 else jnp.float32
            assert j_ba.assembly_plan(w.L, j_dtype, ref_cfg, rot) == \
                want.replace("torch", "einsum")
    for dtype, device in ((torch.float16, "cuda"), (f32, "meta")):
        with pytest.raises(ValueError):
            t_ba.assembly_plan(dtype, device, tcfg)
