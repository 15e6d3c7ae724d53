"""LM, Schur solve and trimmed solve of the PyTorch port against the
reference package, plus the port's fixture, carry-over and import hygiene.

Tolerances: in f64 the two packages run the same algorithm with the same
decisions, so iteration/round/trim counts and the trimmed selection are
equal, poses and landmarks agree to atol 1e-8 and costs to rtol 1e-9. In
f32 the accumulation order differs (the reference's iteration count moves
by ±1-2 with f32 rounding), so the f32 run is held to the trim count and
to the final cost at rtol 1e-3.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_problem
from limo_tpu.solver import assemble as j_assemble
from limo_tpu.solver import lm as j_lm
from limo_tpu.solver import solve_trimmed as j_solve_trimmed
from limo_tpu_torch import state as tstate
from limo_tpu_torch.entry import make_problem
from limo_tpu_torch.solver import ba_core as t_ba
from limo_tpu_torch.solver import lm as t_lm
from limo_tpu_torch.solver import solve_trimmed as t_solve_trimmed
from torch_parity import assert_close, rich_problem, to_torch

REPO = Path(__file__).resolve().parents[1]


def _eqs_pair(seed=1):
    """The reference's f64 normal equations, in both packages' types."""
    w, sel, rig, cfg = rich_problem(seed=seed)
    eqs, _ = jax.jit(lambda a, b: j_assemble(a, b, rig, cfg))(w, sel)
    teqs = t_ba.NormalEqs(*[torch.tensor(np.array(x)) for x in eqs])
    return eqs, teqs


def _close_scaled(a, b, rtol, err_msg=""):
    b = np.asarray(b)
    assert_close(a, b, rtol, rtol * max(np.abs(b).max(), 1e-300),
                 err_msg=err_msg)


@pytest.mark.parametrize("lam", [1e-4, 10.0])
def test_solve_normal_equations_matches_f64(lam):
    eqs, teqs = _eqs_pair()
    dp, dl = j_lm.solve_normal_equations(eqs, jnp.asarray(lam))
    tdp, tdl = t_lm.solve_normal_equations(teqs, torch.tensor(lam,
                                                              dtype=torch.float64))
    assert np.abs(np.asarray(dp)).max() > 0
    _close_scaled(tdp, dp, 1e-9, "delta_p")
    _close_scaled(tdl, dl, 1e-9, "delta_l")


def test_indefinite_system_gives_fully_zero_step():
    """A failed Cholesky gives delta_p = 0 AND delta_l = 0 (a landmark-only
    move from an indefinite system could be accepted); the reference
    package does the same."""
    eqs, teqs = _eqs_pair()
    neg = -1e6 * np.eye(eqs.H_pp.shape[0])
    eqs = eqs._replace(H_pp=jnp.asarray(neg))
    teqs = teqs._replace(H_pp=torch.tensor(neg))
    dp, dl = j_lm.solve_normal_equations(eqs, jnp.asarray(1e-4))
    tdp, tdl = t_lm.solve_normal_equations(teqs, torch.tensor(
        1e-4, dtype=torch.float64))
    assert np.all(np.asarray(dp) == 0) and np.all(np.asarray(dl) == 0)
    assert torch.all(tdp == 0) and torch.all(tdl == 0)
    assert np.abs(np.asarray(teqs.b_l)).max() > 0   # V⁻¹ b_l would move


@pytest.mark.parametrize("mode", ["full_dof", "circular_2d"])
def test_apply_step_and_run_lm_match_f64(mode):
    w, sel, rig, cfg = rich_problem(seed=4)
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, motion_parameterization=mode))
    tw, tsel, trig, tcfg = to_torch(w, sel, rig, cfg)
    rng = np.random.default_rng(9)
    dp = rng.normal(0, 0.01, w.K * t_ba.PD)
    dl = rng.normal(0, 0.1, (w.L, 3))
    ref = j_lm.apply_step(w, jnp.asarray(dp), jnp.asarray(dl), mode)
    out = t_lm.apply_step(tw, torch.tensor(dp), torch.tensor(dl), mode)
    for field in ("poses", "planes", "lm_pos"):
        assert_close(getattr(out, field), getattr(ref, field), 1e-12, 1e-12)

    ref_w, ref_cost, ref_lam, ref_acc = jax.jit(
        lambda a, b: j_lm.run_lm(a, b, rig, cfg, 4))(w, sel)
    out_w, cost, lam, acc = t_lm.run_lm(tw, tsel, trig, tcfg, 4)
    assert int(acc) == int(ref_acc)
    assert_close(lam, ref_lam, 1e-12)
    assert_close(cost, ref_cost, 1e-9)
    assert_close(out_w.poses, ref_w.poses, 0, 1e-8)
    assert_close(out_w.lm_pos, ref_w.lm_pos, 0, 1e-8)


def _solve_both(dtype, seed=1):
    w, sel, rig, cfg = _make_problem(8, 512, 6, 300, dtype, seed=seed)
    ref = jax.jit(lambda a, b: j_solve_trimmed(a, b, rig, cfg))(w, sel)
    return ref, t_solve_trimmed(*to_torch(w, sel, rig, cfg))


def test_solve_trimmed_matches_f64():
    (ref_w, ref_sel, ref), (out_w, out_sel, out) = _solve_both(jnp.float64)
    assert out.n_iterations == int(ref.n_iterations)
    assert out.n_rounds == int(ref.n_rounds) == 1
    assert int(out.n_trimmed) == int(ref.n_trimmed) > 0
    assert int(out.n_accepted) == int(ref.n_accepted)
    np.testing.assert_array_equal(out_sel.lm_selected.numpy(),
                                  np.asarray(ref_sel.lm_selected))
    for f in ("trimmed_repr", "trimmed_depth", "trimmed_gp", "accept_trace"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert_close(out.initial_cost, ref.initial_cost, 1e-9)
    assert_close(out.final_cost, ref.final_cost, 1e-9)
    assert_close(out.cost_trace, ref.cost_trace, 1e-9)
    assert_close(out_w.poses, ref_w.poses, 0, 1e-8)
    assert_close(out_w.lm_pos, ref_w.lm_pos, 0, 1e-8)
    assert out.n_host_syncs <= out.n_iterations


def test_solve_trimmed_matches_f32():
    (_, ref_sel, ref), (_, out_sel, out) = _solve_both(jnp.float32)
    assert out.n_rounds == int(ref.n_rounds) == 1
    assert int(out.n_trimmed) == int(ref.n_trimmed) > 0
    assert out.final_cost.dtype == torch.float32
    assert_close(out.final_cost, ref.final_cost, 1e-3)


@pytest.mark.parametrize("with_depth", [True, False])
def test_make_problem_matches_fixture_f64(with_depth):
    ref = _make_problem(8, 64, 6, 40, jnp.float64, with_depth=with_depth,
                        seed=5)
    out = make_problem(8, 64, 6, 40, torch.float64, with_depth=with_depth,
                       seed=5, device="cpu")
    for ref_t, out_t in zip(ref[:3], out[:3]):
        for f in ref_t._fields:
            a, b = getattr(out_t, f), np.asarray(getattr(ref_t, f))
            assert a.numpy().dtype == b.dtype, f
            if b.dtype.kind == "f":
                assert_close(a, b, 1e-12, 1e-12, err_msg=f)
            else:
                np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    assert dataclasses.asdict(out[3]) == dataclasses.asdict(ref[3])


def test_carry_over_round_trip():
    w, sel, rig, cfg = rich_problem(seed=6)
    tw, tsel, trig, tcfg = to_torch(w, sel, rig, cfg)
    back = tstate.window_to_numpy(tw)
    for f in w._fields:
        np.testing.assert_array_equal(getattr(back, f),
                                      np.asarray(getattr(w, f)), err_msg=f)
        assert getattr(back, f).dtype == np.asarray(getattr(w, f)).dtype
    assert tsel.scale_weight.shape == () and float(tsel.scale_weight) == 50.0
    assert trig.T_cam_veh.shape == (1, 7)
    assert tcfg == tstate.config_from_dict(dataclasses.asdict(tcfg))


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither JAX nor the
    reference package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import limo_tpu_torch\n"
        "for m in pkgutil.walk_packages(limo_tpu_torch.__path__, "
        "'limo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'limo_tpu', '__graft_entry__')]\n"
        "assert not bad, bad\n"
        "assert 'limo_tpu_torch.solver.trimmed' in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_host_engine_imports_no_jax():
    """The host engine's modules, imported one by one in a fresh process,
    provide the reference package's public names and pull in neither JAX
    nor the reference package."""
    code = (
        "import importlib, sys\n"
        "names = {\n"
        "  'limo_tpu_torch.frontend.essential': ['estimate_essential',\n"
        "      'motion_prior_unscaled', 'EssentialResult'],\n"
        "  'limo_tpu_torch.frontend.tracker': ['FeatureTracker',\n"
        "      'MulticamFeatureTracker'],\n"
        "  'limo_tpu_torch.frontend.semantics': ['attach_labels'],\n"
        "  'limo_tpu_torch.selection.keyframe': ['select_keyframes'],\n"
        "  'limo_tpu_torch.window_manager': ['BundleAdjuster',\n"
        "      'NotEnoughKeyframesException', 'KeyframeNotFoundException'],\n"
        "  'limo_tpu_torch.pipeline.odometry': ['MonoOdometry',\n"
        "      'LidarOdometry', 'FrameResult'],\n"
        "  'limo_tpu_torch.pipeline.full': ['LimoPipeline'],\n"
        "  'limo_tpu_torch.pipeline.executor': ['run_pipelined',\n"
        "      'PrefetchExecutor'],\n"
        "  'limo_tpu_torch.pipeline.tracklets': ['Tracklets',\n"
        "      'TrackletBuilder', 'merge_tracklets', 'filter_tracklets'],\n"
        "  'limo_tpu_torch.pipeline.synthetic': ['SyntheticTracker'],\n"
        "  'limo_tpu_torch.pipeline.render': ['write_kitti_sequence'],\n"
        "  'limo_tpu_torch.pipeline.evaluation': ['evaluate_kitti_sequence',\n"
        "      'evaluate_synthetic_sequence', 'batch_evaluate_synthetic',\n"
        "      'SequenceReport'],\n"
        "  'limo_tpu_torch.io.kitti': ['KittiSequence', 'read_poses',\n"
        "      'write_poses', 'read_velodyne'],\n"
        "  'limo_tpu_torch.io.png': ['read_png', 'write_png'],\n"
        "  'limo_tpu_torch.utils.diagnostics': ['DiagnosticUpdater'],\n"
        "  'limo_tpu_torch.entry': ['kitti_host_drive'],\n"
        "}\n"
        "for mod, attrs in names.items():\n"
        "    m = importlib.import_module(mod)\n"
        "    missing = [a for a in attrs if not hasattr(m, a)]\n"
        "    assert not missing, (mod, missing)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'limo_tpu', '__graft_entry__', 'PIL')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
