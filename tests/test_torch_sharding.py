"""The port's landmark-sharded solve (``limo_tpu_torch.parallel.sharding``)
against its unsharded solve and against the reference package's
``make_shard_map_solver``, on ``tests/test_solver.py``'s 120-landmark
problem in f64.

Four ranks (``gloo`` on the CPU, started once for the module by
``parallel.spawn``) solve it over model = 4, over model = 2 on each data
group of a 2 x 2 mesh, and as a batch of two equal windows on the 2 x 2
mesh. Tolerances: against the port's own unsharded solve only the order of
the cross-rank sums differs, so poses, landmarks and costs agree within
1e-9 and the trimmed masks exactly; against the reference's sharded solve
on its 8-device mesh, ``tests/test_sharding.py:84-90``'s (poses atol 1e-6,
cost rtol 1e-6, masks exact).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from limo_tpu.parallel import (device_put_selection, device_put_window,
                               make_mesh as j_make_mesh,
                               make_shard_map_solver as j_shard_map_solver)
from limo_tpu_torch import robust
from limo_tpu_torch import state as tstate
from limo_tpu_torch.parallel import (gather_window, make_mesh,
                                     make_shard_map_solver, selection_pspecs,
                                     shard_selection, shard_window, spawn,
                                     window_pspecs)
from limo_tpu_torch.solver import solve_trimmed
from test_solver import (RIG, build_window, default_selection, make_gt_poses,
                         make_landmarks)
from torch_dist_worker import TRIM_CASES, sharded_solves
from torch_parity import assert_close

TOL = 1e-9


@pytest.fixture(scope="module")
def problem():
    """test_sharding.py's problem: the reference's (window, sel, cfg)."""
    rng = np.random.default_rng(7)
    gt = make_gt_poses()
    lms = make_landmarks(rng, n=120)
    w, cfg = build_window(gt, lms, RIG, pose_noise=(0.01, 0.1), lm_noise=0.2,
                          pixel_noise=0.3, rng=rng)
    sel = default_selection(w, scale_weight=1000.0, scale_target=float(
        jnp.linalg.norm(gt[1, 4:] - gt[0, 4:])))
    return w, sel, cfg


@pytest.fixture(scope="module")
def port(problem):
    w, sel, cfg = problem
    return (tstate.window_from_numpy(w, "cpu"),
            tstate.selection_from_numpy(sel, "cpu"),
            tstate.rig_from_numpy(RIG, "cpu"),
            tstate.config_from_dict(dataclasses.asdict(cfg)))


@pytest.fixture(scope="module")
def single(port):
    return solve_trimmed(*port)


@pytest.fixture(scope="module")
def scores(port):
    return np.random.default_rng(11).gamma(2.0, 1.0, port[0].L)


@pytest.fixture(scope="module")
def ranks(port, scores):
    return spawn(sharded_solves, 4, "gloo", args=(*port, scores),
                 timeout_s=600)


def test_mesh_shapes(ranks):
    """make_mesh's layout rule (reference sharding.py:49-60): four ranks
    default to data = 2 x model = 2; the split tables put landmark leaves
    over model and keep keyframe leaves whole."""
    for out in ranks:
        assert out["meshes"] == [(1, 4), (2, 2)]
    w, s = window_pspecs(False), selection_pspecs(True)
    assert w.obs == ("model",) and w.lm_pos == ("model",) and w.poses == ()
    assert s.lm_selected == ("data", "model") and s.scale_target == ("data",)


@pytest.mark.parametrize("layout", ["model4", "model2"])
def test_sharded_equals_single(ranks, single, layout):
    ref_w, ref_sel, ref_info = single
    for r, out in enumerate(ranks):
        got = out[layout]
        msg = f"{layout} rank {r}"
        assert_close(got["window"]["poses"], ref_w.poses, 0, TOL, msg)
        assert_close(got["window"]["lm_pos"], ref_w.lm_pos, 0, TOL, msg)
        assert_close(got["info"]["final_cost"], ref_info.final_cost, TOL,
                     err_msg=msg)
        np.testing.assert_array_equal(got["selected"],
                                      ref_sel.lm_selected.numpy(), msg)
        assert got["info"]["n_rounds"] == ref_info.n_rounds
        assert int(got["info"]["n_trimmed"]) == int(ref_info.n_trimmed)


@pytest.mark.parametrize("layout", ["model4", "model2", "batched"])
def test_solve_info_identical_on_every_rank(ranks, layout):
    first = ranks[0][layout]
    for r, out in enumerate(ranks[1:], 1):
        for field, value in first["info"].items():
            np.testing.assert_array_equal(
                out[layout]["info"][field], value, f"{layout} rank {r} "
                f"{field}")
        for field in ("poses", "planes", "lm_pos"):
            np.testing.assert_array_equal(out[layout]["window"][field],
                                          first["window"][field])


def test_batched_elements_equal(ranks, single):
    """data = 2 x model = 2, two equal windows: the elements are equal bit
    for bit, and each is the unsharded solve within 1e-9."""
    got = ranks[0]["batched"]
    for field, value in got["window"].items():
        np.testing.assert_array_equal(value[0], value[1], field)
    np.testing.assert_array_equal(got["selected"][0], got["selected"][1])
    assert_close(got["window"]["poses"][0], single[0].poses, 0, TOL)


def test_against_reference_shard_map(problem, ranks):
    """The reference's shard_map solver on its 8-device mesh (model = 8):
    test_sharding.py's tolerances, masks exact."""
    w, sel, cfg = problem
    mesh = j_make_mesh(8, data=1)
    ref_w, ref_sel, ref_info = j_shard_map_solver(mesh, RIG, cfg)(
        device_put_window(w, mesh), device_put_selection(sel, mesh))
    for layout in ("model4", "model2"):
        got = ranks[0][layout]
        np.testing.assert_allclose(got["window"]["poses"],
                                   np.asarray(ref_w.poses), atol=1e-6)
        np.testing.assert_allclose(got["info"]["final_cost"],
                                   float(ref_info.final_cost), rtol=1e-6)
        np.testing.assert_array_equal(got["selected"],
                                      np.asarray(ref_sel.lm_selected))


def test_trim_quantile_with_group(ranks, scores):
    """trim_quantile with the model group equals the same call on the
    whole vector, on every rank's shard, and the gathered trims are the
    whole vector's trims."""
    for case, (q, frac) in enumerate(TRIM_CASES):
        whole = []
        for r, out in enumerate(ranks):
            sharded, full = out["trims"][case]
            np.testing.assert_array_equal(sharded, full, f"q={q} rank {r}")
            whole.append(sharded)
        rng = np.random.default_rng(3)
        for _ in range(case + 1):
            valid = rng.uniform(size=scores.shape[0]) < frac
        ref = robust.trim_quantile(torch.as_tensor(scores),
                                   torch.as_tensor(valid), q).numpy()
        np.testing.assert_array_equal(np.concatenate(whole), ref)
        assert 0 < ref.sum() < valid.sum()


def test_one_rank_without_process_group(port, single):
    """One process with no process group: make_mesh gives one rank's
    layout (no groups), shard_window / gather_window leave the window
    whole, and the sharded solver is the unsharded solve bit for bit."""
    assert not dist.is_initialized()
    mesh = make_mesh(device_type="cpu")
    assert (mesh.size(0), mesh.size(1)) == (1, 1)
    assert mesh.get_group("model") is None
    with pytest.raises(ValueError, match="world of 1"):
        make_mesh(2, device_type="cpu")
    w, sel, rig, cfg = port
    ws, ss = shard_window(w, mesh), shard_selection(sel, mesh)
    out_w, out_s, info = make_shard_map_solver(mesh, rig, cfg)(ws, ss)
    for got, want in zip(gather_window(out_w, mesh), single[0]):
        assert torch.equal(got, want)
    assert torch.equal(out_s.lm_selected, single[1].lm_selected)
    assert torch.equal(info.final_cost, single[2].final_cost)
    assert info.n_iterations == single[2].n_iterations
