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

import dataclasses

import pytest
import torch

from limo_tpu_torch.entry import kernel_check_windows, make_problem
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
