"""Trimmed least squares — ``robust_optimization::solveTrimmed``
(robust_solving.cpp:140-248) in PyTorch.

Algorithm (reference semantics, SURVEY §2.2):
  for each outer round:
    1. run LM for a small budget (2 iters); if cost did not decrease,
       extend the round to 3× the budget (robust_solving.cpp:167-181)
    2. evaluate raw loss-free residuals grouped per landmark; score =
       max block norm within the group (robust_solving.cpp:67-91)
    3. per family (depth / reprojection / gp) trim by its
       ``TrimmerSpecification`` — Fix | Quantile dispatch per family
       (robust_solving.hpp:18-25,135-156; apply_trimmer.hpp:29-45) —
       skipping families with < min_residual_groups valid groups
    4. union outlier groups over families; remove ALL residuals of those
       landmarks (here: clear the selection mask — weights, not shapes)
    5. the trust region resets each round (trust_region_relaxation_factor=-10)
  finally: one refinement run with the full iteration budget.

The phase state (LM iteration, round budget, divergence-retry extension,
trim, refinement exit) is the reference package's single-loop state
machine, run as a Python loop. Tensors stay on the device; the loop reads
flags back to the host only on iterations where a phase decision needs
them (the last iteration of a trim round's budget, and every refinement
iteration): ``SolveInfo.n_host_syncs`` counts those reads.

Landmark-sharded (``axis`` = the model process group of
``parallel.sharding``): every count is summed over the shards, each trim
round gathers the three families' scores and masks of every shard in one
collective and trims the whole vectors as the unsharded solve does, and
each host read derives from reduced values and the replicated pose solve
only, so every rank takes the same branch and reaches the next
collective.

Diagnostics: :class:`SolveInfo` carries the merged-``Summary``/FullReport
equivalents (robust_solving.hpp:44-74; ``bundle_adjuster_keyframes.cpp:766``)
as fixed-shape tensors — per-round per-family trim counts and an
accept/reject trace with per-iteration costs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..robust import residuals_to_remove
from ..state import Selection, Window
from ..utils.collectives import all_gather_cat, all_reduce_sum, local_part
from ..utils.precision import full_f32
from ..utils.profiling import host_read, traced
from .ba_core import assemble, assembly_plan, compute_cost, residual_stats
from .lm import apply_step, select, solve_normal_equations


class SolveInfo(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    n_trimmed: torch.Tensor
    n_accepted: torch.Tensor
    # ---- Summary/FullReport parity (robust_solving.hpp:44-74) ----------
    n_iterations: int              # total LM iterations executed
    n_rounds: int                  # trim rounds completed
    trimmed_repr: torch.Tensor     # [R] per-round reprojection-family counts
    trimmed_depth: torch.Tensor    # [R]
    trimmed_gp: torch.Tensor       # [R]
    accept_trace: torch.Tensor     # [T] int8: 0 unused, 1 accepted, 2 rejected
    cost_trace: torch.Tensor       # [T] cost after each executed iteration
    n_host_syncs: int              # device→host flag reads of the loop


def trace_capacity(cfg) -> int:
    """Fixed length of the iteration-trace arrays for a given config."""
    rcfg, scfg = cfg.robust, cfg.solver
    return (rcfg.num_trim_iterations
            * scfg.diverged_retry_factor * rcfg.trim_iteration_lm_steps
            + scfg.refinement_iterations)


@traced("limo.solve_trimmed")
@full_f32
def solve_trimmed(window: Window, sel: Selection, rig, cfg,
                  compensate_rotation: bool = False, axis=None):
    """Full trimmed solve. Returns (window, selection, SolveInfo).

    ``compensate_rotation`` solves on RotRocc reprojection residuals (its
    cost, assembly and trim scores; the ``torch(rotation-compensated)``
    route of :func:`~.ba_core.assembly_plan`).

    The returned selection has trimmed landmarks removed (mask cleared) —
    mirroring the reference's permanent RemoveResidualBlock surgery. With
    ``axis`` the window and selection are one landmark shard, the result's
    landmark fields are the shard's and everything else (poses, planes,
    SolveInfo) is the same on every rank.
    """
    rcfg = cfg.robust
    scfg = cfg.solver
    dtype = window.poses.dtype
    device = window.poses.device
    mode = getattr(scfg, "motion_parameterization", "full_dof")
    # raises where no route exists
    assembly_plan(dtype, device, cfg, compensate_rotation)

    num_rounds = rcfg.num_trim_iterations
    budget = rcfg.trim_iteration_lm_steps
    budget_ext = scfg.diverged_retry_factor * budget
    refine_iters = scfg.refinement_iterations
    T = trace_capacity(cfg)
    R = max(num_rounds, 1)

    def sel_with(mask):
        return sel._replace(lm_selected=mask)

    def get_cost(w, mask):
        return compute_cost(w, sel_with(mask), rig, cfg,
                            compensate_rotation, axis=axis)

    def initial_lam():
        return torch.full((), scfg.initial_lambda, dtype=dtype, device=device)

    initial_cost = get_cost(window, sel.lm_selected)
    # trimming only engages with >100 selected landmarks (solve():741-746)
    (n_selected,) = all_reduce_sum(
        [(window.lm_valid & sel.lm_selected).sum(dtype=torch.int32)], axis)
    trim_active = n_selected > 100

    lm_selected = sel.lm_selected
    lam = initial_lam()
    cost = round_start_cost = initial_cost
    i32 = dict(dtype=torch.int32, device=device)
    n_trimmed = torch.zeros((), **i32)
    n_accepted = torch.zeros((), **i32)
    trimmed = {f: torch.zeros((R,), **i32) for f in ("repr", "depth", "gp")}
    accept_trace = torch.zeros((T,), dtype=torch.int8, device=device)
    cost_trace = torch.zeros((T,), dtype=dtype, device=device)
    it_in_round = it_total = round_idx = n_syncs = 0
    extended = done = False

    @traced("limo.trim")
    def trim(window, lm_selected):
        """One trim round: new selection, outlier count, family counts.
        Sharded, the families' scores and masks of every shard come in one
        gather: each family is trimmed on the whole vector, as unsharded,
        and the counts are global without another collective."""
        stats = residual_stats(window, sel_with(lm_selected), rig, cfg,
                               compensate_rotation, axis)
        # per-family TrimmerSpecification (apply_trimmer.hpp:29-45)
        fam = (
            (stats.repr_score, stats.repr_valid, rcfg.reprojection_trimmer,
             rcfg.reprojection_quantile, rcfg.reprojection_trim_fixed_thres),
            (stats.depth_score, stats.depth_valid, rcfg.depth_trimmer,
             rcfg.depth_quantile, rcfg.depth_trim_fixed_thres),
            (stats.gp_score, stats.gp_valid, rcfg.gp_trimmer,
             rcfg.gp_quantile, rcfg.gp_trim_fixed_thres),
        )
        rows = [x for score, valid, *_ in fam for x in (score, valid)]
        if axis is not None:
            rows = all_gather_cat(
                torch.stack([x.to(dtype) for x in rows]), axis, dim=1)
        out = [residuals_to_remove(
            rows[2 * f], rows[2 * f + 1] != 0, trimmer,
            quantile if trimmer == "quantile" else fixed_thres,
            rcfg.min_residual_groups) & trim_active
            for f, (_, _, trimmer, quantile, fixed_thres) in enumerate(fam)]
        outliers = out[0] | out[1] | out[2]
        counts = torch.stack([m.sum(dtype=torch.int32)
                              for m in (outliers, *out)])
        return lm_selected & ~local_part(outliers, axis), counts

    while not done and round_idx <= num_rounds:
        # ---- one LM iteration ------------------------------------------
        eqs = assemble(window, sel_with(lm_selected), rig, cfg,
                       compensate_rotation, axis=axis)
        delta_p, delta_l = solve_normal_equations(eqs, lam, axis)
        cand = apply_step(window, delta_p, delta_l, mode)
        new_cost = get_cost(cand, lm_selected)
        accept = torch.isfinite(new_cost) & (new_cost < cost)
        window = select(accept, cand, window)
        lam = torch.where(accept,
                          torch.clamp_min(lam * scfg.lambda_down,
                                          scfg.min_lambda),
                          torch.clamp_max(lam * scfg.lambda_up,
                                          scfg.max_lambda))
        rel_step = (cost - new_cost) / torch.clamp_min(cost, 1e-12)
        converged = accept & (rel_step < scfg.function_tolerance)
        cost = torch.where(accept, new_cost, cost)
        tcur = min(it_total, T - 1)
        accept_trace[tcur] = torch.where(accept, 1, 2).to(torch.int8)
        cost_trace[tcur] = cost
        n_accepted = n_accepted + accept.to(torch.int32)
        it_in_round += 1
        it_total += 1

        # ---- round bookkeeping -----------------------------------------
        in_refinement = round_idx >= num_rounds
        round_budget = (refine_iters if in_refinement
                        else budget_ext if extended else budget)
        at_budget = it_in_round >= round_budget
        if in_refinement:
            # refinement ends at budget, on convergence, or when hopeless
            done = at_budget
            if not done:
                n_syncs += 1
                done = host_read(converged | (lam >= scfg.max_lambda))
        elif at_budget:
            # divergence retry: trim rounds only (robust_solving.cpp:172-181)
            n_syncs += 1
            extend = not extended and not host_read(
                cost < round_start_cost)
            extended = extended or extend
            if not extend:
                lm_selected, counts = trim(window, lm_selected)
                n_trimmed = n_trimmed + counts[0]
                for f, n in zip(trimmed, counts[1:]):
                    trimmed[f][round_idx] = n
                cost = get_cost(window, lm_selected)
                round_idx += 1
                it_in_round = 0
                extended = False
                lam = initial_lam()      # TR reset per round
                round_start_cost = cost

    info = SolveInfo(initial_cost=initial_cost, final_cost=cost,
                     n_trimmed=n_trimmed, n_accepted=n_accepted,
                     n_iterations=it_total,
                     n_rounds=min(round_idx, num_rounds),
                     trimmed_repr=trimmed["repr"],
                     trimmed_depth=trimmed["depth"],
                     trimmed_gp=trimmed["gp"],
                     accept_trace=accept_trace, cost_trace=cost_trace,
                     n_host_syncs=n_syncs)
    return window, sel_with(lm_selected), info
