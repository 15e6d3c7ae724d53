"""Levenberg-Marquardt driver with per-landmark Schur elimination.

Replaces ``ceres::Solve`` (LM + DENSE_SCHUR, ``robust_solving.hpp:93-108``):

  1. assemble masked normal equations (ba_core.assemble)
  2. damp:  H' = H + λ·diag(H) (Marquardt scaling), both the landmark blocks
     V and the reduced pose/plane block
  3. Schur: S = H_pp − Σ_l W_l V_l⁻¹ W_lᵀ  (batched 3×3 inverses + one product)
  4. dense-solve S δp = rhs (P = 10K ≈ 200, same as Ceres' reduced system)
  5. back-substitute δl = V⁻¹(b_l − Wᵀ δp)
  6. accept/reject on robust cost; λ ↓ on accept, ↑ on reject (classic LM,
     mirroring Ceres' trust-region expand/shrink behavior)

Every contraction runs in full f32 on the card (utils/precision.py).

Landmark-sharded (``axis`` = the model process group): each rank holds its
shard's landmark blocks, the reduced system comes out of ``assemble``
summed, and the Schur correction is summed with ONE ``all_reduce`` per LM
iteration; the pose solve is replicated (the same inputs on every rank
give the same step) and the back-substitution stays on the shard.
"""

from __future__ import annotations

import torch

from ..geometry import pose as pose_ops
from ..state import Selection, Window
from ..utils.collectives import all_reduce_sum
from ..utils.precision import full_f32
from ..utils.profiling import host_read, traced
from .ba_core import PD, assemble, compute_cost, plane_boxplus


def _inv3(V):
    """Batched analytic 3x3 inverse via adjugate."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 0], V[..., 1, 1], V[..., 1, 2]
    g, h, i = V[..., 2, 0], V[..., 2, 1], V[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], -1),
    ], -2)
    return adj / det[..., None, None]


def _apply_vinv(Vinv, X):
    """X·Vinv over the last axis, as elementwise broadcasting arithmetic.
    X [L,...,3], Vinv [L,3,3] → [L,...,3]."""
    nb = X.dim() - 2
    Vb = Vinv.reshape(Vinv.shape[:1] + (1,) * nb + (3, 3))
    return (X[..., 0:1] * Vb[..., 0, :]
            + X[..., 1:2] * Vb[..., 1, :]
            + X[..., 2:3] * Vb[..., 2, :])


@traced("limo.schur_solve")
@full_f32
def solve_normal_equations(eqs, lam, axis=None):
    """Damped Schur solve → (delta_p [P], delta_l [L,3]).

    S = H_pp − W·V⁻¹·Wᵀ cancels almost exactly on weakly constrained dims
    (mono scale), so it runs in full f32 (TF32 off). A failed Cholesky
    factorization or a non-finite step gives a FULLY zero step, which the
    LM loop rejects and retries with a larger λ — the trust-region response
    to an indefinite system."""
    dtype = eqs.H_pp.dtype
    P = eqs.H_pp.shape[0]
    L = eqs.W6.shape[0]
    eye3 = torch.eye(3, dtype=dtype, device=eqs.V.device)
    # Marquardt damping on diagonals (with absolute floor for flat dims)
    diag_p = torch.diagonal(eqs.H_pp)
    H_pp = eqs.H_pp + torch.diag(lam * torch.clamp_min(diag_p, 1e-6))
    # keep fixed dims well-posed: unit diagonal where masked out
    H_pp = H_pp + torch.diag(1.0 - eqs.param_mask)
    Vdiag = torch.diagonal(eqs.V, dim1=-2, dim2=-1)
    V = eqs.V + (lam * torch.clamp_min(Vdiag, 1e-6))[..., None] * eye3
    Vinv = _inv3(V)

    # ---- Schur complement -----------------------------------------------
    # Augmented Gram form: with Wb = [W | b_l], G = (Wb Vinv) Wbᵀ gives the
    # S correction, its rhs, AND the rhs·Vinv·rhs scalar in ONE product.
    # W6 [L,K,6,3] pose blocks + Wp [L,4,3] plane block routed by gp_oh.
    Wfull = torch.cat([
        eqs.W6, eqs.gp_oh[:, :, None, None] * eqs.Wp[:, None, :, :]], dim=2)
    Wb = torch.cat([Wfull.reshape(L, P, 3), eqs.b_l[:, None, :]],
                   dim=1)                                       # [L,P+1,3]
    WbV = _apply_vinv(Vinv, Wb)
    G = torch.einsum("lpi,lqi->pq", WbV, Wb)                    # [P+1,P+1]
    (corr,) = all_reduce_sum([G[:P, :P + 1]], axis)             # S | rhs
    S = H_pp - corr[:, :P]
    rhs = eqs.b_p - corr[:, P]

    # dense solve of the reduced system (P ≈ 200); cholesky_ex reports a
    # failed factorization in `info` instead of raising (no host sync)
    S = 0.5 * (S + S.T)
    chol, info = torch.linalg.cholesky_ex(S)
    delta_p = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    bad = (info != 0) | ~torch.all(torch.isfinite(delta_p))
    delta_p = torch.where(bad, torch.zeros_like(delta_p), delta_p)
    delta_p = delta_p * eqs.param_mask

    # back-substitution (elementwise Vinv application; one matvec)
    wtdp = torch.einsum("lpi,p->li", Wb[:, :P], delta_p)
    delta_l = _apply_vinv(Vinv, eqs.b_l - wtdp)
    # a failed Cholesky must yield a FULLY zero candidate: with only delta_p
    # zeroed, delta_l = V⁻¹ b_l is a landmark-only move from an indefinite
    # system that can strictly decrease cost, get ACCEPTED, and drive λ down
    delta_l = torch.where(bad, torch.zeros_like(delta_l), delta_l)
    delta_l = delta_l * eqs.lm_mask[:, None]
    return delta_p, delta_l


@traced("limo.apply_step")
def apply_step(window: Window, delta_p, delta_l,
               motion_parameterization: str = "full_dof") -> Window:
    K = window.K
    d = delta_p.reshape(K, PD)
    d6 = d[:, :6]
    if motion_parameterization != "full_dof":
        # reduced coordinates → full tangent via the per-keyframe basis
        # (must match the projection applied in assemble)
        B, _ = pose_ops.tangent_basis(window.poses, motion_parameterization)
        d6 = torch.einsum("kij,kj->ki", B, d6)
    new_poses = pose_ops.boxplus(window.poses, d6)
    new_planes = plane_boxplus(window.planes, d[:, 6:])
    return window._replace(
        poses=pose_ops.normalize(new_poses),
        planes=new_planes,
        lm_pos=window.lm_pos + delta_l,
    )


def select(accept, cand: Window, old: Window) -> Window:
    """Masked accept/reject: ``torch.where(accept, cand, old)`` per field."""
    return Window(*[torch.where(accept, b, a) for a, b in zip(old, cand)])


@full_f32
def run_lm(window: Window, sel: Selection, rig, cfg, max_iters: int,
           compensate_rotation: bool = False, pose_only: bool = False,
           speed_reg=None, initial_lambda=None, axis=None):
    """Run up to ``max_iters`` accepted+rejected LM steps. Returns
    (window, final_cost, final_lambda, n_accepted).

    ``compensate_rotation``, ``pose_only`` and ``speed_reg`` are
    :func:`~.ba_core.assemble`'s modes (the windowed motion-only solve:
    ``pose_only=True`` with the speed regularizer); the loop starts from
    ``initial_lambda`` (default ``cfg.solver.initial_lambda``). The loop
    reads one flag back to the host per iteration (``done``); it derives
    from reduced costs alone, so with ``axis`` every rank reads the same
    flag."""
    scfg = cfg.solver
    mode = getattr(scfg, "motion_parameterization", "full_dof")
    modes = dict(compensate_rotation=compensate_rotation, pose_only=pose_only,
                 speed_reg=speed_reg, axis=axis)
    cost = compute_cost(window, sel, rig, cfg, **modes)
    lam0 = scfg.initial_lambda if initial_lambda is None else initial_lambda
    kw = dict(dtype=window.poses.dtype, device=window.poses.device)
    lam = (lam0.to(**kw) if torch.is_tensor(lam0)
           else torch.full((), lam0, **kw))
    n_accepted = torch.zeros((), dtype=torch.int32, device=lam.device)
    for _ in range(int(max_iters)):
        # one full assembly for the step; candidate judged by cost only
        eqs = assemble(window, sel, rig, cfg, **modes)
        delta_p, delta_l = solve_normal_equations(eqs, lam, axis)
        cand = apply_step(window, delta_p, delta_l, mode)
        new_cost = compute_cost(cand, sel, rig, cfg, **modes)
        accept = torch.isfinite(new_cost) & (new_cost < cost)
        window = select(accept, cand, window)
        rel_decrease = (cost - new_cost) / torch.clamp_min(cost, 1e-12)
        converged = accept & (rel_decrease < scfg.function_tolerance)
        stuck = (~accept) & (lam >= scfg.max_lambda)
        lam = torch.where(accept,
                          torch.clamp_min(lam * scfg.lambda_down,
                                          scfg.min_lambda),
                          torch.clamp_max(lam * scfg.lambda_up,
                                          scfg.max_lambda))
        cost = torch.where(accept, new_cost, cost)
        n_accepted = n_accepted + accept.to(torch.int32)
        if host_read(converged | stuck):
            break
    return window, cost, lam, n_accepted
