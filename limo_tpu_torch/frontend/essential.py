"""Batched essential-matrix motion prior.

The reference package's ``limo_tpu/frontend/essential.py`` as PyTorch ops.
Reference contract: ``general_helpers.hpp:103-140`` (``calcMotion5Point``):
OpenCV ``findEssentialMat`` (5-point RANSAC, prob 0.999, thres 1 px) +
``recoverPose``, with a 3 px mean-flow standstill gate, then translation
rescaled by prior speed × Δt (``getMotionUnscaled`` :209-231).

RANSAC runs a fixed number H of hypotheses at once: minimal samples drawn
with the reference's counter hash (bit for bit), one batched minimal solve
over tensors of shape ``[H, …]``, Sampson scoring of every correspondence
against every candidate model in one product, the first candidate with the
most inliers, then a cheirality vote over the 4 (R, t) decompositions.

Two minimal solvers:

- ``method="5point"`` (default): per 5-point sample the epipolar nullspace
  is 4-dimensional (E = x·B0 + y·B1 + z·B2 + B3); the 10 cubic constraints
  restrict (x, y, z) to ≤ 10 solutions. The 10 equations, grouped by their
  10 (x,y)-monomials, form a 10×10 matrix M(z) cubic in z; det M(z) is a
  degree-10 polynomial, fitted in the Chebyshev basis from batched 10×10
  determinants at 24 nodes; its real roots come from a fixed grid and 45
  steps of bisection; (x, y) is the least-squares null vector of M(z_root).
  The constraint→coefficient map is extracted numerically through a
  precomputed inverse Vandermonde over 20 fixed points (exact for cubics).
- ``method="8point"``: the weighted DLT solve on 8-point samples (cheaper,
  degenerate on planar scenes).

The nullspace basis of a 5-point sample is not unique (any orthonormal
basis of the 4-dim nullspace is a valid answer), and LAPACK builds and
cuSOLVER may return different ones; each basis gives its own z-roots and
its own solution-loss cases (below). The port is therefore held to the
reference by results: the essential matrices a sample yields, and R, t,
``ok`` and the inliers of :func:`estimate_essential`.

KNOWN SOLUTION-LOSS MODES (per minimal sample; RANSAC amortises them):
real roots with |z| > ``_ZMAX`` are never seen; even-multiplicity roots
touch zero without a sign change on the grid; solutions whose E has a
vanishing B3 coefficient are unrepresentable in this pinning.

Every contraction runs in full f32 (TF32 off), as the reference pins the
highest matmul precision.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import pose as pose_ops
from ..geometry import quaternion as quat
from ..utils import uint32
from ..utils.precision import full_f32

# ---------------------------------------------------------------------------
# 5-point solver constants (numpy, built at import as the reference builds
# them)
# ---------------------------------------------------------------------------

# (x,y)-monomials in the order [x³, x²y, xy², y³, x², xy, y², x, y, 1];
# each full monomial (px,py,pz) has total degree ≤ 3
_XY_MONOS = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2),
             (1, 0), (0, 1), (0, 0)]
_MONOS20 = [(px, py, pz) for (px, py) in _XY_MONOS
            for pz in range(0, 4 - px - py)]
assert len(_MONOS20) == 20

# sample points for numeric coefficient extraction (seed chosen for
# Vandermonde conditioning ≈ 64)
_P20 = np.random.default_rng(392).uniform(-1, 1, (20, 3))
_VAND_INV = np.linalg.inv(np.array(
    [[x ** px * y ** py * z ** pz for (px, py, pz) in _MONOS20]
     for (x, y, z) in _P20]))                               # [20,20]
# monomial → (z-degree, xy-monomial index) embedding tensor [20,4,10]
_EMBED = np.zeros((20, 4, 10))
for _m, (_px, _py, _pz) in enumerate(_MONOS20):
    _EMBED[_m, _pz, _XY_MONOS.index((_px, _py))] = 1.0

# det-polynomial recovery: degree-10 in z, fit in Chebyshev basis over
# [-_ZMAX, _ZMAX] from _NS node evaluations; roots located on a fixed grid
_ZMAX = 6.0
_NS = 24
_NG = 257
_DEG = 10
_BISECT_STEPS = 45


def _cheb_design(z_over_zmax: np.ndarray, deg: int) -> np.ndarray:
    T = [np.ones_like(z_over_zmax), z_over_zmax]
    for _ in range(deg - 1):
        T.append(2.0 * z_over_zmax * T[-1] - T[-2])
    return np.stack(T[:deg + 1], axis=-1)


_ZNODES = np.cos(np.pi * (np.arange(_NS) + 0.5) / _NS) * _ZMAX
_CHEB_FIT = np.linalg.pinv(_cheb_design(_ZNODES / _ZMAX, _DEG))  # [11,_NS]
_ZGRID = np.linspace(-_ZMAX, _ZMAX, _NG)
_CHEB_GRID = _cheb_design(_ZGRID / _ZMAX, _DEG)                  # [_NG,11]

_CONSTANTS: dict = {}


def _constants(dtype, device):
    """The solver's numpy constants as tensors, uploaded once per (dtype,
    device)."""
    key = (dtype, str(device))
    if key not in _CONSTANTS:
        on = lambda a: torch.from_numpy(np.asarray(a, np.float64)).to(
            device=device, dtype=dtype)
        _CONSTANTS[key] = {
            "p20": on(_P20), "vand_inv": on(_VAND_INV), "embed": on(_EMBED),
            "znodes": on(_ZNODES), "cheb_fit": on(_CHEB_FIT),
            "zgrid": on(_ZGRID), "cheb_grid": on(_CHEB_GRID),
            "W": on([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])}
    return _CONSTANTS[key]


class EssentialResult(NamedTuple):
    q: torch.Tensor           # [4] rotation cam0→cam1 (wxyz)
    t: torch.Tensor           # [3] unit translation
    inliers: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor   # int
    ok: torch.Tensor          # bool — enough flow + enough inliers


def _hash2(i, j):
    """The reference's uint32 hash of (i, j), on int64 in [0, 2^32)."""
    x = uint32.mul(i, 0x9E3779B9) ^ uint32.mul(j, 0x85EBCA6B)
    x = uint32.mul(x ^ (x >> 16), 0x7FEB352D)
    x = uint32.mul(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _homogeneous(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _epipolar_rows(x0, x1):
    """Rows of the DLT system x1ᵀ E x0 = 0 for normalized coords [..., M, 2]."""
    u0, v0 = x0[..., 0], x0[..., 1]
    u1, v1 = x1[..., 0], x1[..., 1]
    return torch.stack([u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0,
                        torch.ones_like(u0)], dim=-1)


def _eight_point(x0, x1, w):
    """Weighted 8-point estimate of E from normalized coords, batched.

    x0, x1: [..., M, 2]; w: [..., M] 0/1 sample weights. Returns E [..., 3, 3]
    with the essential singular-value structure enforced."""
    A = _epipolar_rows(x0, x1) * w[..., None]
    # the right singular vectors are all 9 whatever M is: full matrices
    # only where M < 9 (a full U of a 1536-row system is 1536 × 1536)
    _, _, Vt = torch.linalg.svd(A, full_matrices=A.shape[-2] < 9)
    E = Vt[..., -1, :].reshape(Vt.shape[:-2] + (3, 3))
    U, S, Vt2 = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) / 2.0
    diag = torch.stack([s, s, torch.zeros_like(s)], -1)
    return (U * diag[..., None, :]) @ Vt2


def _sampson_sq(E, x0, x1):
    """Squared Sampson distance of correspondences [N,2] to the epipolar
    geometry of E [..., 3, 3]; returns [..., N]."""
    p0, p1 = _homogeneous(x0), _homogeneous(x1)
    Ex0 = p0 @ E.transpose(-1, -2)                      # [..., N, 3]
    Etx1 = p1 @ E                                       # [..., N, 3]
    num = torch.sum(p1 * Ex0, -1) ** 2
    den = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 \
        + Etx1[..., 1] ** 2
    return num / torch.clamp_min(den, 1e-12)


def _essential_constraints(E):
    """The 10 cubic constraints a valid essential matrix satisfies:
    det(E) = 0 and 2·E·Eᵀ·E − tr(E·Eᵀ)·E = 0 (Nistér 2004, eq. 4-5).
    E [..., 3, 3] → [..., 10]."""
    EEt = E @ E.transpose(-1, -2)
    tr = EEt.diagonal(dim1=-2, dim2=-1).sum(-1)
    T = 2.0 * (EEt @ E) - tr[..., None, None] * E
    return torch.cat([torch.linalg.det(E)[..., None],
                      T.reshape(T.shape[:-2] + (9,))], -1)


def _cheb_eval(coefs, z_over_zmax):
    """Evaluate Chebyshev series (Clenshaw): coefs [..., 11] at z [..., R]."""
    b1 = torch.zeros_like(z_over_zmax)
    b2 = torch.zeros_like(z_over_zmax)
    for i in range(coefs.shape[-1] - 1, 0, -1):
        b1, b2 = 2.0 * z_over_zmax * b1 - b2 + coefs[..., i, None], b1
    return z_over_zmax * b1 - b2 + coefs[..., 0, None]


def _m_at(Mc, z):
    """M(z) = Mc0 + z·Mc1 + z²·Mc2 + z³·Mc3 for Mc [H,4,10,10], z [H,R]
    → [H,R,10,10]."""
    z = z[..., None, None]
    return (Mc[:, None, 0] + z * Mc[:, None, 1] + (z * z) * Mc[:, None, 2]
            + (z * z * z) * Mc[:, None, 3])


def _nullspace_basis(x0s, x1s):
    """An orthonormal basis B0..B3 [H,4,3,3] of the epipolar nullspace of H
    5-point samples x0s, x1s [H,5,2] (not unique: see the module
    docstring)."""
    A = _epipolar_rows(x0s, x1s)                          # [H,5,9]
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    return Vt[:, 5:9].reshape(-1, 4, 3, 3)


def _five_point_one(x0s, x1s):
    """All essential-matrix solutions of H 5-point minimal samples at once.

    x0s, x1s: [H,5,2] normalized coords. Returns (Es [H,10,3,3], valid
    [H,10]) in the coords' type. See the module docstring for the method."""
    return _solutions(_nullspace_basis(x0s, x1s))


def _solutions(basis):
    """The ≤ 10 solutions E = x·B0 + y·B1 + z·B2 + B3 (Frobenius-normalized)
    of each nullspace basis [H,4,3,3], in the basis's type: (Es [H,10,3,3],
    valid [H,10])."""
    dtype = basis.dtype
    c = _constants(dtype, basis.device)
    # constraint polynomials via numeric evaluation at the 20 fixed points
    pts = c["p20"]                                        # [20,3]
    B = basis[:, None]                                    # [H,1,4,3,3]
    Es = (pts[:, 0, None, None] * B[:, :, 0] + pts[:, 1, None, None]
          * B[:, :, 1] + pts[:, 2, None, None] * B[:, :, 2] + B[:, :, 3])
    Q = _essential_constraints(Es)                        # [H,20 pts,10 eqs]
    C = c["vand_inv"] @ Q                                 # [H,20 monos,10]
    # M(z) = Mc[0] + z·Mc[1] + z²·Mc[2] + z³·Mc[3], rows = equations,
    # columns = (x,y)-monomials
    Mc = torch.einsum("hme,mzk->hzek", C, c["embed"])     # [H,4,10,10]

    # det M(z) at the Chebyshev nodes → degree-10 Chebyshev fit
    H = basis.shape[0]
    Ms = _m_at(Mc, c["znodes"].expand(H, -1))             # [H,24,10,10]
    dets = torch.linalg.det(Ms)                           # [H,24]
    dets = dets / torch.clamp_min(dets.abs().amax(-1, keepdim=True), 1e-30)
    coefs = dets @ c["cheb_fit"].T                        # [H,11]

    # real roots: grid sign changes + bisection (fixed shapes throughout)
    g = coefs @ c["cheb_grid"].T                          # [H,_NG]
    change = g[:, :-1] * g[:, 1:] < 0                     # [H,_NG-1]
    idx = torch.argsort((~change).to(torch.uint8), dim=-1,
                        stable=True)[:, :10]              # first ≤10 brackets
    valid = torch.gather(change, 1, idx)
    zg = c["zgrid"]
    lo, hi = zg[idx], zg[idx + 1]
    flo = _cheb_eval(coefs, lo / _ZMAX)
    for _ in range(_BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        fm = _cheb_eval(coefs, mid / _ZMAX)
        left = flo * fm <= 0
        lo, hi, flo = (torch.where(left, lo, mid), torch.where(left, mid, hi),
                       torch.where(left, flo, fm))
    roots = 0.5 * (lo + hi)                               # [H,10]

    # back-substitute (x, y): least-squares null vector of M(z_root) with
    # the constant monomial pinned to 1 (monomial order: x³ x²y xy² y³ x²
    # xy y² x y 1 → x = m[7], y = m[8])
    M = _m_at(Mc, roots)                                  # [H,10,10,10]
    A1 = M[..., :9]
    b = -M[..., 9]
    A1t = A1.transpose(-1, -2)
    G = A1t @ A1                                          # [H,10,9,9]
    trG = G.diagonal(dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(9, dtype=dtype, device=basis.device)
    u, _ = torch.linalg.solve_ex(G + 1e-10 * trG[..., None, None] * eye,
                                 (A1t @ b[..., None])[..., 0])
    xs, ys = u[..., 7], u[..., 8]
    E_roots = (xs[..., None, None] * basis[:, None, 0]
               + ys[..., None, None] * basis[:, None, 1]
               + roots[..., None, None] * basis[:, None, 2]
               + basis[:, None, 3])                       # [H,10,3,3]
    fro = torch.linalg.matrix_norm(E_roots, keepdim=True)
    E_roots = E_roots / torch.clamp_min(fro, 1e-12)
    return E_roots, valid


def _decompose(E):
    """Four (R, t) candidates from E (Hartley-Zisserman)."""
    U, _, Vt = torch.linalg.svd(E)
    # enforce proper rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = _constants(E.dtype, E.device)["W"]
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _cheirality_depths(R, t, x0, x1):
    """Two-view depths (z0, z1) per correspondence for candidates (R [...,3,3],
    t [...,3]) by linear triangulation along the rays; returns [..., N]."""
    f0, f1 = _homogeneous(x0), _homogeneous(x1)
    a = f0 @ R.transpose(-1, -2)                         # R f0, [..., N, 3]
    b = -f1
    mt = -t[..., None, :]
    # normal equations of [a b] [z0 z1]ᵀ = -t
    aa = torch.sum(a * a, -1)
    ab = torch.sum(a * b, -1)
    bb = torch.sum(b * b, -1)
    at = torch.sum(a * mt, -1)
    bt = torch.sum(b * mt, -1)
    det = aa * bb - ab * ab
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    z0 = (at * bb - ab * bt) / det
    z1 = (aa * bt - ab * at) / det
    return z0, z1


def _draw_samples(match_mask, num_hypotheses: int, sample_size: int,
                  seed: int = 0):
    """H minimal samples of valid correspondences [H, sample_size]: the
    reference's hash of (hypothesis + 7919·seed, pick) modulo the number of
    valid matches, an index into the matches compacted valid-first."""
    dev = match_mask.device
    hyp = torch.arange(num_hypotheses, device=dev)
    pick = torch.arange(sample_size, device=dev)
    valid_idx = torch.argsort((~match_mask).to(torch.uint8), stable=True)
    n_valid = torch.clamp_min(match_mask.sum(), 1)
    r = _hash2((hyp[:, None] + seed * 7919) & uint32.MASK, pick[None, :])
    return valid_idx[r % n_valid]


@full_f32
def estimate_essential(uv0, uv1, match_mask, focal, principal,
                       num_hypotheses: int = 256,
                       thres_px: float = 1.0,
                       min_flow_px: float = 3.0,
                       seed: int = 0,
                       method: str = "5point",
                       q_guess=None,
                       vote_margin: float = 0.8) -> EssentialResult:
    """Full motion-prior estimate from matched pixel coordinates.

    uv0, uv1: [N,2] matched points in frames 0 (older) and 1 (newer);
    returns the motion of frame1 relative to frame0 as (q, t) such that
    ``x_cam1 = R x_cam0 + t`` (OpenCV recoverPose convention).

    q_guess (optional [4] wxyz, CAMERA frame): rotation prior for the
    recoverPose step. On a dominant-plane scene the essential matrix has a
    two-fold (R, t) ambiguity; with a guess, the candidates whose vote is
    within ``vote_margin`` of the best form the ambiguous set and the
    member closest in rotation to the guess wins; a candidate that truly
    dominates the vote is never overridden.
    """
    dtype, dev = uv0.dtype, uv0.device
    H = num_hypotheses
    focal = torch.as_tensor(focal, dtype=dtype, device=dev)
    principal = torch.as_tensor(principal, dtype=dtype, device=dev)
    x0 = (uv0 - principal) / focal
    x1 = (uv1 - principal) / focal
    norm_thres_sq = (thres_px / focal) ** 2

    # standstill gate (general_helpers.hpp:111-124)
    flow = torch.linalg.vector_norm(uv1 - uv0, dim=-1)
    nm = torch.clamp_min(match_mask.sum(), 1)
    mean_flow = torch.sum(torch.where(match_mask, flow,
                                      torch.zeros_like(flow))) / nm
    moving = mean_flow >= min_flow_px

    sample = _draw_samples(match_mask, H, 5 if method == "5point" else 8,
                           seed)

    if method == "5point":
        Es, ok_h = _five_point_one(x0[sample], x1[sample])
        Es = Es.reshape(-1, 3, 3)                        # [H*10,3,3]
        cand_ok = ok_h.reshape(-1)
    elif method == "8point":
        Es = _eight_point(x0[sample], x1[sample],
                          torch.ones((H, 8), dtype=dtype, device=dev))
        cand_ok = torch.ones((H,), dtype=torch.bool, device=dev)
    else:
        raise ValueError(f"unknown essential method {method!r}")

    # --- score all candidate models ----------------------------------------
    d = _sampson_sq(Es, x0, x1)                          # [cands,N]
    inl = (d < norm_thres_sq) & match_mask[None, :] & cand_ok[:, None]
    counts = inl.sum(dim=1)
    best = torch.argmax(counts)
    E = Es[best]

    if method == "8point":
        # refine on the best inlier set (one weighted 8-point re-solve); the
        # minimal 5-point model already lies on the essential manifold, and
        # a DLT re-solve would re-degenerate on planar scenes
        E = _eight_point(x0, x1, inl[best].to(dtype))
    inliers = (_sampson_sq(E, x0, x1) < norm_thres_sq) & match_mask

    # --- recoverPose: cheirality vote over 4 decompositions ----------------
    Rs, ts = _decompose(E)
    z0, z1 = _cheirality_depths(Rs, ts, x0, x1)          # [4,N]
    votes = ((z0 > 0) & (z1 > 0) & inliers).to(torch.int32).sum(-1)
    if q_guess is None:
        k = torch.argmax(votes)
    else:
        ang = quat.qangle(quat.qfrom_matrix(Rs), q_guess.to(dtype))
        vmax = votes.max()
        ambiguous = votes.to(dtype) >= vote_margin * vmax.to(dtype)
        k = torch.argmin(torch.where(ambiguous, ang,
                                     torch.full_like(ang, torch.inf)))
    R, t = Rs[k], ts[k]
    q = quat.qfrom_matrix(R)

    n_in = inliers.to(torch.int32).sum()
    # counts[best] > 0 gates on candidate validity: if every candidate
    # failed, argmax picks index 0, whose E is garbage
    ok = moving & (n_in >= 8) & (counts[best] > 0)
    # standstill → identity motion (reference fallback :111-124)
    q = torch.where(ok, q, quat.qidentity(dtype, dev))
    t = torch.where(ok, t, torch.zeros_like(t))
    return EssentialResult(q=q, t=t, inliers=inliers & ok, n_inliers=n_in,
                           ok=ok)


def motion_prior_unscaled(result: EssentialResult, T_cam_veh,
                          speed, dt):
    """``getMotionUnscaled`` (general_helpers.hpp:209-231): scale the unit
    translation by speed·Δt and conjugate camera motion into the vehicle
    frame. Returns pose delta T_cur_prev (vehicle frame, cur←prev)."""
    scale = speed * dt
    motion_cam = pose_ops.make(result.q, result.t * scale)
    Tcv = T_cam_veh
    Tvc = pose_ops.inverse(Tcv)
    return pose_ops.compose(Tvc, pose_ops.compose(motion_cam, Tcv))
