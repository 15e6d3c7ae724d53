"""Batched cyclic-Jacobi eigensolver for symmetric 3×3 matrices.

The reference package's ``limo_tpu/utils/eig3.py`` as PyTorch ops: six
fully unrolled sweeps of three two-sided rotations, elementwise over any
leading shape, so the result does not depend on a library's ``eigh``. For
(near) positive-definite matrices Jacobi computes the small eigenvalues and
their vectors to high relative accuracy, which the ground-plane fits (an
eigenvalue spread of ~1e7: tens of metres of extent against centimetres of
thickness) need in float32.
"""

from __future__ import annotations

import torch


def _rot(a_pp, a_qq, a_pq):
    """Jacobi rotation (c, s) annihilating a_pq (Golub & Van Loan §8.5.2,
    the numerically stable small-root formula)."""
    one = torch.ones_like(a_pq)
    tau = (a_qq - a_pp) / (2.0 * torch.where(a_pq == 0.0, one, a_pq))
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, one, t)           # tau==0 → 45° rotation
    t = torch.where(a_pq == 0.0, torch.zeros_like(t), t)  # already diagonal
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c, t


def jacobi_eigh3(A, sweeps: int = 6):
    """Eigendecomposition of symmetric 3×3 matrices, batched.

    A [..., 3, 3] (symmetric part is used). Returns (evals [..., 3]
    ascending, V [..., 3, 3] with COLUMNS as eigenvectors, so
    ``V[..., :, 0]`` is the smallest-eigenvalue eigenvector).
    """
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = 0.5 * (A[..., 0, 1] + A[..., 1, 0])
    a02 = 0.5 * (A[..., 0, 2] + A[..., 2, 0])
    a12 = 0.5 * (A[..., 1, 2] + A[..., 2, 1])
    one = torch.ones_like(a00)
    zero = torch.zeros_like(a00)
    V = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]  # V[i][j]

    def rotate_cols(V, p, q, c, s):
        for i in range(3):
            vp, vq = V[i][p], V[i][q]
            V[i][p] = c * vp - s * vq
            V[i][q] = s * vp + c * vq

    for _ in range(sweeps):
        # pair (0,1); diagonal update in the relatively accurate form
        c, s, t = _rot(a00, a11, a01)
        a00, a11 = a00 - t * a01, a11 + t * a01
        a01 = zero
        b02 = c * a02 - s * a12
        a12 = s * a02 + c * a12
        a02 = b02
        rotate_cols(V, 0, 1, c, s)
        # pair (0,2)
        c, s, t = _rot(a00, a22, a02)
        a00, a22 = a00 - t * a02, a22 + t * a02
        a02 = zero
        b01 = c * a01 - s * a12
        a12 = s * a01 + c * a12
        a01 = b01
        rotate_cols(V, 0, 2, c, s)
        # pair (1,2)
        c, s, t = _rot(a11, a22, a12)
        a11, a22 = a11 - t * a12, a22 + t * a12
        a12 = zero
        b01 = c * a01 - s * a02
        a02 = s * a01 + c * a02
        a01 = b01
        rotate_cols(V, 1, 2, c, s)

    evals = torch.stack([a00, a11, a22], -1)                     # [...,3]
    Vm = torch.stack([torch.stack(row, -1) for row in V], -2)    # [...,3,3]
    order = torch.argsort(evals, dim=-1, stable=True)
    evals = torch.take_along_dim(evals, order, dim=-1)
    Vm = torch.take_along_dim(Vm, order[..., None, :], dim=-1)
    return evals, Vm


def smallest_eigvec3(A, sweeps: int = 6):
    """(evals ascending [...,3], unit eigenvector of the smallest eigenvalue
    [...,3])."""
    evals, V = jacobi_eigh3(A, sweeps=sweeps)
    return evals, V[..., :, 0]
