"""Robust losses and trimmed-least-squares primitives.

Replaces ``robust_optimization`` (trimmers: ``internal/trimmer_fix.hpp``,
``internal/trimmer_quantile.hpp``) and the Ceres loss functions used by the
reference (Cauchy for depth/reprojection, Huber for groundplane height —
``bundle_adjuster_keyframes.cpp:564-627,517-562``).

Losses enter the solver as IRLS weights ``rho'(s)`` applied to the
whitened residuals; trimming is a *mask update* over residual groups
(group = landmark), never a shape change.
"""

from __future__ import annotations

import torch

from .utils.collectives import all_gather_cat


def cauchy_weight(sq_norm, scale):
    """rho(s) = a^2 log(1 + s/a^2)  ⇒  rho'(s) = 1 / (1 + s/a^2)."""
    a2 = scale * scale
    return 1.0 / (1.0 + sq_norm / a2)


def huber_weight(sq_norm, delta):
    """Ceres HuberLoss(a): rho(s) = s for s<=a^2 else 2a√s − a^2
    ⇒ rho'(s) = min(1, a/√s)."""
    r = torch.sqrt(torch.clamp_min(sq_norm, 1e-20))
    return torch.clamp_max(delta / r, 1.0)


def trivial_weight(sq_norm, scale=None):
    return torch.ones_like(sq_norm)


LOSSES = {"cauchy": cauchy_weight, "huber": huber_weight,
          "trivial": trivial_weight}


def trim_fixed(scores, valid, threshold):
    """``TrimmerFix`` (trimmer_fix.hpp:36-47): score > threshold ⇒ outlier."""
    return valid & (scores > threshold)


def trim_quantile(scores, valid, quantile, axis=None):
    """``TrimmerQuantile`` (trimmer_quantile.hpp:44-67): nth_element at
    floor(N*quantile) of the *valid* scores; everything strictly above the
    pivot value is an outlier (q=0.9 ⇒ top ~10% rejected).

    Masked, fixed-shape and free of host syncs: invalid entries are pushed
    to +inf and excluded; the pivot is gathered on the device. With a
    landmark-sharded solve, ``axis`` is the model process group: the pivot
    comes from the scores and masks of every shard, gathered in rank order
    in one collective (the unsharded vector, so the same order and ties),
    and is applied to the local shard.
    """
    local = scores
    g_valid = valid
    if axis is not None:
        both = all_gather_cat(torch.stack([scores, valid.to(scores.dtype)]),
                              axis, dim=1)
        scores, g_valid = both[0], both[1] != 0
    n_valid = torch.sum(g_valid)
    masked = torch.where(g_valid, scores, torch.full_like(scores, torch.inf))
    sorted_scores = torch.sort(masked).values
    # reference: std::nth_element(begin, begin + quantile*size, end) then the
    # pivot *value* partitions; index = floor(q * n_valid), clipped. The
    # product is formed in the scores' dtype, as the reference package does:
    # in f32 it rounds, and the trim decision at the boundary follows it.
    idx = torch.clamp((quantile * n_valid.to(scores.dtype)).to(torch.int64),
                      0, scores.shape[0] - 1)
    pivot = sorted_scores.gather(0, idx.reshape(1))[0]
    return valid & (local > pivot)


def residuals_to_remove(scores, valid, trimmer_type, trimmer_param,
                        min_groups: int):
    """``getResidualsToRemove`` (robust_solving.cpp:100-125): skip trimming
    entirely when fewer than ``min_groups`` valid groups exist."""
    if trimmer_type == "fixed":
        out = trim_fixed(scores, valid, trimmer_param)
    elif trimmer_type == "quantile":
        out = trim_quantile(scores, valid, trimmer_param)
    else:
        raise ValueError(f"unknown trimmer {trimmer_type}")
    return out & (valid.sum() >= min_groups)
