"""Keyframe selection for one incoming frame.

Reference: ``keyframe_selector.{hpp,cpp}`` — three scheme lists (rejection,
selection, sparsification) applied in order; a frame becomes a keyframe iff
(selected ∨ sparsification-passed) ∧ ¬rejected
(``keyframe_selector.cpp:107-133``).

These run per incoming frame on scalars and small tensors, inside the scan
step; nothing here reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import quaternion as quat


class KeyframeDecision(NamedTuple):
    is_keyframe: torch.Tensor   # bool
    rejected: torch.Tensor      # bool (standstill)
    selected: torch.Tensor      # bool (forced, e.g. curve)
    sparsified: torch.Tensor    # bool (time-based keep)


def mean_flow(uv_new, uv_last, match_mask):
    """Mean pixel displacement of shared tracks between the candidate frame
    and the last keyframe (``KeyframeRejectionSchemeFlow``,
    keyframe_rejection_scheme_flow.cpp:9-66 — name says median, reference
    computes the mean; we reproduce the mean). Returns (flow, n_matches)."""
    diff = uv_new - uv_last
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    n_matches = torch.sum(match_mask)
    n = torch.clamp_min(n_matches, 1)
    return torch.sum(torch.where(match_mask, d, torch.zeros_like(d))) / n, \
        n_matches


def select_keyframe(uv_new, uv_last_kf, match_mask,
                    q_new, q_last_kf,
                    ts_new, ts_last_kf, cfg) -> KeyframeDecision:
    """Apply flow-rejection, pose-difference selection, and time
    sparsification in the reference's union/veto combination."""
    ks = cfg.keyframe_selection
    flow, n_matches = mean_flow(uv_new, uv_last_kf, match_mask)
    # reject on standstill; with no matches the scheme cannot judge → keep
    rejected = (n_matches > 0) & (flow < ks.min_median_flow)
    angle = quat.qangle(q_new, q_last_kf)
    selected = angle > ks.critical_quaternion_difference
    sparsified = (ts_new - ts_last_kf) > ks.time_between_keyframes_sec
    is_kf = (selected | sparsified) & (~rejected)
    return KeyframeDecision(is_keyframe=is_kf, rejected=rejected,
                            selected=selected, sparsified=sparsified)
