"""Keyframe selection for one incoming frame.

Reference: ``keyframe_selector.{hpp,cpp}`` — three scheme lists (rejection,
selection, sparsification) applied in order; a frame becomes a keyframe iff
(selected ∨ sparsification-passed) ∧ ¬rejected
(``keyframe_selector.cpp:107-133``).

These run per incoming frame on scalars and small tensors, inside the scan
step; nothing here reads a value back to the host. :func:`select_keyframes`
runs the same schemes over a frame list (burst ingest), a plain loop over
the frames with the reference's carry.
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


def select_keyframes(stamps, uvs, valid, quats,
                     uv_last_kf, valid_last_kf, q_last_kf, ts_last_kf,
                     has_last_kf, cfg) -> torch.Tensor:
    """Candidate-frame-SET selection — ``KeyframeSelector::select`` over a
    frame list (keyframe_selector.cpp:107-133), for burst ingest.

    The reference runs three independent passes over the candidate list,
    each with its own accumulator of frames accepted by that pass
    (``applyRejectionScheme``/``applySelectionScheme``,
    keyframe_selector.cpp:34-88): rejection accumulates every non-rejected
    frame, selection accumulates selection-pass keeps, sparsification
    accumulates sparsification-pass keeps; every scheme compares against
    the newest-timestamp frame of the buffer AND of its pass accumulator
    (usable vs both for rejection/sparsification, vs either for
    selection). The final set is (selected ∨ sparsified) ∧ ¬rejected.

    stamps [F], uvs [F,R,2] (track-row-aligned across frames), valid [F,R],
    quats [F,4]; ``uv_last_kf``/``valid_last_kf``/``q_last_kf``/
    ``ts_last_kf`` describe the newest already-selected keyframe and
    ``has_last_kf`` whether one exists. Returns accepted [F] bool.
    """
    ks = cfg.keyframe_selection
    has_last_kf = torch.as_tensor(has_last_kf, device=stamps.device)
    false = torch.zeros((), dtype=torch.bool, device=stamps.device)
    uv_r, v_r, has_r = torch.zeros_like(uvs[0]), torch.zeros_like(valid[0]), \
        false
    q_s, has_s = quat.qidentity(quats.dtype, quats.device), false
    ts_p, has_p = torch.zeros_like(stamps[0]), false
    accepted = []
    for ts, uv, v, q in zip(stamps, uvs, valid, quats):
        # --- rejection pass (flow): usable vs buffer AND vs the newest
        # non-rejected frame of this batch; empty set → usable
        flow_b, n_b = mean_flow(uv, uv_last_kf, v & valid_last_kf)
        flow_r, n_r = mean_flow(uv, uv_r, v & v_r)
        rej_b = has_last_kf & (n_b > 0) & (flow_b < ks.min_median_flow)
        rej_r = has_r & (n_r > 0) & (flow_r < ks.min_median_flow)
        rejected = rej_b | rej_r
        keep_r = ~rejected
        uv_r = torch.where(keep_r, uv, uv_r)
        v_r = torch.where(keep_r, v, v_r)
        has_r = has_r | keep_r

        # --- selection pass (pose angle): usable vs EITHER set; empty
        # set → not usable (scheme_pose.cpp:22-24)
        sel_b = has_last_kf & (quat.qangle(q, q_last_kf)
                               > ks.critical_quaternion_difference)
        sel_s = has_s & (quat.qangle(q, q_s)
                         > ks.critical_quaternion_difference)
        selected = sel_b | sel_s
        q_s = torch.where(selected, q, q_s)
        has_s = has_s | selected

        # --- sparsification pass (time): usable vs buffer AND vs the
        # newest sparsification-pass keep; empty set → usable
        sp_b = (~has_last_kf) | ((ts - ts_last_kf)
                                 > ks.time_between_keyframes_sec)
        sp_p = (~has_p) | ((ts - ts_p) > ks.time_between_keyframes_sec)
        sparsified = sp_b & sp_p
        ts_p = torch.where(sparsified, ts, ts_p)
        has_p = has_p | sparsified

        accepted.append((selected | sparsified) & (~rejected))
    return torch.stack(accepted)
