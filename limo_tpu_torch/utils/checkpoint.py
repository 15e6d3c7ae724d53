"""Checkpoint / resume of the sliding-window state.

The reference has no in-flight checkpointing (SURVEY §5 — only a KITTI pose
dump per frame and a YAML map dump in the destructor). The window state of
:class:`~limo_tpu_torch.window_manager.BundleAdjuster` lives in numpy host
mirrors plus small host bookkeeping, so checkpoint/resume serializes those
mirrors and reloads them. A copy of the reference package's
``limo_tpu/utils/checkpoint.py``, in the same file format: a checkpoint
written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


_ARRAY_FIELDS = [
    "_stamps", "_poses", "_kf_valid", "_fixation", "_planes", "_plane_valid",
    "_lm_pos", "_lm_valid", "_lm_weight", "_lm_has_depth", "_lm_is_gp",
    "_lm_id", "_lm_known", "_lm_outlier", "_obs", "_obs_mask",
]


def save_adjuster(ba, path: str) -> None:
    """Write the full window state to an .npz + json sidecar."""
    arrays = {f: getattr(ba, f) for f in _ARRAY_FIELDS}
    if ba._last_selection is not None:
        arrays["_last_selection"] = ba._last_selection
    np.savez_compressed(path, **arrays)
    meta = {
        "kf_order": [int(s) for s in ba._kf_order],
        "lm_slot": {str(k): int(v) for k, v in ba._lm_slot.items()},
        "archive_stamps": [float(s) for s in ba._archive.keys()],
        "archive_poses": [p.tolist() for p in ba._archive.values()],
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_adjuster(ba, path: str) -> None:
    """Restore state saved by :func:`save_adjuster` into ``ba`` (which must
    have been constructed with the same capacities/rig/config)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    for f in _ARRAY_FIELDS:
        getattr(ba, f)[...] = data[f]
    ba._last_selection = (data["_last_selection"]
                          if "_last_selection" in data.files else None)
    with open((path[:-4] if path.endswith(".npz") else path) + ".json"
              if not os.path.exists(path + ".json") else path + ".json") as f:
        meta = json.load(f)
    ba._kf_order = [int(s) for s in meta["kf_order"]]
    ba._lm_slot = {int(k): int(v) for k, v in meta["lm_slot"].items()}
    ba._archive = {float(s): np.asarray(p) for s, p in
                   zip(meta["archive_stamps"], meta["archive_poses"])}


def dump_map(ba, path: str) -> None:
    """Landmarks + keyframe poses dump — the ``dumpMap`` equivalent
    (general_helpers.hpp:170-207, YAML written in the node destructor).
    JSON here (same content, sane format)."""
    known = ba._lm_valid & ba._lm_known
    out = {
        "keyframes": [
            {"stamp": float(ba._stamps[s]), "pose_kf_origin": ba._poses[s].tolist()}
            for s in ba._kf_order
        ],
        "archived": [
            {"stamp": float(st), "pose_kf_origin": p.tolist()}
            for st, p in sorted(ba._archive.items())
        ],
        "landmarks": [
            {"id": int(ba._lm_id[i]), "pos": ba._lm_pos[i].tolist(),
             "has_depth": bool(ba._lm_has_depth[i]),
             "is_ground_plane": bool(ba._lm_is_gp[i]),
             "weight": float(ba._lm_weight[i])}
            for i in np.flatnonzero(known)
        ],
    }
    with open(path, "w") as f:
        json.dump(out, f)
