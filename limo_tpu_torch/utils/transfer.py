"""Host ↔ device transfers in one copy each.

The host engine keeps numpy mirrors and runs each numeric step on the
device: a copy in either direction synchronises the host with the card,
so each step uploads its inputs in one copy and reads its results in one.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def numpy_float(dtype) -> type:
    """The numpy float type of a torch float type (float64 or float32)."""
    return np.float64 if dtype == torch.float64 else np.float32


def upload(arrays: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """Host arrays → tensors on ``device`` in one copy: the arrays' bytes are
    packed (8-byte aligned) into one buffer, uploaded once and viewed back
    in their dtypes and shapes. One upload costs one synchronisation on a
    card, where an upload per array would cost one each."""
    shapes = [np.shape(a) for a in arrays]
    arrays = [np.ascontiguousarray(a) for a in arrays]   # 0-d become 1-d
    offsets, n = [], 0
    for a in arrays:
        offsets.append(n)
        n += -(-a.nbytes // 8) * 8
    buf = np.zeros(max(n, 8), np.uint8)
    for a, o in zip(arrays, offsets):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = torch.from_numpy(buf).to(device)
    return [dev[o:o + a.nbytes].view(torch.from_numpy(a[:0].reshape(-1)).dtype)
            .reshape(shape) for a, o, shape in zip(arrays, offsets, shapes)]


def read_back(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Device tensors → numpy arrays in one read: every tensor is cast to
    float64 (exact for float32, int32 and bool), the casts concatenated and
    copied to the host once, then cast back to each tensor's dtype."""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in tensors]).cpu().numpy()
    out, o = [], 0
    for t in tensors:
        n = t.numel()
        np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(flat[o:o + n].astype(np_dtype).reshape(tuple(t.shape)))
        o += n
    return out
