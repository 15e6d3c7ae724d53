"""Full-f32 pinning for the solver's numeric core.

On the reference's accelerator a default f32 matrix product ran in reduced
precision, and the Schur complement S = H − W·V⁻¹·Wᵀ (and its dense
solve), which cancels almost exactly on weakly constrained dims such as the
mono scale, lost 6.8 m → 0.32 m ATE to it on a 2-camera window. The port
therefore runs every solver contraction in full f32: TF32 is off for
cuBLAS matrix products and for cuDNN. PyTorch leaves cuDNN's TF32 on by
default, so both flags are set explicitly. There is no precision knob.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def _tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def full_f32(fn):
    """Decorate a solver entry point to run with TF32 off (restored after)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _tf32_off():
            return fn(*args, **kwargs)

    return wrapped
