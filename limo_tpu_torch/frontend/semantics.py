"""Semantic label sampling — the reference's ``image_preproc`` label
dilation and the ROI sampling of ``semantic_labels.launch``.

The reference package's ``limo_tpu/frontend/semantics.py`` (``dilate_labels``,
``sample_labels``) as PyTorch ops, over any leading batch shape. The label
image is dilated with half-kernel 8, outlier classes growing over their
neighbours; each feature then takes the majority label of its 3×3 ROI.
``attach_labels`` (the host tracklet path) is not part of the port yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate_labels(label_img, priority_mask, half_kernel: int = 8):
    """Grow priority classes (outliers) by a (2k+1)² max-window so features
    near dynamic-object borders inherit the outlier label.

    label_img [...,H,W] int32; priority_mask [...,H,W] bool. The packed
    (label, priority) keys are small, so the max-pool runs exactly in
    float32; the window always holds its centre, so its padding never wins
    over the reference's 0."""
    H, W = label_img.shape[-2:]
    packed = torch.where(priority_mask, ((label_img.to(torch.int32) + 1) << 1) | 1,
                         torch.zeros_like(label_img, dtype=torch.int32))
    grown = F.max_pool2d(packed.to(torch.float32).reshape(-1, 1, H, W),
                         2 * half_kernel + 1, stride=1, padding=half_kernel)
    grown = grown.reshape(label_img.shape).to(torch.int32)
    grown_label = ((grown >> 1) - 1).to(label_img.dtype)
    return torch.where(grown > 0, grown_label, label_img)


def sample_labels(label_img, uv):
    """Majority label in the 3×3 ROI around each feature (the first of the
    most frequent, in row-major ROI order). label_img [...,H,W], uv
    [...,N,2] pixel coords."""
    H, W = label_img.shape[-2:]
    iu = torch.clamp(uv[..., 0].to(torch.int32), 1, W - 2).long()
    iv = torch.clamp(uv[..., 1].to(torch.int32), 1, H - 2).long()
    d = torch.arange(-1, 2, device=uv.device)
    offs = (d[:, None] * W + d[None, :]).reshape(-1)           # dy-major
    idx = (iv * W + iu)[..., None] + offs                       # [...,N,9]
    flat = label_img.reshape(*label_img.shape[:-2], H * W)
    roi = torch.gather(flat, -1, idx.reshape(*flat.shape[:-1], -1)) \
        .reshape(idx.shape)
    counts = (roi[..., :, None] == roi[..., None, :]).sum(-1)
    best = torch.argmax(counts, -1)
    return torch.gather(roi, -1, best[..., None])[..., 0]
