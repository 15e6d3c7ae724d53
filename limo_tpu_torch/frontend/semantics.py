"""Semantic label sampling — the reference's ``image_preproc`` label
dilation and the ROI sampling of ``semantic_labels.launch``.

The reference package's ``limo_tpu/frontend/semantics.py`` (``dilate_labels``,
``sample_labels``) as PyTorch ops, over any leading batch shape. The label
image is dilated with half-kernel 8, outlier classes growing over their
neighbours; each feature then takes the majority label of its 3×3 ROI.
``attach_labels`` runs both for the host engine's tracklets, with one
upload and one read.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.transfer import read_back, upload
from ..window_manager import DEFAULT_OUTLIER_LABELS


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


def attach_labels(tracklets, label_img: np.ndarray, half_kernel: int = 8,
                  outlier_labels=DEFAULT_OUTLIER_LABELS, device="cuda"):
    """Dilate outlier classes, sample per-feature labels at the newest stamp,
    attach to tracks (host wrapper: one upload, one read). Returns a new
    Tracklets."""
    from ..pipeline.tracklets import Tracklets

    li, uv, table = upload(
        [np.asarray(label_img, np.int32),
         np.asarray(tracklets.uvd[:, 0, :2], np.float64),
         np.asarray(sorted(outlier_labels), np.int32)], device)
    dilated = dilate_labels(li, torch.isin(li, table), half_kernel)
    labels = read_back([sample_labels(dilated, uv)])[0]
    m = tracklets.mask[:, 0]
    new_label = tracklets.label.copy()
    new_label[m] = labels[m]
    return Tracklets(stamps=tracklets.stamps, uvd=tracklets.uvd,
                     mask=tracklets.mask, ids=tracklets.ids, age=tracklets.age,
                     is_outlier=tracklets.is_outlier, label=new_label)
