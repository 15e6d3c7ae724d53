"""Feature detection and matching — the viso2-equivalent front end.

The reference package's ``limo_tpu/frontend/tracker.py`` (``detect``,
``match``) as PyTorch ops. Its behaviour contract comes from the reference
launch graph's ``res/config_feature_matching.yaml``: NMS neighbourhood,
match radius, outlier flow tolerance, subpixel refinement.

- corner strength: Shi-Tomasi min-eigenvalue response from Sobel gradients;
- NMS: a max-pool equality with a largest-linear-index tie-break;
- a fixed feature count: a per-bucket cap, then a global top-k;
- descriptors: an 8×8 patch of intensity and both gradients, mean-free and
  L2-normalised, so matching is one [N,N] product;
- mutual nearest-neighbour matching gated by pixel radius and by flow
  consistency (a global median gate, or a local one under guidance).

``detect`` takes any leading batch shape, and every per-image result is
independent of it: the convolutions are fixed sums of shifted slices (no
cuDNN algorithm choice, no TF32), the top-k is a stable sort, and the rest
is elementwise, pooling or gathers. ``FeatureTracker`` (the host-side
tracker) is not part of the port yet.

Choices of the reference kept exactly: ``jax.lax.top_k`` puts the lower
index first on ties (here a stable descending sort), ``argmax`` takes the
first maximum (as ``torch.argmax`` does), and the integer maps of the NMS
tie-break are max-pooled as float32, exact below 2^24 pixels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..selection.landmark import norm, take
from ..utils.precision import full_f32


@dataclass(frozen=True)
class TrackerConfig:
    max_features: int = 1024
    nms_radius: int = 9            # nms_n (config_feature_matching.yaml:11)
    min_response: float = 1e-4
    match_radius: float = 400.0    # match_radius (yaml:14)
    outlier_flow_tolerance: float = 4.0  # yaml:16
    locality_sigma: float = 100.0  # px; similarity tie-break toward small flow
    patch: int = 8                 # descriptor patch side
    border: int = 12
    subpixel: bool = True          # refinement: 1 (yaml:19)
    # spatial bucketing (viso2 match_binsize, yaml:13): detections are
    # capped per bucket before the global top-k. 0 disables.
    bucket_size: int = 50
    bucket_cap: int = 0            # features per bucket; 0 = auto from k
    # guided matching (fused path): use the geometry-anchored motion
    # prediction while matching is healthy
    guided: bool = True
    # assumed depth of depthless features in the guided prediction
    depth_anchor_m: float = 20.0


class Features(NamedTuple):
    uv: torch.Tensor        # [...,N,2] (u,v) subpixel
    response: torch.Tensor  # [...,N]
    desc: torch.Tensor      # [...,N,D] L2-normalized
    valid: torch.Tensor     # [...,N] bool


class MatchResult(NamedTuple):
    prev_index: torch.Tensor  # [N] int32 index into previous Features, -1 none
    n_matches: torch.Tensor   # int32


def _shifted(x, r):
    """Zero-pad the last two axes of ``x`` by ``r``; returns a function
    giving the [H,W] window at offset (dy, dx) in [-r, r]."""
    H, W = x.shape[-2:]
    xp = F.pad(x, (r, r, r, r))
    return lambda dy, dx: xp[..., r + dy:r + dy + H, r + dx:r + dx + W]


def _sobel(img):
    """(gx, gy): the 3×3 Sobel correlation / 8 with zero padding (the
    reference's "SAME" convolution), as a fixed sum over the nonzero taps."""
    at = _shifted(img, 1)
    gx = ((-0.125 * at(-1, -1) + 0.125 * at(-1, 1))
          + (-0.25 * at(0, -1) + 0.25 * at(0, 1))
          + (-0.125 * at(1, -1) + 0.125 * at(1, 1)))
    gy = ((-0.125 * at(-1, -1) - 0.25 * at(-1, 0) - 0.125 * at(-1, 1))
          + (0.125 * at(1, -1) + 0.25 * at(1, 0) + 0.125 * at(1, 1)))
    return gx, gy


def _box_filter(x, r):
    """Sum over the (2r+1)² window, zero padded: rows, then columns."""
    H, W = x.shape[-2:]
    xp = F.pad(x, (r, r, r, r))
    rows = sum(xp[..., :, j:j + W] for j in range(2 * r + 1))
    return sum(rows[..., i:i + H, :] for i in range(2 * r + 1))


def _max_pool(x, r):
    """Max over the (2r+1)² window centred on each pixel; the window always
    holds its centre, so the padding value never wins."""
    H, W = x.shape[-2:]
    y = F.max_pool2d(x.reshape(-1, 1, H, W), 2 * r + 1, stride=1, padding=r)
    return y.reshape(x.shape)


def _top_k(x, k):
    """(values, indices) of the k largest entries of the last axis, the
    lower index first among equal values (``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _at(flat, idx):
    """``flat[..., idx]`` per batch element (idx [..., M] of flat indices)."""
    return torch.gather(flat, -1, idx.reshape(*flat.shape[:-1], -1)) \
        .reshape(idx.shape)


@full_f32
def detect(img, cfg: TrackerConfig = TrackerConfig()) -> Features:
    """Shi-Tomasi corners + NMS + top-k + descriptors on grayscale images
    [..., H, W] (float 0..1)."""
    H, W = img.shape[-2:]
    batch = img.shape[:-2]
    dev = img.device
    gx, gy = _sobel(img)
    Ixx = _box_filter(gx * gx, 2)
    Iyy = _box_filter(gy * gy, 2)
    Ixy = _box_filter(gx * gy, 2)
    tr = Ixx + Iyy
    det = Ixx * Iyy - Ixy * Ixy
    # min eigenvalue of the structure tensor
    resp = tr / 2.0 - torch.sqrt(torch.clamp_min((tr / 2.0) ** 2 - det, 0.0))

    r = cfg.nms_radius
    mx = _max_pool(resp, r)
    cand = (resp >= mx) & (resp > cfg.min_response)
    # strict tie-break on plateaus: among tied candidates keep the one with
    # the largest linear index per window (float32: exact below 2^24)
    if H * W >= 1 << 24:
        raise ValueError(f"{H} x {W} images: the NMS tie-break needs linear "
                         "pixel indices below 2^24 (exact in float32)")
    lin = torch.arange(H * W, dtype=torch.float32, device=dev).reshape(H, W)
    lin_cand = torch.where(cand, lin, torch.full_like(lin, -1.0))
    is_peak = cand & (lin_cand == _max_pool(lin_cand, r))
    b = cfg.border
    row = torch.arange(H, device=dev)[:, None]
    col = torch.arange(W, device=dev)[None, :]
    inside = (row >= b) & (row < H - b) & (col >= b) & (col < W - b)
    score2d = torch.where(is_peak & inside, resp, torch.zeros_like(resp))

    k = cfg.max_features
    bs = cfg.bucket_size
    if bs and bs < min(H, W):
        # per-bucket cap, then global top-k over the survivors
        Hp, Wp = -(-H // bs) * bs, -(-W // bs) * bs
        nbh, nbw = Hp // bs, Wp // bs
        T = nbh * nbw
        cap = min(cfg.bucket_cap or max(4, (2 * k) // T), bs * bs)
        sc = F.pad(score2d, (0, Wp - W, 0, Hp - H))
        tiles = sc.reshape(*batch, nbh, bs, nbw, bs).transpose(-3, -2) \
            .reshape(*batch, T, bs * bs)
        tv, ti = _top_k(tiles, cap)                          # [...,T,cap]
        tile = torch.arange(T, device=dev)
        py = torch.clamp((tile // nbw * bs)[:, None] + ti // bs, 0, H - 1)
        px = torch.clamp((tile % nbw * bs)[:, None] + ti % bs, 0, W - 1)
        sel_idx = (py * W + px).reshape(*batch, T * cap)
        sel_val = tv.reshape(*batch, T * cap)
        top_val, pos = _top_k(sel_val, min(k, T * cap))
        top_idx = torch.gather(sel_idx, -1, pos)
        if top_val.shape[-1] < k:          # fewer buckets×cap than k: pad
            pad = k - top_val.shape[-1]
            top_val = F.pad(top_val, (0, pad))
            top_idx = F.pad(top_idx, (0, pad))
    else:
        top_val, top_idx = _top_k(score2d.reshape(*batch, H * W), k)
    # integer positions as float32 even in a float64 run, as the reference
    vv = (top_idx // W).to(torch.float32)
    uu = (top_idx % W).to(torch.float32)
    valid = top_val > 0

    flat = resp.reshape(*batch, H * W)
    iu, iv = top_idx % W, top_idx // W
    if cfg.subpixel:
        # 1D parabola in u and v on the response map
        c = _at(flat, top_idx)
        l = _at(flat, iv * W + torch.clamp(iu - 1, 0, W - 1))
        rr = _at(flat, iv * W + torch.clamp(iu + 1, 0, W - 1))
        du = 0.5 * (l - rr) / torch.clamp_min(l - 2 * c + rr, 1e-9)
        u_ = _at(flat, torch.clamp(iv - 1, 0, H - 1) * W + iu)
        d_ = _at(flat, torch.clamp(iv + 1, 0, H - 1) * W + iu)
        dv = 0.5 * (u_ - d_) / torch.clamp_min(u_ - 2 * c + d_, 1e-9)
        uu = uu + torch.clamp(du, -0.5, 0.5)
        vv = vv + torch.clamp(dv, -0.5, 0.5)

    # descriptors: patch of intensity + gradients at the integer location,
    # pixel-major and channel-minor as the reference stacks them
    half = cfg.patch // 2
    off = torch.arange(-half, half, device=dev)
    dy = off[:, None].expand(-1, cfg.patch).reshape(-1)
    dx = off[None, :].expand(cfg.patch, -1).reshape(-1)
    iu = torch.clamp(uu.to(torch.int32), 0, W - 1).long()
    iv = torch.clamp(vv.to(torch.int32), 0, H - 1).long()
    ys = torch.clamp(iv[..., None] + dy, 0, H - 1)
    xs = torch.clamp(iu[..., None] + dx, 0, W - 1)
    pix = ys * W + xs                                          # [...,N,P²]
    desc = torch.stack([_at(m.reshape(*batch, H * W), pix)
                        for m in (img, gx, gy)], -1)
    desc = desc.reshape(*pix.shape[:-1], -1)
    desc = desc - torch.mean(desc, -1, keepdim=True)
    desc = desc / torch.clamp_min(norm(desc)[..., None], 1e-9)
    return Features(uv=torch.stack([uu, vv], -1), response=top_val,
                    desc=desc, valid=valid)


def _masked_median(x, mask):
    """Median of the masked entries (0 when the mask is empty)."""
    n = x.shape[0]
    s = torch.sort(torch.where(mask, x, torch.full_like(x, torch.inf))).values
    cnt = mask.sum()
    i = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), 0, n - 1)
    j = torch.clamp(torch.div(cnt, 2, rounding_mode="floor"), 0, n - 1)
    return torch.where(cnt > 0, 0.5 * (take(s, i) + take(s, j)),
                       torch.zeros_like(s[0]))


@full_f32
def match(cur: Features, prev: Features,
          cfg: TrackerConfig = TrackerConfig(),
          pred_uv=None, pred_known=None) -> MatchResult:
    """Mutual-NN descriptor matching gated by radius + flow consistency.

    Similarity is NCC (the descriptor dot product, one [N,N] product).
    Returns for each current feature the index of its previous-frame match
    or -1. ``pred_uv`` [N,2]: predicted current-frame positions of the
    previous features (guided matching): the locality prior centres on the
    prediction and the flow gate is local. ``pred_known`` [N] marks
    previous features whose prediction is informed; the others get a 4×
    wider locality sigma. Without a prediction: a zero-flow prior and the
    global median-flow gate.
    """
    guided = pred_uv is not None
    if pred_uv is None:
        pred_uv = prev.uv
    if pred_known is None:
        pred_known = torch.ones_like(prev.valid)
    n = cur.uv.shape[0]
    sim = cur.desc @ prev.desc.T                                 # [N,N]
    d2 = torch.sum((cur.uv[:, None] - pred_uv[None]) ** 2, -1)
    ok = (cur.valid[:, None] & prev.valid[None]
          & (d2 <= cfg.match_radius ** 2))
    ls = torch.full_like(d2[0], cfg.locality_sigma)
    sigma = torch.where(pred_known, ls, 4.0 * ls)               # [N] prev
    neg = torch.full_like(sim, -2.0)
    sim_adj = torch.where(ok, sim - d2 / (2.0 * sigma[None, :] ** 2), neg)
    best_prev = torch.argmax(sim_adj, 1)                         # cur → prev
    best_cur = torch.argmax(sim_adj, 0)                          # prev → cur
    mutual = best_cur[best_prev] == torch.arange(n, device=sim.device)
    score = torch.gather(torch.where(ok, sim, neg), 1, best_prev[:, None])[:, 0]
    good = mutual & (score > 0.5) & cur.valid

    # flow-consistency gate: the global median (unguided) or a local
    # neighbourhood gate, tight in v and looser in u, two rounds (guided)
    flow = cur.uv - prev.uv[best_prev]
    tol = 8.0 * cfg.outlier_flow_tolerance
    if guided:
        du2 = (cur.uv[:, None, 0] - cur.uv[None, :, 0]) ** 2
        dv2 = (cur.uv[:, None, 1] - cur.uv[None, :, 1]) ** 2
        w_loc = torch.exp(-du2 / (2.0 * 120.0 ** 2)
                          - dv2 / (2.0 * 40.0 ** 2))
        ok_gate = good
        for _ in range(2):
            w = w_loc * ok_gate[None, :]
            wsum = torch.sum(w, -1, keepdim=True)
            mean_flow = (w @ flow) / torch.clamp_min(wsum, 1e-6)
            dev = norm(flow - mean_flow)
            ok_gate = good & (dev < tol + 0.5 * norm(mean_flow))
        # no gated neighbours at all (bootstrap): keep descriptor matches
        good = torch.where(ok_gate.any(), ok_gate, good)
    else:
        med = torch.stack([_masked_median(flow[:, 0], good),
                           _masked_median(flow[:, 1], good)])
        good = good & (norm(flow - med) < tol)

    prev_index = torch.where(good, best_prev, torch.full_like(best_prev, -1))
    return MatchResult(prev_index=prev_index.to(torch.int32),
                       n_matches=good.sum(dtype=torch.int32))

