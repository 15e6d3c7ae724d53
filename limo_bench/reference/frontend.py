"""The plain reference of the fused front end's semantics, in NumPy
float64.

Written from the semantics LIMO's configuration files state
(``config_feature_matching.yaml``, ``mono_lidar_fusion_parameters.yaml``,
``feature_matching.launch``, ``semantic_labels.launch``) as PERF.md
describes the port's front end, not from the program's modules: it
imports nothing of the program. Each function takes the program's own
inputs to that stage (the image, the label image, the scan, the program's
features and previous state) and gives what the stage has to give:

- :func:`detect`: gamma, the Shi-Tomasi response of 3×3 Sobel gradients
  (/8) summed over a 5×5 window, non-maximum suppression over the
  (2·nms + 1)² window (a plateau keeps its largest linear index), the
  border, the per-bucket cap (50 px buckets, ``max(4, 2k / buckets)``
  each) and the global top-k (the lower index first on ties), the
  sub-pixel refinement and the 8×8 patch descriptors (intensity and both
  gradients, mean-free, unit norm);
- :func:`labels`: outlier classes dilated over a (2·8 + 1)² window (the
  largest outlier id in reach wins), then the majority of the 3×3 ROI (the
  first in row-major order on ties);
- :func:`match`: guided mutual nearest neighbours of the descriptors'
  correlation less a locality penalty around the motion prediction, the
  radius, a correlation above 0.5 and the local flow gate (two rounds);
- :func:`depths`: the scan in the camera, its projection, and per feature
  the returns in the 6 × 9 px rectangle, found by brute force over every
  return (no grid, no per-cell cap), the K nearest kept; the histogram
  segment (the nearest local-maximum bin), the largest-area planar triangle
  and its viewing-ray check, the ray's intersection, the segment's mean as
  the fallback, the global and local thresholds;
- :func:`groundplane`: the RANSAC plane over the same uint32-hash
  hypotheses (they are the semantics: which three returns a hypothesis
  draws), its least-squares refinement and inliers; :func:`ground_depth`,
  the M-estimator ground patch for features without an object depth.

Departures from a textbook reading, each the configuration's semantics as
the program states them:

- the sub-pixel step divides by the parabola's curvature clamped at 1e-9
  from below, so at a response peak (curvature < 0) it saturates at ±0.5
  px toward the lower neighbour (0 where both are equal); the descriptor's
  patch sits at the refined position truncated to an integer;
- the per-cell cap of the port's grid search is not modelled: this search
  sees every return, so a neighbour the cap dropped shows as a different
  depth;
- float64 throughout (the configuration's float32 is the program's): where
  a comparison at a threshold is closer than float32 can decide, the
  result is marked ambiguous and the judge accepts either outcome (the
  refinement's sign, a return at the rectangle's edge, a depth at a bin's
  edge).
"""

from __future__ import annotations

import numpy as np

from . import plain

# float32 can not decide a comparison closer than these
EDGE_PX = 1e-3          # a return this close to the rectangle's edge
BIN_EDGE = 2e-5         # a depth this close to a histogram bin's edge
                        # (relative to the depth)
SIGN_REL = 1e-5         # neighbours' responses this close (relative)


def _f(a):
    return np.asarray(a, np.float64)


# ------------------------------------------------------------ detection --

def gamma(img_u8, g: float):
    return (_f(img_u8) / 255.0) ** (1.0 / g)


def _shift(x, dy, dx, fill=0.0):
    """``out[y, x] = x[y + dy, x + dx]``, ``fill`` outside."""
    H, W = x.shape
    out = np.full_like(x, fill)
    out[max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)] = \
        x[max(dy, 0):H - max(-dy, 0), max(dx, 0):W - max(-dx, 0)]
    return out


def _correlate(x, k):
    """Correlation with kernel ``k`` (odd sides), zero padded ("same")."""
    kh, kw = k.shape
    out = np.zeros_like(x)
    for i in range(kh):
        for j in range(kw):
            if k[i, j] != 0:
                out += k[i, j] * _shift(x, i - kh // 2, j - kw // 2)
    return out


def _maxfilter(x, r):
    """Max over the (2r + 1)² window around each pixel (outside: none)."""
    rows = x.copy()
    for d in range(1, r + 1):
        rows = np.maximum(rows, np.maximum(_shift(x, 0, d, -np.inf),
                                           _shift(x, 0, -d, -np.inf)))
    out = rows.copy()
    for d in range(1, r + 1):
        out = np.maximum(out, np.maximum(_shift(rows, d, 0, -np.inf),
                                         _shift(rows, -d, 0, -np.inf)))
    return out


def response(img):
    """(Shi-Tomasi response, gx, gy) of a [H,W] float64 image."""
    sx = np.array([[-1.0, 0, 1], [-2, 0, 2], [-1, 0, 1]]) / 8
    gx = _correlate(img, sx)
    gy = _correlate(img, sx.T)
    box = np.ones((5, 5))
    ixx, iyy, ixy = (_correlate(a, box) for a in (gx * gx, gy * gy, gx * gy))
    tr = ixx + iyy
    det = ixx * iyy - ixy * ixy
    resp = tr / 2 - np.sqrt(np.maximum((tr / 2) ** 2 - det, 0.0))
    return resp, gx, gy


def _top(x, k):
    """(values, indices) of the k largest, the lower index first on ties."""
    i = np.argsort(-x, kind="stable")[:k]
    return x[i], i


def detect(img, tcfg: dict):
    """Features of a gamma-corrected [H,W] image: dict of ``pix`` [k] the
    integer pixel (linear index), ``valid`` [k], ``uv`` [k,2], ``uv_alt``
    [k,2,4] the admissible positions per axis (where float32 can not
    decide the refinement's sign: -0.5, 0 and 0.5 px), ``desc`` [k,D] and
    ``desc_ok`` [k] (the patch's position decided)."""
    img = _f(img)
    H, W = img.shape
    k = int(tcfg["max_features"])
    resp, gx, gy = response(img)
    r = int(tcfg["nms_radius"])
    cand = (resp >= _maxfilter(resp, r)) & (resp > tcfg["min_response"])
    lin = np.arange(H * W, dtype=np.float64).reshape(H, W)
    lin_c = np.where(cand, lin, -1.0)
    peak = cand & (lin_c == _maxfilter(lin_c, r))
    b = int(tcfg["border"])
    inside = np.zeros((H, W), bool)
    inside[b:H - b, b:W - b] = True
    score = np.where(peak & inside, resp, 0.0)

    bs = int(tcfg["bucket_size"])
    if bs and bs < min(H, W):
        nbh, nbw = -(-H // bs), -(-W // bs)
        T = nbh * nbw
        cap = min(int(tcfg["bucket_cap"]) or max(4, (2 * k) // T), bs * bs)
        vals, pos = [], []
        for t in range(T):
            y0, x0 = t // nbw * bs, t % nbw * bs
            tile = np.zeros((bs, bs))
            sub = score[y0:y0 + bs, x0:x0 + bs]
            tile[:sub.shape[0], :sub.shape[1]] = sub
            v, i = _top(tile.reshape(-1), cap)
            py = np.minimum(y0 + i // bs, H - 1)
            px = np.minimum(x0 + i % bs, W - 1)
            vals.append(v)
            pos.append(py * W + px)
        vals, pos = np.concatenate(vals), np.concatenate(pos)
        top_val, i = _top(vals, k)
        top_idx = pos[i]
        if len(top_val) < k:
            top_val = np.pad(top_val, (0, k - len(top_val)))
            top_idx = np.pad(top_idx, (0, k - len(top_idx)))
    else:
        top_val, top_idx = _top(score.reshape(-1), k)
    valid = top_val > 0
    iu, iv = top_idx % W, top_idx // W
    flat = resp.reshape(-1)

    def offset(lo, c, hi):
        """The refinement's offset and the admissible ones [k,4] (NaN
        where not admissible): the curvature clamped at 1e-9 from below."""
        step = np.clip(0.5 * (lo - hi) / np.maximum(lo - 2 * c + hi, 1e-9),
                       -0.5, 0.5)
        close = np.abs(lo - hi) <= SIGN_REL * np.maximum(np.abs(lo),
                                                         np.abs(hi))
        alt = np.stack([step, np.full_like(step, -0.5), np.zeros_like(step),
                        np.full_like(step, 0.5)], -1)
        alt[:, 1:] = np.where(close[:, None], alt[:, 1:], np.nan)
        return step, alt, close

    if tcfg["subpixel"]:
        c = flat[top_idx]
        du, au, cu = offset(flat[iv * W + np.clip(iu - 1, 0, W - 1)], c,
                            flat[iv * W + np.clip(iu + 1, 0, W - 1)])
        dv, av, cv = offset(flat[np.clip(iv - 1, 0, H - 1) * W + iu], c,
                            flat[np.clip(iv + 1, 0, H - 1) * W + iu])
    else:
        du = dv = np.zeros(k)
        au = av = np.stack([du] + [du + np.nan] * 3, -1)
        cu = cv = np.zeros(k, bool)
    uu = iu + du
    vv = iv + dv
    uv_alt = np.stack([iu[:, None] + au, iv[:, None] + av], 1)

    half = int(tcfg["patch"]) // 2
    off = np.arange(-half, half)
    pu = np.clip(uu.astype(np.int64), 0, W - 1)
    pv = np.clip(vv.astype(np.int64), 0, H - 1)
    ys = np.clip(pv[:, None, None] + off[None, :, None], 0, H - 1)
    xs = np.clip(pu[:, None, None] + off[None, None, :], 0, W - 1)
    pix = (ys * W + xs).reshape(k, -1)
    desc = np.stack([m.reshape(-1)[pix] for m in (img, gx, gy)], -1) \
        .reshape(k, -1)
    desc = desc - desc.mean(-1, keepdims=True)
    desc = desc / np.maximum(np.linalg.norm(desc, axis=-1, keepdims=True),
                             1e-9)
    return {"pix": top_idx, "valid": valid, "uv": np.stack([uu, vv], -1),
            "uv_alt": uv_alt, "desc": desc, "desc_ok": ~(cu | cv)}


def compare_features(ref, uv, valid, desc):
    """The program's features (uv [k,2], valid [k], desc [k,D]) against
    the reference's: (flips, the largest uv distance to an admissible
    position over the paired features, the largest descriptor difference
    where the patch's position is decided). A program feature pairs with
    the reference feature whose integer pixel lies within 1 px of it
    (non-maximum suppression keeps peaks 2·nms apart)."""
    uv, valid, desc = _f(uv), np.asarray(valid, bool), _f(desc)
    rv = ref["valid"]
    r_uv, r_alt = ref["uv"][rv], ref["uv_alt"][rv]
    r_desc, r_ok = ref["desc"][rv], ref["desc_ok"][rv]
    p_uv, p_desc = uv[valid], desc[valid]
    if len(r_uv) == 0 or len(p_uv) == 0:
        return float(len(r_uv) + len(p_uv)), 0.0, 0.0
    dist = np.abs(p_uv[:, None] - r_uv[None]).max(-1)          # [P,R]
    j = np.argmin(dist, 1)
    paired = dist[np.arange(len(p_uv)), j] <= 1.0
    taken = np.zeros(len(r_uv), bool)
    taken[j[paired]] = True
    flips = int((~paired).sum()) + int((~taken).sum())
    a, b = np.flatnonzero(paired), j[paired]
    gap = np.nanmin(np.abs(r_alt[b] - p_uv[a][:, :, None]), -1)   # [n,2]
    uv_px = float(gap.max()) if len(a) else 0.0
    ok = r_ok[b]
    desc_err = float(np.abs(p_desc[a[ok]] - r_desc[b[ok]]).max()) \
        if ok.any() else 0.0
    return float(flips), uv_px, desc_err


# --------------------------------------------------------------- labels --

def labels(label_img, uv, outlier_labels, half_kernel: int):
    """The label of each feature at ``uv`` [k,2] (program's positions)."""
    lab = np.asarray(label_img).astype(np.int64)
    H, W = lab.shape
    prio = np.isin(lab, sorted(outlier_labels))
    # the largest outlier id within reach (ids + 1 so that 0 means none)
    key = np.where(prio, lab + 1, 0).astype(np.float64)
    grown = _maxfilter(key, half_kernel).astype(np.int64)
    lab = np.where(grown > 0, grown - 1, lab)
    uv = _f(uv)
    iu = np.clip(uv[:, 0].astype(np.int64), 1, W - 2)
    iv = np.clip(uv[:, 1].astype(np.int64), 1, H - 2)
    d = np.arange(-1, 2)
    roi = lab[iv[:, None, None] + d[None, :, None],
              iu[:, None, None] + d[None, None, :]].reshape(len(uv), 9)
    counts = (roi[:, :, None] == roi[:, None, :]).sum(-1)
    return roi[np.arange(len(uv)), np.argmax(counts, 1)]


# ------------------------------------------------------------- matching --

def predict(prev_uv, prev_depth, vel, prev_matches, n_kf, cam, tcfg):
    """The guided match's prediction of the previous features in this
    frame: each at its lidar depth (else ``depth_anchor_m``), moved by the
    constant-velocity motion ``vel`` (vehicle frame) and projected; trusted
    while the last frame matched at least 30 and a keyframe exists.
    Returns (pred_uv [k,2], known [k])."""
    prev_uv, d = _f(prev_uv), _f(prev_depth)
    f, pp = cam.focal, _f(cam.principal)
    has_d = d > 0
    z = np.where(has_d, d, tcfg["depth_anchor_m"])
    p = np.concatenate([(prev_uv - pp) / f * z[:, None], z[:, None]], -1)
    T = _f(cam.T_cam_veh)
    motion = plain.compose(T, plain.compose(_f(vel), plain.inverse(T)))
    q = plain.apply(motion, p)
    ok = q[:, 2] > 0.5
    proj = f * q[:, :2] / np.maximum(q[:, 2], 0.5)[:, None] + pp
    moved = np.where(ok[:, None], proj, prev_uv)
    trusted = int(prev_matches) >= 30 and int(n_kf) > 0 and tcfg["guided"]
    return (moved if trusted else prev_uv), has_d & trusted


def match(uv, desc, valid, prev_uv, prev_desc, prev_valid, pred_uv, known,
          tcfg):
    """The previous feature each current one matches (-1 none)."""
    uv, desc, prev_uv, prev_desc, pred_uv = (
        _f(a) for a in (uv, desc, prev_uv, prev_desc, pred_uv))
    valid, prev_valid, known = (np.asarray(a, bool)
                                for a in (valid, prev_valid, known))
    n = len(uv)
    sim = desc @ prev_desc.T
    d2 = ((uv[:, None] - pred_uv[None]) ** 2).sum(-1)
    ok = valid[:, None] & prev_valid[None] & (d2 <= tcfg["match_radius"] ** 2)
    sigma = np.where(known, tcfg["locality_sigma"],
                     4.0 * tcfg["locality_sigma"])
    adj = np.where(ok, sim - d2 / (2 * sigma[None] ** 2), -2.0)
    best_prev = np.argmax(adj, 1)
    best_cur = np.argmax(adj, 0)
    mutual = best_cur[best_prev] == np.arange(n)
    score = np.where(ok, sim, -2.0)[np.arange(n), best_prev]
    good = mutual & (score > 0.5) & valid
    flow = uv - prev_uv[best_prev]
    tol = 8.0 * tcfg["outlier_flow_tolerance"]
    du2 = (uv[:, None, 0] - uv[None, :, 0]) ** 2
    dv2 = (uv[:, None, 1] - uv[None, :, 1]) ** 2
    w_loc = np.exp(-du2 / (2 * 120.0 ** 2) - dv2 / (2 * 40.0 ** 2))
    gate = good
    for _ in range(2):
        w = w_loc * gate[None, :]
        mean = (w @ flow) / np.maximum(w.sum(-1, keepdims=True), 1e-6)
        dev = np.linalg.norm(flow - mean, axis=-1)
        gate = good & (dev < tol + 0.5 * np.linalg.norm(mean, axis=-1))
    good = gate if gate.any() else good
    return np.where(good, best_prev, -1)


# ---------------------------------------------------------- lidar depth --

def to_camera(cloud_veh, T_cam_veh):
    return plain.apply(np.asarray(T_cam_veh, np.float64),
                       np.asarray(cloud_veh, np.float64))


def _project(pc, cam, image_size):
    W, H = image_size
    z = pc[:, 2]
    front = z > 0.1
    uv = cam.focal * pc[:, :2] / np.where(front, z, 1.0)[:, None] \
        + np.asarray(cam.principal, np.float64)
    inside = front & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) \
        & (uv[:, 1] < H)
    return uv, inside


def neighbours(pc, ok, uv_feat, cam, image_size, lcfg):
    """Per feature, the indices (into ``pc``) of its K nearest returns in
    the rectangle, by brute force over every return: a list of index
    arrays, sorted by pixel distance, and whether a return lies at the
    rectangle's edge (ambiguous in float32)."""
    uv, inside = _project(pc, cam, image_size)
    idx = np.flatnonzero(inside & ok)
    uvp = uv[idx]
    hw, hh = lcfg["search_width"] / 2, lcfg["search_height"] / 2
    K = int(lcfg["max_neighbors"])
    out, edge = [], []
    feats = _f(uv_feat)
    for lo in range(0, len(feats), 64):
        f = feats[lo:lo + 64]
        du = np.abs(uvp[None, :, 0] - f[:, None, 0])
        dv = np.abs(uvp[None, :, 1] - f[:, None, 1])
        inr = (du <= hw) & (dv <= hh)
        near = ((np.abs(du - hw) < EDGE_PX) | (np.abs(dv - hh) < EDGE_PX)) \
            & (du <= hw + EDGE_PX) & (dv <= hh + EDGE_PX)
        near = near.any(1)
        d2 = du * du + dv * dv
        for a in range(len(f)):
            j = np.flatnonzero(inr[a])
            j = j[np.argsort(d2[a, j], kind="stable")]
            amb = bool(near[a]) or (len(j) > K and bool(np.isclose(
                d2[a, j[K - 1]], d2[a, j[K]], rtol=1e-6)))
            out.append(idx[j[:K]])
            edge.append(amb)
    return out, np.array(edge, bool)


def _ray(uv, cam):
    r = np.array([(uv[0] - cam.principal[0]) / cam.focal,
                  (uv[1] - cam.principal[1]) / cam.focal, 1.0])
    return r / np.linalg.norm(r)


def object_depth(pts, uv, cam, lcfg):
    """(depth or -1, ambiguous) of one feature from its neighbours ``pts``
    [n,3] (camera frame, sorted by pixel distance)."""
    n = len(pts)
    if n < lcfg["min_neighbors"]:
        return -1.0, False
    z = pts[:, 2]
    bins = np.floor(z / lcfg["hist_bin_width"]).astype(np.int64)
    frac = z / lcfg["hist_bin_width"]
    amb = bool(np.any(np.abs(frac - np.round(frac))
                      < BIN_EDGE * np.maximum(frac, 1.0)))
    count = np.array([np.sum(bins == b) for b in bins])
    prev = np.array([np.sum(bins == b - 1) for b in bins])
    nxt = np.array([np.sum(bins == b + 1) for b in bins])
    local = (count >= prev) & (count >= nxt) & (count >= lcfg["hist_min_count"])
    if not local.any():
        return -1.0, amb
    best = int(np.argmin(np.where(local, z, np.inf)))
    seg = bins == bins[best]
    ray = _ray(uv, cam)
    depth = None
    s = np.flatnonzero(seg)
    if len(s) >= 3:
        t = _triples(len(s))
        a, b, c = pts[s[t[:, 0]]], pts[s[t[:, 1]]], pts[s[t[:, 2]]]
        cr = np.cross(b - a, c - a)
        area = np.linalg.norm(cr, axis=1)
        planar = area / np.maximum(np.linalg.norm(b - a, axis=1)
                                   * np.linalg.norm(c - a, axis=1), 1e-12) \
            >= lcfg["crossnorm_thres"]
        score = np.where(planar, area, -1.0)
        i = int(np.argmax(score))          # the first of the largest
        if score[i] > 0:
            nrm = cr[i] / max(np.linalg.norm(cr[i]), 1e-12)
            nr = float(nrm @ ray)
            if abs(nr) >= lcfg["viewray_ortho_thres"]:
                depth = float(nrm @ a[i]) / nr * ray[2]
    if depth is None:
        depth = float(z[seg].mean())
    lo, hi = z[seg].min(), z[seg].max()
    ok = (lcfg["depth_min"] <= depth <= lcfg["depth_max"]
          and lo * (1 - lcfg["local_thres_rel"]) <= depth
          <= hi * (1 + lcfg["local_thres_rel"]))
    return (depth if ok else -1.0), amb


_TRIPLES = {}


def _triples(n: int) -> np.ndarray:
    """[C(n,3), 3] index triples i < j < l in lexicographic order."""
    if n not in _TRIPLES:
        i, j, k = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
        m = (i < j) & (j < k)
        _TRIPLES[n] = np.stack([i[m], j[m], k[m]], -1)
    return _TRIPLES[n]


def _hash2(i, j):
    m = np.uint64(0xFFFFFFFF)
    mul = lambda x, c: (x * np.uint64(c)) & m
    x = mul(i, 0x9E3779B9) ^ mul(j, 0x85EBCA6B)
    x = mul(x ^ (x >> np.uint64(16)), 0x7FEB352D)
    x = mul(x ^ (x >> np.uint64(15)), 0x846CA68B)
    return x ^ (x >> np.uint64(16))


def fit_plane(p, w):
    """Weighted total least squares: (unit normal with n_z >= 0, d)."""
    c = (p * w[:, None]).sum(0) / max(w.sum(), 1e-9)
    q = (p - c) * w[:, None]
    cov = q.T @ (p - c) / max(w.sum(), 1e-9)
    n = np.linalg.eigh(cov)[1][:, 0]
    n = n * np.sign(n[2] + 1e-12)
    return n, -float(n @ c)


def groundplane(cloud_veh, ok, gcfg):
    """The RANSAC road plane in the vehicle frame: (normal [3], d,
    inliers [P], ok) with n·p + d = 0."""
    p = np.asarray(cloud_veh, np.float64)
    lo, hi = gcfg["z_band_m"]
    cand = np.asarray(ok, bool) & (p[:, 2] >= lo) & (p[:, 2] <= hi)
    order = np.concatenate([np.flatnonzero(cand), np.flatnonzero(~cand)])
    n_valid = max(int(cand.sum()), 1)
    H = int(gcfg["hypotheses"])
    h = np.arange(H, dtype=np.uint64)[:, None]
    r = _hash2(h & np.uint64(0xFFFFFFFF), np.arange(3, dtype=np.uint64)[None])
    s = p[order[(r % np.uint64(n_valid)).astype(np.int64)]]      # [H,3,3]
    n = np.cross(s[:, 1] - s[:, 0], s[:, 2] - s[:, 0])
    nn = np.linalg.norm(n, axis=1)
    n = n / np.maximum(nn, 1e-12)[:, None]
    d = -(n * s[:, 0]).sum(1)
    pt = p[cand]
    counts = np.zeros(H, np.int64)
    for lo in range(0, len(pt), 16384):
        dist = np.abs(pt[lo:lo + 16384] @ n.T + d[None])
        counts += (dist < gcfg["inlier_m"]).sum(0)
    counts = counts * (nn >= 1e-9)
    best = int(np.argmax(counts))
    w = np.zeros(len(p))
    w[np.flatnonzero(cand)] = np.abs(pt @ n[best] + d[best]) \
        < gcfg["inlier_m"]
    nr, dr = fit_plane(p, w)
    inl = cand & (np.abs(p @ nr + dr) < gcfg["inlier_m"])
    return nr, dr, inl, bool(inl.sum() >= gcfg["min_inliers"])


def ground_depth(pts, uv, n_cam, d_cam, cam, lcfg):
    """The M-estimator ground patch's depth (or -1) of one feature from
    its inlier neighbours ``pts`` [m,3] (camera frame)."""
    if len(pts) >= lcfg["min_neighbors"]:
        w = 1.0 / (np.abs(pts @ n_cam + d_cam) + 0.05)
        c = (pts * w[:, None]).sum(0) / max(w.sum(), 1e-9)
        cov = ((pts - c) * w[:, None]).T @ (pts - c)
        n = np.linalg.eigh(cov)[1][:, 0]
        n = n * np.sign(n @ n_cam + 1e-12)
        d = -float(n @ c)
    else:
        n, d = n_cam, d_cam
    ray = _ray(uv, cam)
    nr = float(n @ ray)
    nr = nr if abs(nr) >= 1e-9 else 1e-9
    t = -d / nr
    depth = t * ray[2]
    return depth if (t > 0 and 0 < depth <= lcfg["depth_max"]) else -1.0


def depths(cloud_veh, ok, uv_feat, cam, image_size, lcfg, gcfg,
           use_gp=True):
    """Per feature (the program's positions ``uv_feat`` [k,2]): the depth
    (-1 none) and whether float32 can not decide it; and the plane
    (normal, d, ok) in the vehicle frame."""
    ok = np.asarray(ok, bool)
    pc = to_camera(cloud_veh, cam.T_cam_veh)
    uv_feat = np.asarray(uv_feat, np.float64)
    nb, amb = neighbours(pc, ok, uv_feat, cam, image_size, lcfg)
    d = np.full(len(uv_feat), -1.0)
    for a in range(len(uv_feat)):
        d[a], bin_amb = object_depth(pc[nb[a]], uv_feat[a], cam, lcfg)
        amb[a] |= bin_amb
    plane = (np.array([0.0, 0.0, 1.0]), 0.0, False)
    if use_gp:
        n, dv, inl, pok = groundplane(cloud_veh, ok, gcfg)
        plane = (n, dv, pok)
        if pok:
            R = plain.rotmat(np.asarray(cam.T_cam_veh[:4], np.float64))
            n_cam = R @ n
            d_cam = dv - float(n_cam @ np.asarray(cam.T_cam_veh[4:]))
            gnb, gamb = neighbours(pc, inl, uv_feat, cam, image_size, lcfg)
            for a in np.flatnonzero(d < 0):
                d[a] = ground_depth(pc[gnb[a]], uv_feat[a], n_cam, d_cam,
                                    cam, lcfg)
                amb[a] |= gamb[a]
    return d, amb, plane
