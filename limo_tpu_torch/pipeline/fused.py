"""The fused sensor → pose pipeline: images + lidar clouds in, poses out.

The reference package's ``limo_tpu/pipeline/fused.py`` on the card. The
reference runs its whole launch graph online — gamma → viso tracking →
lidar depth → semantic labels → keyframe BA
(``launch/kitti_standalone.launch:10-57``, ``mono_lidar.cpp:88-373``);
here the tracker, a device-side track table, the lidar depth front end,
the RANSAC groundplane, the label sampling and the scan-odometry step run
on the card with no host work per frame but the scan step's one read of
its solve decision.

Per chunk of frames, three passes (:func:`make_fused_runner`):

  1. gamma + ``detect`` batched over the chunk's frames, and the label
     sampling at the features beside it;
  2. the lidar front end (``frontend_depth_plane``) frame by frame, so the
     [P,600] RANSAC temporaries stay one frame's size;
  3. the sequential step (:func:`make_fused_step`), frame by frame: guided
     matching against the previous frame, the track table (a matched
     feature keeps its predecessor's landmark slot, a new one takes a free
     slot by rank), the per-slot (u,v,d)/valid/label channels, and the
     scan-odometry step (:func:`~limo_tpu_torch.pipeline.scan_odometry.
     make_scan_step`) on them.

The host loop (:func:`run_fused`) chunks frames so upload buffers stay
bounded; the final partial chunk is padded by replaying the last frame
(padded outputs are dropped; the state is not reused afterwards). Each
chunk's inputs go up under ``limo.upload`` (:func:`upload`). The runner's
``front_stats`` (:class:`FrontStats`) counts what the front end saw and
dropped, on the device, for one read after the frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import LimoConfig
from ..frontend import tracker as trk
from ..frontend.semantics import dilate_labels, sample_labels
from ..geometry import pose as pose_ops
from ..geometry import pose_host
from ..geometry.camera import backproject
from ..utils.precision import full_f32
from ..utils.profiling import span, traced
from ..window_manager import DEFAULT_OUTLIER_LABELS
from . import scan_odometry as so
from .full import LimoPipelineConfig, frontend_depth_plane


class FusedState(NamedTuple):
    scan: so.ScanState
    prev_uv: torch.Tensor        # [N,2] previous frame's features
    prev_desc: torch.Tensor      # [N,D]
    prev_valid: torch.Tensor     # [N]
    slot_of_feat: torch.Tensor   # [N] int32 landmark slot per feature (-1)
    prev_depth: torch.Tensor     # [N] lidar depth of the previous features
                                 # (-1 none): the guided match prediction
    prev_matches: torch.Tensor   # int32 — last frame's match count; the
                                 # matcher trusts motion predictions only
                                 # while matching is healthy


class FusedOut(NamedTuple):
    pose: torch.Tensor           # [7] vehicle←origin per frame
    is_keyframe: torch.Tensor
    solved: torch.Tensor
    cost: torch.Tensor
    n_tracks: torch.Tensor       # live tracks holding a slot this frame
    n_matches: torch.Tensor      # feature matches to the previous frame
    n_depth: torch.Tensor        # features with a valid lidar depth
    prior: torch.Tensor          # [7] motion prior
    refined: torch.Tensor        # [7] raw pose-only result
    speed_obs: torch.Tensor      # lidar range-rate speed observation (m/s)
    n_rate: torch.Tensor         # int32 — depth-carrying persisting slots
    po_ok: torch.Tensor          # bool
    n_usable: torch.Tensor       # int32


@dataclass
class FrontStats:
    """Counts of the fused front end over the frames it ran. The device
    counts add up on the card (no host read per frame); :meth:`read` reads
    them once.

    - ``cloud_overflow`` (host): returns past ``cloud_capacity`` that
      :func:`pad_clouds` dropped;
    - on the device, summed over the frames: ``cell_overflow``, the
      returns each feature's search cells held past ``points_per_cell``
      (``lidar_depth.gather_neighbors``); ``detected``, valid features;
      ``with_depth``, valid features with a lidar depth; ``plane_ok``,
      frames whose RANSAC ground plane held.
    """

    frames: int = 0
    cloud_overflow: int = 0
    counts: Optional[torch.Tensor] = None   # int64 [4], the device counts

    DEVICE = ("cell_overflow", "detected", "with_depth", "plane_ok")

    def add(self, *counts):
        c = torch.stack([x.to(torch.int64).reshape(()) for x in counts])
        self.counts = c if self.counts is None else self.counts + c

    def read(self) -> dict:
        """Every count, the device ones read back in one copy."""
        dev = ([0] * len(self.DEVICE) if self.counts is None
               else self.counts.tolist())
        return {"frames": self.frames, "cloud_overflow": self.cloud_overflow,
                **dict(zip(self.DEVICE, dev))}


def init_fused_state(cfg: LimoConfig, pcfg: LimoPipelineConfig,
                     dtype=torch.float32, device="cuda") -> FusedState:
    N = pcfg.tracker.max_features
    D = 3 * pcfg.tracker.patch * pcfg.tracker.patch
    kw = dict(dtype=dtype, device=device)
    return FusedState(
        scan=so.init_state(cfg.capacity, dtype, cfg.prior.default_speed,
                           device),
        prev_uv=torch.zeros((N, 2), **kw),
        prev_desc=torch.zeros((N, D), **kw),
        prev_valid=torch.zeros((N,), dtype=torch.bool, device=device),
        slot_of_feat=torch.full((N,), -1, dtype=torch.int32, device=device),
        prev_depth=torch.full((N,), -1.0, **kw),
        prev_matches=torch.zeros((), dtype=torch.int32, device=device),
    )


def _assign_slots(prev_index, prev_slot_of_feat, feat_valid, lm_valid):
    """Track-table update: inherited slots for matched features, free slots
    for new ones, by a stable sort and a cumulative rank (no scatter).

    Returns slot [N] int32 (-1 = no slot). Injective: mutual-NN matching
    makes ``prev_index`` injective over matches, and free slots are
    assigned by distinct ranks."""
    N = prev_index.shape[0]
    L = lm_valid.shape[0]
    none = torch.full_like(prev_index, -1)
    inh = torch.where(prev_index >= 0,
                      prev_slot_of_feat[torch.clamp(prev_index, 0, N - 1)
                                        .long()], none)
    inh = torch.where(feat_valid, inh, none)
    has_inh = inh >= 0

    # slots in use: live window landmarks + slots inherited this frame
    slots = torch.arange(L, device=lm_valid.device)
    used = lm_valid | (inh[:, None] == slots[None, :]).any(0)
    free_slots = torch.argsort(used.to(torch.uint8), stable=True)
    n_free = (~used).sum()

    need_new = feat_valid & ~has_inh
    new_rank = torch.cumsum(need_new.to(torch.int32), 0) - 1
    new_slot = free_slots[torch.clamp(new_rank, 0, L - 1)].to(torch.int32)
    got_new = need_new & (new_rank < n_free)
    return torch.where(has_inh, inh,
                       torch.where(got_new, new_slot, none)).to(torch.int32)


def _slot_channels(slot, ok, uvd_feat, lab_f, L):
    """Per-slot (u,v,d), validity and label from the per-feature channels.
    The slot map is injective, so each live slot takes exactly one feature:
    an exact gather where the reference sums a one-hot product (empty
    slots: zeros and label -2)."""
    hit = (slot[:, None] == torch.arange(L, device=slot.device)[None, :]) \
        & ok[:, None]                                          # [N,L]
    valid_slot = hit.any(0)
    feat = torch.argmax(hit.to(torch.uint8), 0)                # [L]
    uvd_slot = torch.where(valid_slot[:, None], uvd_feat[feat],
                           torch.zeros_like(uvd_feat[:1]))
    lab_slot = torch.where(valid_slot, lab_f[feat].to(torch.int32),
                           torch.full_like(feat, -2, dtype=torch.int32))
    return uvd_slot, valid_slot, lab_slot


def predict_uv(fst: FusedState, rig, tcfg: trk.TrackerConfig):
    """The guided match prediction: every previous feature projected
    through the constant-velocity vehicle motion at its lidar depth (or the
    anchor depth), trusted only while last frame's matching was healthy
    (else the previous positions: descriptor-only mutual NN). Returns
    (pred_uv [N,2], pred_known [N])."""
    dtype = fst.prev_uv.dtype
    f0 = rig.focal[0].to(dtype)
    pp0 = rig.principal[0].to(dtype)
    tcv = rig.T_cam_veh[0].to(dtype)
    has_d = fst.prev_depth > 0
    d_pred = torch.where(has_d, fst.prev_depth,
                         torch.full_like(fst.prev_depth, tcfg.depth_anchor_m))
    p_cam = backproject(fst.prev_uv, d_pred, f0[None], pp0)
    p_cam2 = pose_ops.apply(
        tcv, pose_ops.apply(fst.scan.vel,
                            pose_ops.apply(pose_ops.inverse(tcv), p_cam)))
    z2 = p_cam2[:, 2]
    motion_pred = torch.where(
        (z2 > 0.5)[:, None],
        f0 * p_cam2[:, :2] / torch.clamp_min(z2, 0.5)[:, None] + pp0,
        fst.prev_uv)
    trusted = (fst.prev_matches >= 30) & (fst.scan.n_kf > 0) & tcfg.guided
    return torch.where(trusted, motion_pred, fst.prev_uv), has_d & trusted


def make_fused_step(rig, cfg: LimoConfig, pcfg: LimoPipelineConfig):
    """Build ``step(FusedState, frame) -> (FusedState, FusedOut)`` with
    ``frame = (stamp, uv_f [N,2], desc_f [N,D], valid_f [N], d_f [N],
    lab_f [N], plane [4], plane_ok)``: the per-feature channels the
    runner's first two passes computed. The step holds only the sequential
    work: guided matching, the track table, the per-slot channels and the
    scan-odometry step. ``step.stats`` is the scan step's
    :class:`~limo_tpu_torch.pipeline.scan_odometry.ScanStats`."""
    tcfg = pcfg.tracker
    L = cfg.capacity.max_landmarks
    hog = cfg.landmark_selection.height_over_ground
    scan_step = so.make_scan_step(rig, cfg)

    @traced("limo.fused_step")
    @full_f32
    def step(fst: FusedState, frame):
        stamp, uv_f, desc_f, valid_f, d_f, lab_f, plane, plane_ok = frame
        dtype = fst.prev_uv.dtype
        dev = uv_f.device

        # ---- 1. guided matching -----------------------------------------
        with span("limo.match"):
            pred_uv, pred_known = predict_uv(fst, rig, tcfg)
            zeros = torch.zeros_like(valid_f, dtype=dtype)
            feats = trk.Features(uv=uv_f, response=zeros, desc=desc_f,
                                 valid=valid_f)
            prev = trk.Features(uv=fst.prev_uv, response=zeros,
                                desc=fst.prev_desc, valid=fst.prev_valid)
            m = trk.match(feats, prev, tcfg, pred_uv=pred_uv,
                          pred_known=pred_known)

        # ---- 2. the track table and 3. the per-slot channels ------------
        with span("limo.track_table"):
            slot = _assign_slots(m.prev_index, fst.slot_of_feat, valid_f,
                                 fst.scan.window.lm_valid)
            ok = valid_f & (slot >= 0)
            e = torch.arange(4, device=dev)
            default_plane = (e == 2).to(dtype) + (e == 3).to(dtype) * hog
            plane = torch.where(plane_ok, plane.to(dtype), default_plane)
            uvd_feat = torch.cat([uv_f, d_f[:, None]], -1)
            uvd_slot, valid_slot, lab_slot = _slot_channels(
                slot, ok, uvd_feat, lab_f, L)

        # ---- 4. the scan-odometry step (prior → pose-only → gates →
        # push → labels → throttled windowed solve) ---------------------
        no_prior = (torch.arange(7, device=dev) == 0).to(dtype)
        no_flag = torch.zeros((L,), dtype=torch.bool, device=dev)
        frame2 = (stamp, uvd_slot, valid_slot, lab_slot, no_flag, plane,
                  plane_ok, no_prior, no_flag[0])
        scan2, out = scan_step(fst.scan, frame2)

        fst2 = FusedState(scan=scan2, prev_uv=uv_f, prev_desc=desc_f,
                          prev_valid=valid_f, slot_of_feat=slot,
                          prev_depth=d_f, prev_matches=m.n_matches)
        return fst2, FusedOut(
            pose=out.pose, is_keyframe=out.is_keyframe, solved=out.solved,
            cost=out.cost, n_tracks=ok.sum(dtype=torch.int32),
            n_matches=m.n_matches,
            n_depth=(ok & (d_f > 0)).sum(dtype=torch.int32),
            prior=out.prior, refined=out.refined,
            speed_obs=out.speed_obs, n_rate=out.n_rate, po_ok=out.po_ok,
            n_usable=out.n_usable)

    step.stats = scan_step.stats
    return step


def make_fused_runner(rig, cfg: LimoConfig, pcfg: LimoPipelineConfig,
                      image_size, with_labels: bool,
                      outlier_labels=DEFAULT_OUTLIER_LABELS):
    """The chunk runner ``runner(state, xs) -> (state, FusedOut [n])`` with
    ``xs = (stamps [n], images_u8 [n,H,W], clouds [n,P,3], cloud_valid
    [n,P], label_images [n,H,W] or None)`` on the card: the front end
    (``runner.front_end(xs)``: gamma + batched detect + labels, then the
    lidar front end frame by frame) and then ``runner.step``
    (:func:`make_fused_step`) frame by frame. ``runner.stats`` counts the
    scan step's frames, host reads and solves; ``runner.front_stats``
    (:class:`FrontStats`) the front end's features, depths, planes and
    dropped returns."""
    tcfg = pcfg.tracker
    lcfg = pcfg.lidar
    inv_gamma = 1.0 / pcfg.gamma
    step = make_fused_step(rig, cfg, pcfg)
    out_tab = torch.as_tensor(sorted(outlier_labels), dtype=torch.int32,
                              device=rig.focal.device)
    front_stats = FrontStats()

    @full_f32
    def front_end(xs, dtype):
        """Per-feature channels of the chunk's frames: (stamps, uv, desc,
        valid, depth, label, plane, plane_ok), each with a frame axis."""
        stamps, imgs_u8, clouds, cloud_valid, label_imgs = xs
        with span("limo.gamma_detect"):
            imgs = (imgs_u8.to(dtype) / 255.0) ** inv_gamma
            feats = trk.detect(imgs, tcfg)
        with span("limo.labels"):
            if with_labels:
                li = label_imgs.to(torch.int32)
                lab_f = sample_labels(
                    dilate_labels(li, torch.isin(li, out_tab)), feats.uv)
            else:
                lab_f = torch.full(feats.valid.shape, -2, dtype=torch.int32,
                                   device=imgs.device)
        tcv = rig.T_cam_veh[0].to(dtype)
        f0 = rig.focal[0].to(dtype)
        pp0 = rig.principal[0].to(dtype)
        per_frame = []
        for i in range(len(stamps)):
            with span("limo.depth_plane"):
                per_frame.append(frontend_depth_plane(
                    clouds[i], cloud_valid[i], tcv, feats.uv[i], f0, pp0,
                    image_size, lcfg, pcfg.use_groundplane,
                    tuple(pcfg.gp_band)))
        d_f, planes, planes_ok, over = (torch.stack(x)
                                        for x in zip(*per_frame))
        front_stats.frames += len(stamps)
        front_stats.add(over.sum(), feats.valid.sum(),
                        (feats.valid & (d_f > 0)).sum(), planes_ok.sum())
        return (stamps, feats.uv, feats.desc, feats.valid, d_f, lab_f,
                planes, planes_ok)

    def runner(st: FusedState, xs):
        frames = front_end(xs, st.prev_uv.dtype)
        outs = []
        for i in range(len(frames[0])):
            st, out = step(st, tuple(f[i] for f in frames))
            outs.append(out)
        return st, FusedOut(*[torch.stack(f) for f in zip(*outs)])

    runner.front_end = front_end
    runner.step = step
    runner.stats = step.stats
    runner.front_stats = front_stats
    return runner


def upload(arrays, device, dtypes=None):
    """A frame's or a chunk's inputs to ``device`` under ``limo.upload``:
    each array (NumPy or a host tensor; None stays None) as a tensor there,
    in ``dtypes[i]`` where given. From pinned host tensors the copies run
    asynchronously on the current stream."""
    dtypes = dtypes or [None] * len(arrays)
    with span("limo.upload"):
        return [None if a is None else torch.as_tensor(a).to(
            device=device, dtype=dt, non_blocking=True)
            for a, dt in zip(arrays, dtypes)]


def pad_clouds(clouds, capacity: int, dtype=np.float32,
               stats: Optional[FrontStats] = None):
    """List of [Ni,3] arrays → ([F,capacity,3], [F,capacity] valid); the
    returns past ``capacity`` are dropped, and counted in
    ``stats.cloud_overflow`` where ``stats`` is given."""
    F = len(clouds)
    buf = np.zeros((F, capacity, 3), dtype)
    msk = np.zeros((F, capacity), bool)
    for i, c in enumerate(clouds):
        n = min(len(c), capacity)
        buf[i, :n] = np.asarray(c, dtype)[:n, :3]
        msk[i, :n] = True
        if stats is not None:
            stats.cloud_overflow += len(c) - n
    return buf, msk


def chunks(stamps, images_u8, clouds, pcfg: LimoPipelineConfig,
           label_images=None, chunk: Optional[int] = None,
           dtype=torch.float32, device="cuda",
           stats: Optional[FrontStats] = None):
    """Yield (number of real frames, xs on ``device``) per chunk of
    :func:`run_fused`'s input; the final partial chunk replays its last
    frame up to the chunk size. Clouds are padded to ``cloud_capacity`` in
    the run's float type (the returns past it counted in
    ``stats.cloud_overflow``) and stamps take the window's stamp type."""
    F = len(stamps)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    if isinstance(clouds, np.ndarray) and clouds.ndim == 3:
        cloud_arr = clouds.astype(np_dtype)
        cloud_msk = np.any(cloud_arr != 0.0, -1)
    else:
        cloud_arr, cloud_msk = pad_clouds(clouds, pcfg.cloud_capacity,
                                          np_dtype, stats)
    stamps = np.asarray(stamps, np_dtype)
    stamp_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    chunk = F if not chunk else min(chunk, F)
    for lo in range(0, F, chunk):
        hi = min(lo + chunk, F)
        idx = np.arange(lo, hi)
        if hi - lo < chunk:               # pad final chunk: replay last frame
            idx = np.concatenate([idx, np.full(chunk - (hi - lo), hi - 1)])
        labels = (None if label_images is None
                  else np.asarray(label_images)[idx])
        host = [np.ascontiguousarray(a) for a in (
            stamps[idx], images_u8[idx], cloud_arr[idx], cloud_msk[idx])]
        yield hi - lo, tuple(upload(host + [labels], device,
                                    [stamp_dtype, None, None, None, None]))


def run_fused(stamps, images_u8, clouds, rig, cfg: LimoConfig,
              pcfg: LimoPipelineConfig, label_images=None,
              chunk: Optional[int] = None, dtype=torch.float32,
              state: Optional[FusedState] = None, device="cuda",
              runner=None):
    """Run a whole image+cloud sequence through the fused pipeline.

    stamps [F]; images_u8 [F,H,W] uint8; clouds: a list of [Ni,3]
    vehicle-frame scans (or a pre-padded [F,P,3] array, all-zero rows
    invalid); label_images [F,H,W] uint8 or None. ``chunk`` bounds the
    frames uploaded at once (default: the whole sequence); ``rig`` must
    live on ``device``; ``runner`` may pass a :func:`make_fused_runner` of
    the same arguments, to read its ``stats`` afterwards. Returns
    (FusedState, FusedOut with a frame axis, on the device).

    The reference pads clouds and stamps in float32 whatever the run's
    float type (its float64 run then fails: the scan carry's stamp type
    changes); here they take the run's float type, so a float32 run is the
    reference's and a float64 run is float64 throughout."""
    H, W = images_u8.shape[1:3]
    if runner is None:
        runner = make_fused_runner(rig, cfg, pcfg, (W, H),
                                   label_images is not None)
    st = state if state is not None else init_fused_state(cfg, pcfg, dtype,
                                                          device)
    outs = []
    for n, xs in chunks(stamps, images_u8, clouds, pcfg, label_images, chunk,
                        dtype, device, runner.front_stats):
        st, out = runner(st, xs)
        outs.append(FusedOut(*[x[:n] for x in out]))
    return st, FusedOut(*[torch.cat(f) for f in zip(*outs)])


def poses_kitti(out: FusedOut) -> np.ndarray:
    """FusedOut → [F,4,4] KITTI origin←vehicle matrices (host numpy)."""
    return pose_host.to_matrix(pose_host.inverse(
        np.asarray(torch.as_tensor(out.pose).cpu(), np.float64)))
