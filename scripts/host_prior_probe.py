"""The 5-point prior and the motion-only solve on the host-engine drive.

    python scripts/host_prior_probe.py record --upto 137 \
        --dump-frames 132,133,134,135,136 --out build/probe_200.npz
    python scripts/host_prior_probe.py compare build/probe_200.npz \
        --first 130 --last 136
    python scripts/host_prior_probe.py pose_only build/probe_200.npz
    python scripts/host_prior_probe.py record --upto 60 \
        --out build/probe_60.npz
    python scripts/host_prior_probe.py spread build/probe_60.npz
    python scripts/host_prior_probe.py draws --package reference \
        --seeds 0,1,2,3

``record`` writes the 200-frame host-engine gate world
(``limo_tpu_torch.entry.kitti_host_drive``) and runs the port's host engine
over its first ``--upto`` frames on the CPU in float32. It saves every
5-point prior call's inputs, each frame's prior and motion-only poses, the
keyframe and solve flags, the estimated and the true poses, and with
``--dump-frames`` the BundleAdjuster's state and inputs before those
frames' motion-only solves (OUT.pkl). It prints each frame's position
error after a rigid alignment on the first 20 frames, then the keyframes,
solves and ATE.

``compare`` runs ``estimate_essential`` on the recorded pairs of frames
``--first``..``--last``: the reference package in float32 (JAX on the CPU,
its own nullspace basis), the port in float32 on the reference's float32
basis and on its own, and the port in float64. It prints each result's
inliers, its rotation and translation-direction errors against the true
motion, and whether its inlier set equals the reference's (the same RANSAC
winner). On the reference's basis it also measures the float32
determinants of M(z) at the 24 Chebyshev nodes against float64 (the
largest error over the nodes over the largest float64 determinant, median
over the hypotheses) for PyTorch and for JAX, and the real roots found per
hypothesis in each.

``pose_only`` replays the dumped motion-only solves from the same state and
inputs: the port in float32 and float64 and the reference package in
float32, each pose's rotation and position error against the truth.

``spread`` holds the port's float32 and float64 calls on every recorded
pair against its float64 call, each also under four random orthonormal
bases of the nullspace (a cuSOLVER basis differs from LAPACK's): the
largest rotation and translation-direction gaps (rad) and inlier flips
(share of the matches), over all pairs and over frames 15, 30 and 45, and
their 50th-99th percentiles over all calls, and the share of calls within
``chip_smoke.HOST_ESSENTIAL_TOL``, which is set from them.

``draws`` runs ``scripts/host_drive.py``'s 200-frame drive once per
5-point RANSAC seed (the prior's ``seed``; 0 is the pipeline's own) through
either package, the port on the card unless ``--device cpu`` asks for the
CPU, and prints one JSON line per seed: ATE, drift, keyframes and solves.
"""

import argparse
import copy
import dataclasses
import json
import os
import pickle
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHECKED = (15, 30, 45)


def record(args):
    import torch
    from chip_smoke import recording_host
    from limo_tpu_torch import entry
    from limo_tpu_torch.io import kitti
    from limo_tpu_torch.pipeline import evaluation
    from limo_tpu_torch.pipeline.metrics import ate_rmse, umeyama_alignment
    from limo_tpu_torch.state import BUNDLE_ADJUSTER_STATE
    from limo_tpu_torch.window_manager import BundleAdjuster
    dump_frames = {int(f) for f in args.dump_frames.split(",") if f}
    steps, dumps, inner = [], {}, BundleAdjuster.adjust_pose_only

    def adjust_pose_only(self, stamp, pose_prior, tracklets,
                         track_camera=None):
        f = len(rec["frames"])
        if f in dump_frames:
            dumps[f] = {"state": {k: copy.deepcopy(getattr(self, k))
                                  for k in BUNDLE_ADJUSTER_STATE},
                        "stamp": stamp, "pose_prior": np.array(pose_prior),
                        "tracklets": copy.deepcopy(tracklets),
                        "cfg": self.cfg}
        out = inner(self, stamp, pose_prior, tracklets, track_camera)
        steps.append((f, np.array(pose_prior), np.array(out)))
        return out

    BundleAdjuster.adjust_pose_only = adjust_pose_only
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "seq")
        gt, pcfg = entry.kitti_host_drive(args.frames, root)
        out = os.path.join(tmp, "poses.txt")
        with recording_host(lambda: None) as rec:
            evaluation.evaluate_kitti_sequence(
                root, out, gt, max_frames=args.upto, cfg=pcfg, device="cpu")
        est, true = kitti.read_poses(out), kitti.read_poses(gt)[:args.upto]
    BundleAdjuster.adjust_pose_only = inner
    if dumps:
        with open(args.out + ".pkl", "wb") as fh:
            pickle.dump(dumps, fh)
    # positions after a rigid alignment on the first 20 frames
    n = min(20, args.upto)
    R, t, _ = umeyama_alignment(est[:n, :3, 3], true[:n, :3, 3], False)
    err = np.linalg.norm(est[:, :3, 3] @ R.T + t - true[:, :3, 3], axis=-1)
    for i, e in enumerate(err):
        print(f"frame {i:3d}: position error {e:.4f} m")
    pairs = {}
    for j, (frame, a, kw) in enumerate(rec["priors"]):
        pairs[f"frame_{j}"] = frame
        for name, x in zip(("uv0", "uv1", "mask", "focal", "pp"), a):
            pairs[f"{name}_{j}"] = x.cpu().numpy()
    kw = rec["priors"][0][2]
    np.savez(args.out, n_pairs=len(rec["priors"]),
             kw=json.dumps(kw), est=est, true=true,
             keyframe=[r.is_keyframe for r, _ in rec["frames"]],
             solved=[r.solved for r, _ in rec["frames"]],
             step_frame=[f for f, _, _ in steps],
             step_prior=[p for _, p, _ in steps],
             step_adjusted=[a for _, _, a in steps], **pairs)
    print(json.dumps({"frames": args.upto,
                      "keyframes": int(sum(r.is_keyframe
                                           for r, _ in rec["frames"])),
                      "solves": int(sum(r.solved for r, _ in rec["frames"])),
                      "ate_m": ate_rmse(true, est),
                      "pairs": len(rec["priors"]),
                      "max_position_error_m": float(err.max()),
                      "first_frame_over_1m": int(np.argmax(err > 1.0))
                      if (err > 1.0).any() else None, "out": args.out}))


def load_pairs(path):
    z = np.load(path)
    kw = json.loads(str(z["kw"]))
    pairs = [{"frame": int(z[f"frame_{j}"]),
              **{k: z[f"{k}_{j}"] for k in ("uv0", "uv1", "mask", "focal",
                                            "pp")}}
             for j in range(int(z["n_pairs"]))]
    return z, kw, pairs


def last_keyframe(keyframe, frame):
    return max(k for k in range(frame) if keyframe[k])


def true_motion(true, k, f):
    """(R, t) with x_f = R x_k + t from the KITTI cam0 poses."""
    T = np.linalg.inv(true[f]) @ true[k]
    return T[:3, :3], T[:3, 3]


def rot_of(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def angle(R):
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def direction_gap(a, b):
    n = np.linalg.norm(a) * np.linalg.norm(b)
    return float(np.arccos(np.clip(np.dot(a, b) / n, -1, 1))) if n else 0.0


def as_numpy(res):
    return {k: np.asarray(getattr(res, k), np.float64 if k in ("q", "t")
                          else None) for k in ("q", "t", "inliers",
                                               "n_inliers", "ok")}


def compare(args):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from limo_tpu.frontend import essential as je
    from limo_tpu_torch.frontend import essential as te
    z, kw, pairs = load_pairs(args.pairs)
    keyframe, true = z["keyframe"], z["true"]
    own = te._nullspace_basis

    def ref_basis(x0s, x1s):
        A = jax.vmap(je._epipolar_rows)(jnp.asarray(x0s.numpy()),
                                        jnp.asarray(x1s.numpy()))
        Vt = np.asarray(jax.vmap(
            lambda a: jnp.linalg.svd(a, full_matrices=True)[2])(A))
        return torch.from_numpy(Vt[:, 5:9].reshape(-1, 4, 3, 3).copy())

    def port(p, dtype, basis):
        te._nullspace_basis = basis
        try:
            a = [torch.from_numpy(p[k]) for k in ("uv0", "uv1", "mask",
                                                  "focal", "pp")]
            a = [x.to(dtype) if x.is_floating_point() else x for x in a]
            return as_numpy(te.estimate_essential(*a, **kw))
        finally:
            te._nullspace_basis = own

    rows = []
    for p in pairs:
        if not args.first <= p["frame"] <= args.last:
            continue
        k = last_keyframe(keyframe, p["frame"])
        R_true, t_true = true_motion(true, k, p["frame"])
        f32 = np.float32
        ref = as_numpy(je.estimate_essential(
            jnp.asarray(p["uv0"], f32), jnp.asarray(p["uv1"], f32),
            jnp.asarray(p["mask"]), jnp.asarray(p["focal"], f32),
            jnp.asarray(p["pp"], f32), **kw))
        runs = {"reference f32": ref,
                "port f32, reference basis":
                    port(p, torch.float32, ref_basis),
                "port f32, own basis": port(p, torch.float32, own),
                "port f64, own basis": port(p, torch.float64, own)}
        row = {"frame": p["frame"], "keyframe": k,
               "matches": int(p["mask"].sum()),
               "true_rotation_rad": angle(R_true)}
        for name, r in runs.items():
            row[name] = {
                "ok": bool(r["ok"]), "n_inliers": int(r["n_inliers"]),
                "rot_err_rad": angle(rot_of(r["q"]).T @ R_true),
                "t_err_rad": direction_gap(r["t"], t_true),
                "same_inliers_as_reference": bool(np.array_equal(
                    r["inliers"], ref["inliers"]))}
        row["determinants"] = det_errors(p, kw, ref_basis)
        rows.append(row)
        print(json.dumps(row))
    summary = {name: {
        "same_winner_as_reference": sum(r[name]["same_inliers_as_reference"]
                                        for r in rows),
        "max_rot_err_rad": max(r[name]["rot_err_rad"] for r in rows),
        "max_t_err_rad": max(r[name]["t_err_rad"] for r in rows)}
        for name in rows[0] if isinstance(rows[0][name], dict)
        and "ok" in rows[0][name]}
    print(json.dumps({"pairs": len(rows), "summary": summary}))


def det_errors(p, kw, ref_basis):
    """float32 against float64 determinants of M(z) at the nodes, and real
    roots per hypothesis, on the reference's float32 basis of the pair's
    minimal samples."""
    import jax
    import jax.numpy as jnp
    import torch
    from limo_tpu.frontend import essential as je
    from limo_tpu_torch.frontend import essential as te
    uv0, uv1 = (torch.from_numpy(p[k]).float() for k in ("uv0", "uv1"))
    focal, pp = (torch.from_numpy(p[k]).float() for k in ("focal", "pp"))
    mask = torch.from_numpy(p["mask"])
    x0, x1 = (uv0 - pp) / focal, (uv1 - pp) / focal
    sample = te._draw_samples(mask, kw.get("num_hypotheses", 256), 5)
    basis = ref_basis(x0[sample], x1[sample])              # f32

    def torch_dets(b):
        c = te._constants(b.dtype, b.device)
        pts = c["p20"]
        B = b[:, None]
        Es = (pts[:, 0, None, None] * B[:, :, 0] + pts[:, 1, None, None]
              * B[:, :, 1] + pts[:, 2, None, None] * B[:, :, 2] + B[:, :, 3])
        C = c["vand_inv"] @ te._essential_constraints(Es)
        Mc = torch.einsum("hme,mzk->hzek", C, c["embed"])
        return torch.linalg.det(te._m_at(Mc, c["znodes"].expand(
            b.shape[0], -1))).double().numpy()

    def jax_dets(b):
        b = jnp.asarray(b.numpy())
        dt = b.dtype
        pts = jnp.asarray(je._P20, dt)

        def one(B):
            Es = (pts[:, 0, None, None] * B[0] + pts[:, 1, None, None] * B[1]
                  + pts[:, 2, None, None] * B[2] + B[3])
            C = jnp.asarray(je._VAND_INV, dt) @ jax.vmap(
                je._essential_constraints)(Es)
            Mc = jnp.einsum("me,mzk->zek", C, jnp.asarray(je._EMBED, dt))
            zs = jnp.asarray(je._ZNODES, dt)
            Ms = (Mc[0][None] + zs[:, None, None] * Mc[1]
                  + (zs ** 2)[:, None, None] * Mc[2]
                  + (zs ** 3)[:, None, None] * Mc[3])
            return jnp.linalg.det(Ms)
        return np.asarray(jax.vmap(one)(b), np.float64)

    d64 = torch_dets(basis.double())
    scale = np.abs(d64).max(-1)
    rel = lambda d: float(np.median(np.abs(d - d64).max(-1) / scale))
    _, v32 = te._solutions(basis)
    _, v64 = te._solutions(basis.double())
    _, vj = jax.vmap(lambda a, b: je._five_point_one(a, b, jnp.float32))(
        jnp.asarray(x0[sample].numpy()), jnp.asarray(x1[sample].numpy()))
    return {"torch_f32_rel_err": rel(torch_dets(basis)),
            "jax_f32_rel_err": rel(jax_dets(basis)),
            "roots_per_hypothesis": {
                "torch_f32": float(v32.sum(-1).float().mean()),
                "jax_f32": float(np.asarray(vj).sum(-1).mean()),
                "torch_f64": float(v64.sum(-1).float().mean())}}


def from_dict(cls, d):
    """A nested config dataclass of either package from ``asdict``."""
    default = cls()
    kv = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        sub = getattr(default, f.name)
        kv[f.name] = (from_dict(type(sub), v)
                      if dataclasses.is_dataclass(sub)
                      else tuple(v) if isinstance(v, list) else v)
    return cls(**kv)


def pose_only(args):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from limo_tpu.config import LimoConfig as JLimoConfig
    from limo_tpu.geometry.camera import CameraRig as JCameraRig
    from limo_tpu.window_manager import BundleAdjuster as JBundleAdjuster
    from limo_tpu_torch.geometry import pose_host as ph
    from limo_tpu_torch.geometry.camera import CameraRig
    from limo_tpu_torch.window_manager import BundleAdjuster
    z = np.load(args.pairs)
    true = z["true"]
    with open(args.pairs + ".pkl", "rb") as fh:
        dumps = pickle.load(fh)
    focal, cx, cy = 450.0, 256.0, 96.0      # entry.kitti_host_drive's camera

    def truth(f):
        T = np.linalg.inv(true[f]) @ true[0]    # frame f <- frame 0
        return T[:3, :3], T[:3, 3]

    def error(pose, f):
        R_true, t_true = truth(f)
        T = ph.to_matrix(np.asarray(pose, np.float64))
        return (angle(T[:3, :3].T @ R_true),
                float(np.linalg.norm(T[:3, 3] - t_true)))

    rows = []
    for f, d in sorted(dumps.items()):
        port_cfg = d["cfg"]
        runs = {}
        for name, dt in (("port f32", torch.float32),
                         ("port f64", torch.float64)):
            ba = BundleAdjuster(CameraRig.single(focal, cx, cy, dtype=dt,
                                                 device="cpu"),
                                port_cfg, dt, "cpu")
            for k, v in d["state"].items():
                setattr(ba, k, copy.deepcopy(v))
            runs[name] = ba.adjust_pose_only(d["stamp"], d["pose_prior"],
                                             d["tracklets"])
        jba = JBundleAdjuster(JCameraRig.single(focal, cx, cy),
                              from_dict(JLimoConfig,
                                        dataclasses.asdict(port_cfg)),
                              jnp.float32)
        for k, v in d["state"].items():
            setattr(jba, k, copy.deepcopy(v))
        runs["reference f32"] = np.asarray(jba.adjust_pose_only(
            d["stamp"], d["pose_prior"], d["tracklets"]), np.float64)
        row = {"frame": f, "prior": dict(zip(("rot_err_rad", "t_err_m"),
                                             error(d["pose_prior"], f)))}
        for name, pose in runs.items():
            row[name] = dict(zip(("rot_err_rad", "t_err_m"), error(pose, f)))
        rows.append(row)
        print(json.dumps(row))


def spread(args):
    import torch
    from chip_smoke import essential_gap
    from limo_tpu_torch.frontend import essential as te
    _, kw, pairs = load_pairs(args.pairs)
    own = te._nullspace_basis
    gen = torch.Generator().manual_seed(args.seed)
    mixes = [torch.linalg.qr(torch.randn(4, 4, generator=gen,
                                         dtype=torch.float64))[0]
             for _ in range(4)]

    def mixed(Q):
        def basis(x0s, x1s):
            b = own(x0s, x1s)
            return (Q.to(b.dtype) @ b.reshape(-1, 4, 9)).reshape(b.shape)
        return basis

    def call(p, dtype, basis):
        te._nullspace_basis = basis
        try:
            a = [torch.from_numpy(p[k]) for k in ("uv0", "uv1", "mask",
                                                  "focal", "pp")]
            a = [x.to(dtype) if x.is_floating_point() else x for x in a]
            return te.estimate_essential(*a, **kw)
        finally:
            te._nullspace_basis = own

    worst = {name: {"all": [0.0, 0.0, 0.0, 0], "checked": [0.0, 0.0, 0.0, 0]}
             for name in ("float64", "float32")}
    calls = {name: [] for name in worst}
    for p in pairs:
        base = call(p, torch.float64, own)
        m = int(p["mask"].sum())
        for name in worst:
            for basis in [own] * (name == "float32") + [mixed(Q) for Q in
                                                         mixes]:
                got = call(p, getattr(torch, name), basis)
                rot, tra, flips = essential_gap(base, got)
                gaps = (rot, tra, flips / max(m, 1),
                        int(bool(got.ok) != bool(base.ok)))
                calls[name].append(gaps[:3])
                for scope in ("all", "checked"):
                    if scope == "checked" and p["frame"] not in CHECKED:
                        continue
                    w = worst[name][scope]
                    worst[name][scope] = [max(a, b) for a, b in zip(w, gaps)]
        print(f"frame {p['frame']:3d}: {m} matches, {json.dumps(worst)}",
              flush=True)
    from chip_smoke import HOST_ESSENTIAL_TOL
    quantiles = {name: {f"q{q}": np.percentile(np.array(c), q, axis=0)
                        .tolist() for q in (50, 90, 95, 99)}
                 for name, c in calls.items()}
    within = {name: float(np.mean(np.all(np.array(c) <= np.array(
        HOST_ESSENTIAL_TOL[name]), axis=1))) for name, c in calls.items()}
    sorted_t = {name: sorted(round(g[1], 3) for g in c)[-8:]
                for name, c in calls.items()}
    print(json.dumps({"pairs": len(pairs), "checked_frames": CHECKED,
                      "keys": ["rot_rad", "t_rad", "flip_share",
                               "ok_differs"], "worst": worst,
                      "quantiles_over_calls": quantiles,
                      "largest_t_rad": sorted_t,
                      "share_within_HOST_ESSENTIAL_TOL": within}))


def draws(args):
    import functools
    import importlib
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    host_drive = importlib.import_module("host_drive")
    device = args.device or ("cuda" if args.package == "port" else "cpu")
    if args.package == "reference":
        from limo_tpu.pipeline import odometry
    else:
        from limo_tpu_torch.pipeline import odometry
    estimate = odometry.estimate_essential
    for seed in (int(x) for x in args.seeds.split(",")):
        odometry.estimate_essential = functools.partial(estimate, seed=seed)
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "seq")
            if args.package == "reference":
                gt, pcfg, evaluate, _, kw = host_drive.reference_drive(
                    args.frames, root)
            else:
                gt, pcfg, evaluate, _, kw = host_drive.port_drive(
                    args.frames, root, device)
            rep = evaluate(root, os.path.join(tmp, "poses.txt"), gt,
                           cfg=pcfg, drift_kw={"lengths": (25.0, 50.0),
                                               "step": 5}, **kw)
        odometry.estimate_essential = estimate
        print(json.dumps({"package": args.package, "device": device,
                          "seed": seed, "frames": rep.n_frames,
                          "ate_m": rep.ate,
                          "drift_t_percent": rep.drift["t_err_percent"],
                          "drift_r_deg_per_m": rep.drift["r_err_deg_per_m"]}),
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("record")
    r.add_argument("--frames", type=int, default=200)
    r.add_argument("--upto", type=int, default=140)
    r.add_argument("--out", required=True)
    r.add_argument("--dump-frames", default="",
                   help="comma-separated frames whose motion-only solve "
                   "inputs go to OUT.pkl")
    c = sub.add_parser("compare")
    c.add_argument("pairs")
    c.add_argument("--first", type=int, default=0)
    c.add_argument("--last", type=int, default=10 ** 9)
    o = sub.add_parser("pose_only")
    o.add_argument("pairs")
    s = sub.add_parser("spread")
    s.add_argument("pairs")
    s.add_argument("--seed", type=int, default=0)
    d = sub.add_parser("draws")
    d.add_argument("--package", choices=("reference", "port"),
                   required=True)
    d.add_argument("--seeds", default="0,1,2,3")
    d.add_argument("--frames", type=int, default=200)
    d.add_argument("--device", choices=("cpu", "cuda"), default=None)
    args = ap.parse_args()
    {"draws": draws, "record": record, "compare": compare, "spread": spread,
     "pose_only": pose_only}[args.cmd](args)


if __name__ == "__main__":
    main()
