"""The plain reference of the scan step's semantics, in NumPy float64.

Written from the semantics the configuration states (LIMO's cost functors,
trimmer, keyframe schemes and motion model as the configuration's file
sets them), not from the program's modules: it imports nothing of the
program, takes no Jacobian from it (every derivative here is a central
difference of the residuals below) and eliminates landmarks with plain
block algebra. Arrays come in as NumPy (float64, the clock's stamps in
float32 as the configuration states its clock).

Conventions: a pose is ``[qw, qx, qy, qz, tx, ty, tz]`` with
``apply(p, x) = R(q) x + t``; keyframe poses map the origin into the
keyframe; a tangent step is ``[w (3), dt (3)]`` with ``q' = exp(w) * q``
(half-angle ``exp``) and ``t' = t + dt``; a plane ``[n, d]`` moves as
``n' = (n + dn) / |n + dn|``, ``d' = d + dd``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

Z_GUARD = 0.01      # |z| below this in the camera: no reprojection
FD_STEP = 1e-6      # central-difference step of every Jacobian here
# a relative cost decrease this close to a test's threshold is decided by
# float32 rounding (a float32 sum over ~10**3 robust terms is good to a few
# 1e-6); the motion-only solve follows both outcomes of such a test, up to
# MAX_PATHS paths
TIE = 1e-5
MAX_PATHS = 32


# ---------------------------------------------------------------- poses --

def qmul(a, b):
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], -1)


def qconj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def rotmat(q):
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def rotate(R, x):
    return np.matmul(R, x[..., None])[..., 0]


def apply(p, x):
    R = rotmat(p[..., :4])
    R, x = np.broadcast_arrays(R, x[..., None, :])
    return rotate(R, x[..., 0, :]) + p[..., 4:]


def compose(a, b):
    return np.concatenate([qmul(a[..., :4], b[..., :4]),
                           apply(a, b[..., 4:])], -1)


def inverse(p):
    qi = qconj(p[..., :4] / np.linalg.norm(p[..., :4], axis=-1,
                                           keepdims=True))
    return np.concatenate([qi, -rotate(rotmat(qi), p[..., 4:])], -1)


def relative(a, b):
    """a after the inverse of b."""
    return compose(a, inverse(b))


def normalize(p):
    return np.concatenate([p[..., :4] / np.linalg.norm(
        p[..., :4], axis=-1, keepdims=True), p[..., 4:]], -1)


def qexp(w):
    """Half-angle exponential: |w| is half the rotation angle."""
    n = np.linalg.norm(w, axis=-1, keepdims=True)
    small = n < 1e-6
    sinc = np.where(small, 1.0 - n * n / 6.0,
                    np.sin(n) / np.where(small, 1.0, n))
    return np.concatenate([np.cos(n), sinc * w], -1)


def qlog(q):
    """Inverse of :func:`qexp` on the hemisphere w >= 0."""
    q = q / np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    v = q[1:]
    vn = np.linalg.norm(v)
    if vn < 1e-9:
        return v * (2.0 - q[0])
    return v * np.arctan2(vn, np.clip(q[0], -1.0, 1.0)) / vn


def boxplus(p, d):
    return np.concatenate([qmul(qexp(d[..., :3]), p[..., :4]),
                           p[..., 4:] + d[..., 3:]], -1)


def qangle(a, b):
    """The rotation angle between two quaternions."""
    d = qmul(qconj(b) / np.sum(b * b), a)
    d = d / np.linalg.norm(d)
    return 2.0 * np.arccos(np.clip(abs(d[0]), 0.0, 1.0))


def plane_plus(pl, d):
    n = pl[..., :3] + d[..., :3]
    return np.concatenate([n / np.linalg.norm(n, axis=-1, keepdims=True),
                           pl[..., 3:] + d[..., 3:]], -1)


# ------------------------------------------------------------- residuals --

@dataclass
class Camera:
    focal: float
    principal: np.ndarray     # [2]
    T_cam_veh: np.ndarray     # [7]


def project_residual(pose, x, uvd, cam: Camera):
    """Reprojection (px) and depth (m) residuals of landmark ``x`` seen in
    keyframe ``pose`` as ``uvd``: (r [..., 3], z [...] in the camera)."""
    pc = apply(cam.T_cam_veh, apply(pose, x))
    z = pc[..., 2]
    safe = np.where(np.abs(z) >= Z_GUARD, z, 1.0)
    uv = cam.focal * pc[..., :2] / safe[..., None] + cam.principal
    return np.concatenate([uv - uvd[..., :2], (z - uvd[..., 2])[..., None]],
                          -1), z


def cauchy(s, a):
    """(cost rho(s) / 2, IRLS weight) of Cauchy(a) at squared norm s."""
    a2 = a * a
    return 0.5 * a2 * np.log1p(s / a2), 1.0 / (1.0 + s / a2)


def huber(s, delta):
    """(cost rho(s) / 2, IRLS weight) of Huber(delta) at squared norm s."""
    r = np.sqrt(np.maximum(s, 1e-20))
    rho = np.where(s <= delta * delta, s, 2.0 * delta * r - delta * delta)
    return 0.5 * rho, np.minimum(delta / r, 1.0)


def quantile_outliers(scores, valid, q):
    """The trimmer: the pivot is the valid scores' element at floor(q n)
    (the product formed in the configuration's float32), and every valid
    score strictly above it is an outlier."""
    n = int(valid.sum())
    idx = min(int(np.float32(q) * np.float32(n)), scores.shape[0] - 1)
    pivot = np.sort(np.where(valid, scores, np.inf))[idx]
    return valid & (scores > pivot)


# ------------------------------------------------- the motion-only solve --

class MotionOnly:
    """The frame's pose against fixed landmarks (``adjustPoseOnly``):
    Cauchy-weighted reprojection and depth residuals of the frame's
    observations of the state's landmarks, scaled by the landmark's
    weight."""

    def __init__(self, lm_pos, uvd, obs_mask, lm_weight, cam, robust):
        self.lm_pos, self.uvd, self.obs_mask = lm_pos, uvd, obs_mask
        self.lm_weight, self.cam, self.robust = lm_weight, cam, robust

    def residuals(self, pose):
        return project_residual(pose[None], self.lm_pos, self.uvd, self.cam)

    def masks(self, z, use):
        v = self.obs_mask & use
        return v & (np.abs(z) >= Z_GUARD), v & (self.uvd[:, 2] > 0) & (z > 0)

    def terms(self, r, z, use, smul=1.0):
        """(cost, IRLS row weights [L, 3]) at the Cauchy scales x smul."""
        ok_r, ok_d = self.masks(z, use)
        c_r, w_r = cauchy(np.sum(r[:, :2] ** 2, -1),
                          self.robust["reprojection_thres"] * smul)
        c_d, w_d = cauchy(r[:, 2] ** 2, self.robust["depth_thres"] * smul)
        wl = self.lm_weight
        cost = np.sum(np.where(ok_r, wl * c_r, 0.0)) \
            + np.sum(np.where(ok_d, wl * c_d, 0.0))
        w = np.stack([np.where(ok_r, wl * w_r, 0.0)] * 2
                     + [np.where(ok_d, wl * w_d, 0.0)], -1)
        return cost, w

    def cost(self, pose, use, smul=1.0):
        return self.terms(*self.residuals(pose), use, smul)[0]

    def jac(self, pose):
        J = np.empty((self.lm_pos.shape[0], 3, 6))
        for i in range(6):
            e = np.zeros(6)
            e[i] = FD_STEP
            J[:, :, i] = (self.residuals(boxplus(pose, e))[0]
                          - self.residuals(boxplus(pose, -e))[0]) \
                / (2 * FD_STEP)
        return J

    def solve(self, prior, lm_mask, solver):
        """An LM run of ``trim_iteration_lm_steps`` iterations, one
        quantile trim of each family, and ``pose_only_max_iterations``
        more; each run's iteration ``i`` widens the Cauchy scales by
        max(g / 2**i, 1) (graduated non-convexity, g =
        ``scan_pose_only_graduated_init``).

        Where an iteration's relative cost decrease lies within ``TIE`` of
        its accept test (0) or of its convergence test (the function
        tolerance), float32 rounding decides the test either way: the run
        follows both outcomes. Returns the results of every path, the path
        of exact float64 tests first, as (pose, the landmarks its last run
        used)."""
        robust = self.robust
        ginit = float(solver["scan_pose_only_graduated_init"])
        ftol = solver["function_tolerance"]

        def run(pose, use, iters):
            paths = [(pose, solver["initial_lambda"], 0, False)]
            for _ in range(iters):
                nxt = []
                for pose, lam, it, done in paths:
                    if done:
                        nxt.append((pose, lam, it, done))
                        continue
                    smul = max(ginit * 0.5 ** it, 1.0) if ginit > 1.0 \
                        else 1.0
                    r, z = self.residuals(pose)
                    cost, w = self.terms(r, z, use, smul)
                    J = self.jac(pose)
                    H = np.einsum("lri,lrj->ij", w[..., None] * J, J,
                                  optimize=True)
                    g = -np.einsum("lri,lr->i", J, w * r, optimize=True)
                    Hd = H + lam * np.diag(np.maximum(np.diag(H), 1e-6))
                    cand = normalize(boxplus(pose, np.linalg.solve(Hd, g)))
                    new = self.cost(cand, use, smul)
                    rel = (cost - new) / max(cost, 1e-12)
                    exact = bool(np.isfinite(new) and new < cost)
                    accepts = [exact] + ([not exact] if abs(rel) < TIE
                                         else [])
                    for acc in accepts:
                        conv = acc and rel < ftol and smul <= 1.0
                        ends = [conv] + ([not conv] if acc and smul <= 1.0
                                         and abs(rel - ftol) < TIE else [])
                        for end in ends:
                            nxt.append((cand if acc else pose,
                                        max(lam * 0.5, 1e-10) if acc
                                        else min(lam * 4.0, 1e8),
                                        it + 1, end))
                paths = nxt[:MAX_PATHS]
            return [p[0] for p in paths]

        out = []
        for pose in run(prior, lm_mask, robust["trim_iteration_lm_steps"]):
            r, z = self.residuals(pose)
            ok_r, ok_d = self.masks(z, lm_mask)
            n_min = robust["min_residual_groups"]
            trim = quantile_outliers(
                np.where(ok_r, np.linalg.norm(r[:, :2], axis=-1), 0.0), ok_r,
                robust["reprojection_quantile"]) & (ok_r.sum() >= n_min)
            trim |= quantile_outliers(
                np.where(ok_d, np.abs(r[:, 2]), 0.0), ok_d,
                robust["depth_quantile"]) & (ok_d.sum() >= n_min)
            use = lm_mask & ~(trim & (ok_r.sum() > 30))
            out += [(p, use) for p in run(pose, use,
                                          solver["pose_only_max_iterations"])]
        return out[:MAX_PATHS]


# ----------------------------------------------------- the tracking path --

def f32(x):
    return np.float32(x)


def frame(st, stamp, uvd, valid, cam, cfg):
    """The scan step's tracking path on one frame from state ``st``: the
    constant-velocity prior with the lidar range-rate rescue and the
    speed-derived budgets, the motion-only solve and its plausibility
    guard, the keyframe schemes (flow rejection, pose difference, time)
    and the solve throttle. Returns a dict of the reference's prior,
    motion-only result and frame pose, the motion-only solve's ``paths``
    (each path's result with the motion-only cost over the landmarks its
    last run used) and the rules that judge the program's: ``guard`` (the
    frame's pose made of a motion-only result), ``decide`` (keyframe and
    solve at a frame pose) and ``solve_ok`` (the post-solve guard)."""
    pc, robust, solver = cfg["prior"], cfg["robust"], cfg["solver"]
    ks, wc = cfg["keyframe_selection"], cfg["window"]
    n_kf = int(st["n_kf"])
    # the clock is the configuration's float32
    dt = float(np.clip(f32(stamp) - f32(st["last_stamp"]), 1e-3, 1.0))
    speed = float(st["speed"])
    budget_m = max(pc["guard_speed_factor"]
                   * max(speed, pc["guard_floor_speed"]) * dt,
                   pc["guard_floor_m"])
    budget_rad = pc["guard_rotation_rad"]
    # lidar range rates of the rows with depth in both frames
    d = uvd[:, 2]
    rate = (st["last_d"] - d) / dt
    plaus = valid & st["last_d_valid"] & (d > 0) & (np.abs(rate) < 80.0)
    rates = np.sort(rate[plaus])
    n_rate = rates.shape[0]
    speed_obs = max(0.5 * (rates[(n_rate - 1) // 2] + rates[n_rate // 2]),
                    0.0) if n_rate else np.inf
    lidar_has = n_rate >= pc["lidar_min_rates"]

    def agrees(sp):
        return (not lidar_has) or abs(sp - speed_obs) <= max(
            pc["lidar_band_frac"] * speed_obs, pc["lidar_band_floor_m_s"])

    # constant-velocity prior, clamped to the budgets
    vel, cur = st["vel"], st["cur_pose"]
    tn = float(np.linalg.norm(vel[4:]))
    tv = vel[4:] * min(budget_m / max(tn, 1e-9), 1.0)
    if lidar_has and not agrees(tn / dt):
        dirv = tv / max(tn, 1e-9) if tn > 0.2 else np.array([-1.0, 0, 0])
        tv = dirv * speed_obs * dt
    wv = qlog(vel[:4])
    wv = wv * min(budget_rad / max(np.linalg.norm(wv), 1e-9), 1.0)
    prior = normalize(compose(np.concatenate([qexp(wv), tv]), cur))
    if n_kf == 0:
        prior = np.array([1.0, 0, 0, 0, 0, 0, 0])
    # the motion-only solve over the last selection's landmarks
    win = st["window"]
    sel = st["sel_mask"]
    lm_mask = win["lm_valid"] & ~st["lm_outlier"] & (sel | (not sel.any()))
    n_usable = int((lm_mask & valid).sum())
    mo = MotionOnly(win["lm_pos"], uvd, valid & lm_mask, win["lm_weight"],
                    cam, robust)
    paths = mo.solve(prior, lm_mask, solver)
    po = paths[0][0]

    def guard(pose):
        """The motion-only result as the frame's pose where it is
        plausible (within the budgets of the prior, and of the lidar's
        speed), else the prior."""
        ok = (np.linalg.norm(relative(pose, prior)[4:]) < budget_m
              and qangle(pose[:4], prior[:4]) < budget_rad
              and agrees(np.linalg.norm(relative(pose, cur)[4:]) / dt))
        return normalize(pose if (n_kf >= 1 and n_usable >= 10 and ok)
                         else prior)

    def decide(refined):
        """(keyframe, solve) of the frame at pose ``refined``: flow
        rejection, pose difference and time schemes, and the throttle."""
        both = valid & st["last_kf_uv_valid"]
        flow = np.linalg.norm(uvd[:, :2] - st["last_kf_uv"], axis=-1)[both]
        rejected = flow.size > 0 and flow.mean() < ks["min_median_flow"]
        selected = qangle(refined[:4], st["last_kf_pose"][:4]) \
            > ks["critical_quaternion_difference"]
        sparsified = f32(stamp) - f32(st["last_kf_stamp"]) \
            > f32(ks["time_between_keyframes_sec"])
        take_kf = ((selected or sparsified) and not rejected) or n_kf == 0
        throttle = f32(0.98 * wc["time_between_solves_sec"])
        do_solve = take_kf and n_kf + 1 >= 3 \
            and f32(stamp) - f32(st["last_solve_stamp"]) >= throttle
        return bool(take_kf), bool(do_solve)

    def solve_ok(pose, refined):
        """The post-solve guard: the solved newest pose within the budgets
        of the frame's pose, and of the lidar's speed."""
        return bool(np.linalg.norm(relative(pose, refined)[4:]) < budget_m
                    and qangle(pose[:4], refined[:4]) < budget_rad
                    and agrees(np.linalg.norm(relative(pose, cur)[4:]) / dt))

    refined = guard(po)
    return {"prior": prior, "motion_only": po, "refined": refined,
            "paths": [(p, lambda pose, u=u: mo.cost(pose, u))
                      for p, u in paths], "guard": guard,
            "decide": decide, "solve_ok": solve_ok}


# --------------------------------------------------- the windowed solve --

class Problem:
    """The windowed bundle adjustment's robust cost over a window and a
    selection (dicts of arrays), and its damped Gauss-Newton step.

    Residuals: reprojection (2, Cauchy) and depth (1, Cauchy, landmarks
    with depth, positive depth in the camera) of every observation of a
    selected valid landmark in a valid keyframe, scaled by the landmark's
    weight; the ground-plane height of each ground landmark over its
    keyframe's plane (Huber, weight ``gp_weight``); and the pose and plane
    regularizers: the scale of the two oldest keyframes, the plane normal
    (3x), distance and motion (2x) chains between consecutive keyframes in
    time, and the normal prior (0, 0, 1), weighted ``gp_reg_weight``."""

    def __init__(self, w, sel, cam, cfg):
        self.w, self.sel, self.cam = w, sel, cam
        self.robust, self.reg = cfg["robust"], cfg["regularization"]
        K = w["poses"].shape[0]
        self.K = K
        kv = w["kf_valid"]
        order = np.argsort(np.where(kv, w["stamps"].astype(np.float64),
                                    np.inf), kind="stable")
        self.ia, self.ib = order[:-1], order[1:]
        pair_ok = np.arange(K - 1) < kv.sum() - 1
        plane_ok = w["plane_valid"] & kv
        self.chain_ok = pair_ok & plane_ok[self.ia] & plane_ok[self.ib]
        self.motion_ok = pair_ok & plane_ok[self.ia]
        self.plane_ok = plane_ok
        self.active = w["lm_valid"] & sel["lm_selected"]
        self.gp_kf = sel["gp_kf"].astype(np.int64)
        self.gp_on = self.active & w["lm_is_gp"] & (sel["gp_weight"] > 0) \
            & kv[self.gp_kf]
        base = w["obs_mask"] & self.active[:, None, None] & kv[None, :, None]
        self.base = base
        self.depth_base = base & (w["obs"][..., 2] > 0) \
            & w["lm_has_depth"][:, None, None]
        free_pose = kv & ~w["fix_pose"]
        free_plane = plane_ok
        self.param_mask = np.concatenate([
            np.repeat(free_pose[:, None], 6, 1),
            np.repeat(free_plane[:, None], 3, 1),
            (free_plane & (not bool(sel["plane_dist_fixed"])))[:, None]],
            1).reshape(-1).astype(np.float64)

    # -- residual families ------------------------------------------------
    def obs_residuals(self, poses, lm_pos):
        """[L, K, C, 3] residuals, z [L, K, C]."""
        return project_residual(poses[None, :, None, :],
                                lm_pos[:, None, None, :], self.w["obs"],
                                self.cam)

    def gp_residuals(self, poses, planes, lm_pos):
        pk = apply(poses[self.gp_kf], lm_pos)
        pl = planes[self.gp_kf]
        return np.sum(pl[:, :3] * pk, -1) + pl[:, 3]

    def reg_residuals(self, poses, planes):
        """(residuals [..., R], weights [R]) of poses [..., K, 7] and planes
        [..., K, 4]."""
        s = self.sel
        wgp = self.reg["gp_reg_weight"]
        k0, k1 = int(s["scale_kf0"]), int(s["scale_kf1"])
        r_scale = np.linalg.norm(relative(poses[..., k1, :],
                                          poses[..., k0, :])[..., 4:],
                                 axis=-1) - float(s["scale_target"])
        pa, pb = poses[..., self.ia, :], poses[..., self.ib, :]
        na, nb = planes[..., self.ia, :], planes[..., self.ib, :]
        dt = relative(pa, pb)[..., 4:]
        n = np.linalg.norm(dt, axis=-1, keepdims=True)
        unit = dt / np.maximum(n, 1e-12)
        lead = poses.shape[:-2]
        r = np.concatenate([
            r_scale[..., None],
            (na[..., :3] - nb[..., :3]).reshape(lead + (-1,)),
            na[..., 3] - nb[..., 3], np.sum(na[..., :3] * unit, -1),
            (planes[..., :3] - [0.0, 0.0, 1.0]).reshape(lead + (-1,))], -1)
        wt = np.concatenate([[float(s["scale_weight"])],
                             np.repeat(3 * wgp * self.chain_ok, 3),
                             wgp * self.chain_ok, 2 * wgp * self.motion_ok,
                             np.repeat(wgp * self.plane_ok, 3)])
        return r, wt

    # -- cost -------------------------------------------------------------
    def obs_terms(self, r, z):
        ok_r = self.base & (np.abs(z) >= Z_GUARD)
        ok_d = self.depth_base & (z > 0)
        wl = self.w["lm_weight"][:, None, None]
        c_r, w_r = cauchy(np.sum(r[..., :2] ** 2, -1),
                          self.robust["reprojection_thres"])
        c_d, w_d = cauchy(r[..., 2] ** 2, self.robust["depth_thres"])
        cost = np.sum(np.where(ok_r, wl * c_r, 0.0)) \
            + np.sum(np.where(ok_d, wl * c_d, 0.0))
        wr = np.where(ok_r, wl * w_r, 0.0)
        return cost, np.stack([wr, wr, np.where(ok_d, wl * w_d, 0.0)], -1)

    def gp_terms(self, r):
        c, wt = huber(r * r, self.reg["gp_height_huber_delta"])
        g = np.where(self.gp_on, self.sel["gp_weight"], 0.0)
        return np.sum(g * c), g * wt

    def cost(self, poses, planes, lm_pos):
        c_obs = self.obs_terms(*self.obs_residuals(poses, lm_pos))[0]
        c_gp = self.gp_terms(self.gp_residuals(poses, planes, lm_pos))[0]
        r, wt = self.reg_residuals(poses, planes)
        return c_obs + c_gp + 0.5 * np.sum(wt * r * r)

    def cost_of(self, w):
        return self.cost(w["poses"], w["planes"], w["lm_pos"])

    # -- one damped step ----------------------------------------------------
    def step(self, poses, planes, lm_pos, lam):
        """The Levenberg-Marquardt candidate at damping ``lam`` (Marquardt
        scaling of the diagonal, floored at 1e-6; fixed parameters and
        unselected landmarks held): (poses, planes, lm_pos)."""
        K, L = self.K, lm_pos.shape[0]
        P = 10 * K
        h = FD_STEP
        r, z = self.obs_residuals(poses, lm_pos)
        _, wo = self.obs_terms(r, z)                       # [L,K,C,3]
        Jp = np.empty(r.shape + (6,))
        for i in range(6):
            e = np.zeros(6)
            e[i] = h
            Jp[..., i] = (self.obs_residuals(boxplus(poses, e), lm_pos)[0]
                          - self.obs_residuals(boxplus(poses, -e), lm_pos)[0]
                          ) / (2 * h)
        Jl = np.empty(r.shape + (3,))
        for i in range(3):
            e = np.zeros(3)
            e[i] = h
            Jl[..., i] = (self.obs_residuals(poses, lm_pos + e)[0]
                          - self.obs_residuals(poses, lm_pos - e)[0]) / (2 * h)
        H = np.zeros((P, P))
        b = np.zeros(P)
        U = np.einsum("lkcri,lkcrj->kij", wo[..., None] * Jp, Jp,
                      optimize=True)
        bp = -np.einsum("lkcri,lkcr->ki", Jp, wo * r, optimize=True)
        for k in range(K):
            H[10 * k:10 * k + 6, 10 * k:10 * k + 6] += U[k]
            b[10 * k:10 * k + 6] += bp[k]
        V = np.einsum("lkcri,lkcrj->lij", wo[..., None] * Jl, Jl,
                      optimize=True)
        bl = -np.einsum("lkcri,lkcr->li", Jl, wo * r, optimize=True)
        W = np.zeros((L, P, 3))
        Wk = np.einsum("lkcri,lkcrj->lkij", wo[..., None] * Jp, Jl,
                       optimize=True)
        for k in range(K):
            W[:, 10 * k:10 * k + 6] += Wk[:, k]
        # ground-plane heights: pose (6), plane (4) of the landmark's
        # keyframe and the landmark (3)
        rg = self.gp_residuals(poses, planes, lm_pos)
        _, wg = self.gp_terms(rg)
        Jg = np.empty((L, 13))
        for i in range(13):
            e = np.zeros(13)
            e[i] = h
            up = self._gp_at(poses, planes, lm_pos, e)
            dn = self._gp_at(poses, planes, lm_pos, -e)
            Jg[:, i] = (up - dn) / (2 * h)
        idx = (10 * self.gp_kf[:, None] + np.arange(10)[None])     # [L,10]
        Jk, Jm = Jg[:, :10], Jg[:, 10:]
        np.add.at(H, (idx[:, :, None], idx[:, None, :]),
                  wg[:, None, None] * Jk[:, :, None] * Jk[:, None, :])
        np.add.at(b, idx, -(wg * rg)[:, None] * Jk)
        V += wg[:, None, None] * Jm[:, :, None] * Jm[:, None, :]
        bl -= (wg * rg)[:, None] * Jm
        np.add.at(W, (np.arange(L)[:, None], idx),
                  wg[:, None, None] * Jk[:, :, None] * Jm[:, None, :])
        # regularizers, over every pose and plane parameter
        rr, wr = self.reg_residuals(poses, planes)
        e = (h * np.eye(P)).reshape(P, K, 10)
        up = self.reg_residuals(boxplus(poses, e[..., :6]),
                                plane_plus(planes, e[..., 6:]))[0]
        dn = self.reg_residuals(boxplus(poses, -e[..., :6]),
                                plane_plus(planes, -e[..., 6:]))[0]
        Jr = ((up - dn) / (2 * h)).T                       # [R, P]
        H += (wr[:, None] * Jr).T @ Jr
        b -= Jr.T @ (wr * rr)
        # hold fixed parameters and unselected landmarks; damp
        m = self.param_mask
        H = H * m[:, None] * m[None, :]
        b = b * m
        H = H + np.diag(lam * np.maximum(np.diag(H), 1e-6) * m + (1 - m))
        free = self.active
        W = W * m[None, :, None] * free[:, None, None]
        bl = bl * free[:, None]
        V = np.where(free[:, None, None], V, np.eye(3))
        V = V + (lam * np.maximum(np.diagonal(V, axis1=1, axis2=2), 1e-6)
                 * free[:, None])[:, :, None] * np.eye(3)
        # eliminate the landmarks, solve, substitute back
        Vi = np.linalg.inv(V)
        WVi = np.matmul(W, Vi)
        S = H - np.einsum("lpj,lqj->pq", WVi, W, optimize=True)
        rhs = b - np.einsum("lpj,lj->p", WVi, bl, optimize=True)
        dp = np.linalg.solve(0.5 * (S + S.T), rhs) * m
        dl = rotate(Vi, bl - np.einsum("lpi,p->li", W, dp, optimize=True))
        dl = dl * free[:, None]
        d = dp.reshape(K, 10)
        return (normalize(boxplus(poses, d[:, :6])),
                plane_plus(planes, d[:, 6:]), lm_pos + dl)

    def _gp_at(self, poses, planes, lm_pos, e):
        k = self.gp_kf
        pk = boxplus(poses[k], e[None, :6])
        pl = plane_plus(planes[k], e[None, 6:10])
        x = lm_pos + e[None, 10:]
        return np.sum(pl[:, :3] * apply(pk, x), -1) + pl[:, 3]

    def first_step(self, lam):
        """(initial cost, candidate cost) of the solve's first iteration."""
        w = self.w
        c0 = self.cost_of(w)
        cand = self.step(w["poses"], w["planes"], w["lm_pos"], lam)
        return c0, self.cost(*cand)


def loop_flips(info, cfg) -> int:
    """How far a trimmed solve's loop, as its iteration trace reports it
    (a dict of ``n_iterations``, ``n_rounds``, ``initial_cost`` and the
    accept and cost traces), breaks
    the configuration's loop (``robust_solving::solveTrimmed``): each trim
    round runs ``trim_iteration_lm_steps`` iterations, ``diverged_retry_
    factor`` times as many where the first round's cost has not fallen
    below the initial cost; then at most ``refinement_iterations``, ending
    early only on convergence (an accepted step that lowers the cost by
    less than the function tolerance, read at twice it) or where the
    damping has reached its maximum. Returns the number of rules broken.
    (The cost after a trim is not traced: a round after the first, and a
    stop on the first refinement iteration, are taken as they come.)"""
    rc, sc = cfg["robust"], cfg["solver"]
    T = int(info["n_iterations"])
    acc = [int(a) for a in info["accept_trace"][:T]]
    cost = [float(c) for c in info["cost_trace"][:T]]
    rounds = rc["num_trim_iterations"]
    flips = int(int(info["n_rounds"]) != rounds)
    i = 0
    if rounds:
        b = rc["trim_iteration_lm_steps"]
        if i + b <= T and not cost[i + b - 1] < float(info["initial_cost"]):
            b *= sc["diverged_retry_factor"]
        i += b
    if rounds > 1:
        return flips
    m = T - i
    if m < 1 or m > sc["refinement_iterations"]:
        return flips + 1
    if m < sc["refinement_iterations"]:
        lam = sc["initial_lambda"]
        for a in acc[i:]:
            lam = max(lam * sc["lambda_down"], sc["min_lambda"]) if a == 1 \
                else min(lam * sc["lambda_up"], sc["max_lambda"])
        last = T - 1
        converged = acc[last] == 1 and (last == i or (
            cost[last - 1] - cost[last]) / cost[last - 1]
            < 2 * sc["function_tolerance"])
        flips += int(not (converged or lam >= sc["max_lambda"]))
    return flips
