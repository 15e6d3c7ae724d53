"""Where the port's and the reference's float32 fused drives part, and why.

    python scripts/fused_f32_divergence.py [--frames 200]

Runs the reference package's fused step (JAX, float32, on the CPU) over
the full-width fused drive (``limo_tpu_torch.entry.fused_drive``'s world
and configuration) on the reference's own per-feature channels. Before
every frame it hands the reference's FusedState and that frame's channels
to the port's float32 step and compares the two frames' decisions
(keyframe, solve accepted, ``po_ok``, the counts). For each frame whose
attempted solve ends more than 1e-3 (relative) apart in the two packages,
it solves the port's input window again with both packages in float32 and
float64. Prints one JSON line per such frame and a summary line.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DISCRETE = ("is_keyframe", "solved", "po_ok", "n_usable", "n_rate",
            "n_tracks", "n_matches", "n_depth")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=200)
    n = ap.parse_args().frames

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)   # for the f64 solves only
    import jax.numpy as jnp
    import torch

    from limo_tpu.config import LandmarkSelectionConfig, LimoConfig, PriorConfig
    from limo_tpu.frontend import tracker as jtrk
    from limo_tpu.frontend.lidar_depth import LidarDepthConfig
    from limo_tpu.frontend.semantics import dilate_labels, sample_labels
    from limo_tpu.geometry.camera import CameraRig
    from limo_tpu.pipeline import full as jfull
    from limo_tpu.pipeline import fused as jfused
    from limo_tpu.pipeline.full import LimoPipelineConfig
    from limo_tpu.solver.trimmed import solve_trimmed as jsolve
    from limo_tpu.state import Selection as JSel
    from limo_tpu.state import Window as JWin
    from limo_tpu.window_manager import DEFAULT_OUTLIER_LABELS
    from limo_tpu_torch import state as tstate
    from limo_tpu_torch.entry import fused_drive
    from limo_tpu_torch.pipeline import fused as tfused
    from limo_tpu_torch.pipeline import scan_odometry as tso
    from limo_tpu_torch.solver import solve_trimmed as tsolve

    (stamps, imgs, clouds, labels, trig, tcfg, tpcfg,
     world) = fused_drive(n, device="cpu")
    cfg = LimoConfig(
        landmark_selection=dataclasses.replace(
            LandmarkSelectionConfig(),
            height_over_ground=tcfg.landmark_selection.height_over_ground),
        prior=dataclasses.replace(PriorConfig(),
                                  default_speed=tcfg.prior.default_speed))
    pcfg = LimoPipelineConfig(
        limo=cfg, tracker=jtrk.TrackerConfig(**vars(tpcfg.tracker)),
        lidar=LidarDepthConfig(**vars(tpcfg.lidar)), use_groundplane=True,
        cloud_capacity=tpcfg.cloud_capacity)
    rig = CameraRig.single(world.focal, world.principal[0], world.principal[1],
                           T_cam_veh=jnp.asarray(world.T_cam_veh, jnp.float32))
    size = tuple(world.image_size)
    out_tab = jnp.asarray(sorted(DEFAULT_OUTLIER_LABELS), jnp.int32)

    @jax.jit
    def front(imgs_u8, cloud, valid, lab_imgs):
        """The reference runner's first two passes, float32."""
        with jax.default_matmul_precision("highest"):
            im = (imgs_u8.astype(jnp.float32) / 255.0) ** (1.0 / pcfg.gamma)
            f = jax.vmap(lambda x: jtrk.detect(x, pcfg.tracker))(im)

            def lab_one(a):
                li = a[0].astype(jnp.int32)
                return sample_labels(
                    dilate_labels(li, jnp.isin(li, out_tab)), a[1])

            def depth_one(a):
                return jfull.frontend_depth_plane(
                    a[0], a[1], rig.T_cam_veh[0], a[2], rig.focal[0],
                    rig.principal[0], size, pcfg.lidar, True,
                    tuple(pcfg.gp_band))
            lab = jax.vmap(lab_one)((lab_imgs, f.uv))
            d, pl, ok = jax.lax.map(depth_one, (cloud, valid, f.uv))
        return f.uv, f.desc, f.valid, d, lab, pl, ok

    cloud, valid = jfused.pad_clouds(clouds, pcfg.cloud_capacity)
    parts = [jax.device_get(front(*(jnp.asarray(a[lo:lo + 50]) for a in
                                     (imgs, cloud, valid, labels))))
             for lo in range(0, n, 50)]
    chans = [np.concatenate(c) for c in zip(*parts)]

    calls = []
    inner = tso.solve_trimmed

    def recorded(w, sel, rig_, cfg_):
        out = inner(w, sel, rig_, cfg_)
        calls.append((w, sel, out))
        return out
    tso.solve_trimmed = recorded

    jstep = jax.jit(jfused.make_fused_step(rig, cfg, pcfg, size, True))
    tstep = tfused.make_fused_step(trig, tcfg, tpcfg)
    jsolve_jit = jax.jit(lambda w, s, r: jsolve(w, s, r, cfg))
    st = jfused.init_fused_state(cfg, pcfg, jnp.float32)
    differ, parted = [], 0
    for i in range(n):
        frame = (np.float32(stamps[i]),) + tuple(c[i] for c in chans)
        port_st = tstate.fused_state_from_numpy(jax.device_get(st), "cpu")
        st, out = jstep(st, tuple(jnp.asarray(x) for x in frame))
        out = jax.device_get(out)
        calls.clear()
        _, pout = tstep(port_st, tuple(torch.as_tensor(np.array(x))
                                       for x in frame))
        flips = [f for f in DISCRETE
                 if not np.array_equal(np.asarray(getattr(out, f)),
                                       getattr(pout, f).numpy())]
        if flips:
            differ.append((i, flips))
        c_ref, c_port = float(out.cost), float(pout.cost)
        if c_ref and abs(c_port - c_ref) > 1e-3 * abs(c_ref):
            parted += 1
            w, sel, _ = calls[0]
            rec = {"frame": i, "final_cost_reference_f32": c_ref,
                   "final_cost_port_f32": c_port, "decisions_differ": flips}
            for name, tdt in (("f32", torch.float32),
                              ("f64", torch.float64)):
                cast = lambda x: x.to(tdt) if x.is_floating_point() else x
                tw, ts = type(w)(*map(cast, w)), type(sel)(*map(cast, sel))
                tr = type(trig)(*map(cast, trig))
                rec[f"port_{name}"] = float(tsolve(tw, ts, tr, tcfg)[2]
                                            .final_cost)
                jw = JWin(*[jnp.asarray(x.numpy()) for x in tw])
                js = JSel(*[jnp.asarray(x.numpy()) for x in ts])
                jr = type(rig)(*[jnp.asarray(x.numpy()) for x in tr])
                rec[f"reference_{name}"] = float(
                    jsolve_jit(jw, js, jr)[2].final_cost)
            print(json.dumps(rec), flush=True)
    print(json.dumps({"frames": n, "frames_with_other_decisions": differ,
                      "solves_apart": parted}))


if __name__ == "__main__":
    main()
