"""Both packages' host engines side by side in float64 on the CPU.

    python scripts/host_parity_f64.py --frames 200

Writes the host-engine gate world (``limo_tpu_torch.entry.kitti_host_drive``)
to a temporary directory and runs the reference package's ``LimoPipeline``
and the port's over it frame by frame, free running, in float64
throughout: the reference's image path (float32 whatever its caller's type)
is given a float64 gamma and detect, and the port the reference's 5-point
nullspace basis (the basis is implementation-defined:
tests/test_torch_essential.py). Prints one line per frame (keyframe and
solve flags of both, the largest pose gap, each package's position error
against the ground truth after aligning the first frames) and a JSON
summary line: frames whose decisions differ, the largest pose gap, counts.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=200)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from limo_tpu.config import LimoConfig as JLimoConfig
    from limo_tpu.frontend import essential as je
    from limo_tpu.frontend import tracker as jtr
    from limo_tpu.frontend.lidar_depth import LidarDepthConfig as JLidar
    from limo_tpu.frontend.tracker import TrackerConfig as JTracker
    from limo_tpu.geometry.camera import CameraRig as JRig
    from limo_tpu.pipeline import full as jfull
    from limo_tpu_torch import entry
    from limo_tpu_torch.frontend import essential as te
    from limo_tpu_torch.geometry import pose_host
    from limo_tpu_torch.geometry.camera import CameraRig
    from limo_tpu_torch.io import kitti
    from limo_tpu_torch.pipeline import full as tfull

    def reference_basis(x0s, x1s):
        A = jax.vmap(je._epipolar_rows)(jnp.asarray(x0s.numpy()),
                                        jnp.asarray(x1s.numpy()))
        Vt = np.asarray(jax.vmap(
            lambda a: jnp.linalg.svd(a, full_matrices=True)[2])(A))
        return torch.from_numpy(Vt[:, 5:9].reshape(-1, 4, 3, 3).copy()).to(
            x0s.dtype)

    te._nullspace_basis = reference_basis
    jfull._gamma_u8_device = lambda img, gamma: (
        img.astype(jnp.float64) / 255.0) ** (1.0 / gamma)
    inner = jtr._detect_and_match
    jtr._detect_and_match = lambda img, *a: inner(img.astype(jnp.float64),
                                                  *a)

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "seq")
        gt, pcfg = entry.kitti_host_drive(args.frames, root)
        kw = dataclasses.asdict(pcfg)
        limo = kw.pop("limo")
        jcfg = jfull.LimoPipelineConfig(
            limo=JLimoConfig(**{
                f.name: type(getattr(JLimoConfig(), f.name))(**{
                    k: tuple(v) if isinstance(v, list) else v
                    for k, v in limo[f.name].items()})
                for f in dataclasses.fields(JLimoConfig)}),
            tracker=JTracker(**kw.pop("tracker")),
            lidar=JLidar(**kw.pop("lidar")),
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in kw.items()})
        seq = kitti.KittiSequence.open(root, gt)
        c, Tr = seq.calib, seq.calib.Tr_cam_velo
        ref = jfull.LimoPipeline(JRig.single(c.focal, *c.principal), jcfg,
                                 dtype=jnp.float64)
        port = tfull.LimoPipeline(CameraRig.single(c.focal, *c.principal,
                                                   device="cpu"),
                                  pcfg, dtype=torch.float64, device="cpu")
        flips, gap, counts = [], 0.0, {"keyframes": 0, "solves": 0}
        for i in range(len(seq)):
            img, lab = seq.load_image(i), seq.load_labels(i)
            velo = seq.load_velodyne(i)
            cloud = velo[:, :3] @ Tr[:3, :3].T + Tr[:3, 3]
            a = ref.process(seq.times[i], img, cloud, lab)
            b = port.process(seq.times[i], img, cloud, lab)
            g = np.linalg.inv(seq.poses_gt[0]) @ seq.poses_gt[i]
            err = [np.linalg.norm(pose_host.to_matrix(pose_host.inverse(
                r.pose))[:3, 3] - g[:3, 3]) for r in (a, b)]
            d = float(np.abs(a.pose - b.pose).max())
            gap = max(gap, d)
            if (a.is_keyframe, a.solved) != (b.is_keyframe, b.solved):
                flips.append(i)
            counts["keyframes"] += a.is_keyframe
            counts["solves"] += a.solved
            print(i, int(a.is_keyframe), int(b.is_keyframe), int(a.solved),
                  int(b.solved), f"{d:.2e}", f"{err[0]:.3f}", f"{err[1]:.3f}",
                  flush=True)
    print(json.dumps({"frames": args.frames, "decision_flips": flips,
                      "max_pose_gap": gap, **counts}))


if __name__ == "__main__":
    main()
