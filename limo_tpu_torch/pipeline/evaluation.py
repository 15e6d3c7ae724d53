"""Evaluation worlds for the rendered drives.

A copy of ``make_km_rendered_world`` from the reference package's
``limo_tpu/pipeline/evaluation.py`` (numpy only), so that the fused drive's
world is built without that package: the same arguments give the same
world, bit for bit. The rest of that harness is not part of the port yet.
"""

from __future__ import annotations

import numpy as np

from .synthetic import make_world


def make_km_rendered_world(num_frames: int = 1000, hz: float = 10.0,
                           cruise: float = 12.0, seed: int = 11,
                           image_size=(512, 192), focal: float = 450.0,
                           with_standstill: bool = True,
                           with_turns: bool = True,
                           n_dynamic: int = 80):
    """Kilometre-scale rendered-drive world with the failure modes the
    reference's machinery exists for: an acceleration ramp, a ~6 s
    STANDSTILL stretch (keyframe flow rejection must fire), two SHARP ~60°
    turns (pose-difference keyframe selection), S-curve wander, shrubbery
    and dynamic traffic. The profile scales with ``num_frames``. Returns
    ``(world, standstill_range)`` with the (lo, hi) frame interval of zero
    motion."""
    f = num_frames
    t = np.arange(f) / f
    # gentle S-curve wander, lateral acceleration (yaw rate [rad/m] · v²)
    # held to ~3 m/s²
    wander = min(0.010, 3.0 / max(cruise, 1.0) ** 2)
    yaw = wander * np.sin(2 * np.pi * (2.0 * t + 0.3))
    if with_turns:
        turn_len = int(0.03 * f)                 # ~3 s at 10 Hz
        for c, sgn in ((int(0.35 * f), 1.0), (int(0.75 * f), -1.0)):
            yaw[c:c + turn_len] += sgn * 0.030   # rad/m ⇒ ~62° at 12 m/s
    sp = np.full(f, cruise)
    ramp = max(int(0.05 * f), 2)
    sp[:ramp] = np.linspace(0.0, cruise, ramp)
    # standstill: decelerate, hold ~6 s, re-accelerate (frames relative to f)
    d0, s0, s1, a1 = (int(0.38 * f), int(0.40 * f),
                      int(0.46 * f), int(0.48 * f))
    if with_standstill:
        sp[d0:s0] = np.linspace(cruise, 0.0, s0 - d0)
        sp[s0:s1] = 0.0
        sp[s1:a1] = np.linspace(0.0, cruise, a1 - s1)
    # densities per metre follow the long-drive defaults (4/m structure)
    path_m = float(np.sum(sp) / hz)
    world = make_world(
        num_frames=f, hz=hz, speed=cruise, speed_profile=sp,
        yaw_rate_profile=yaw, n_landmarks=int(4.0 * path_m),
        n_ground=int(1.0 * path_m), n_shrubbery=int(0.2 * path_m),
        n_dynamic=n_dynamic, dynamic_speed=8.0, seed=seed, focal=focal,
        pp=(image_size[0] / 2.0, image_size[1] / 2.0),
        image_size=image_size)
    return world, (s0, s1)
