"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages: the
reference package (JAX, on the CPU) and the PyTorch port, through the
port's carry-over functions (``limo_tpu_torch.state.*_from_numpy``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from __graft_entry__ import _make_problem
from limo_tpu.geometry.camera import CameraRig as JaxRig
from limo_tpu.state import Window as JaxWindow
from limo_tpu_torch import state as tstate


def to_torch(w, sel, rig, cfg, device="cpu"):
    """The reference package's (window, sel, rig, cfg) as the port's."""
    return (tstate.window_from_numpy(w, device),
            tstate.selection_from_numpy(sel, device),
            tstate.rig_from_numpy(rig, device),
            tstate.config_from_dict(dataclasses.asdict(cfg)))


def rich_problem(seed=1, dtype=jnp.float64):
    """``_make_problem(8, 256, 6, 200)`` with every assembly family on:
    valid groundplanes, groundplane landmarks with ``gp_weight > 0``,
    label weights, and the scale regularizer. Returns the reference
    package's (window, sel, rig, cfg)."""
    w, sel, rig, cfg = _make_problem(8, 256, 6, 200, dtype, seed=seed)
    rng = np.random.default_rng(seed + 100)
    K_used, L_used, L = 6, 200, w.L
    planes = np.array(w.planes)
    n = np.array([0.0, 0.0, 1.0]) + rng.normal(0, 0.05, (K_used, 3))
    planes[:K_used, :3] = n / np.linalg.norm(n, axis=1, keepdims=True)
    planes[:K_used, 3] = rng.normal(-30.0, 2.0, K_used)
    plane_valid = np.zeros(w.K, bool)
    plane_valid[:K_used] = True
    is_gp = np.zeros(L, bool)
    is_gp[:L_used] = rng.uniform(size=L_used) < 0.3
    lm_weight = np.ones(L)
    lm_weight[:L_used] = rng.uniform(0.5, 1.0, L_used)
    gp_weight = np.where(is_gp, rng.uniform(0.2, 1.0, L), 0.0)
    gp_kf = rng.integers(0, K_used, L).astype(np.int32)
    t = np.array(w.poses)[:, 4:]
    w = w._replace(planes=jnp.asarray(planes, dtype),
                   plane_valid=jnp.asarray(plane_valid),
                   lm_is_gp=jnp.asarray(is_gp),
                   lm_weight=jnp.asarray(lm_weight, dtype))
    sel = sel._replace(
        gp_kf=jnp.asarray(gp_kf), gp_weight=jnp.asarray(gp_weight, dtype),
        scale_target=jnp.asarray(1.05 * np.linalg.norm(t[1] - t[0]), dtype),
        scale_weight=jnp.asarray(50.0, dtype))
    return w, sel, rig, cfg


def to_jax(w, rig):
    """The port's (window, rig) as the reference package's."""
    return (JaxWindow(*[jnp.asarray(x) for x in tstate.window_to_numpy(w)]),
            JaxRig(*[jnp.asarray(x.cpu().numpy()) for x in rig]))


def assert_close(actual, desired, rtol, atol=0.0, err_msg=""):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(desired, np.float64),
                               rtol=rtol, atol=atol, err_msg=err_msg)
