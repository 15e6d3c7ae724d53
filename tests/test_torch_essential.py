"""The port's 5-point prior (limo_tpu_torch.frontend.essential) against the
reference package's, in float64 on the CPU.

The nullspace basis of a 5-point sample is not unique, and the two
packages' LAPACK builds return different bases (CPU torch against JAX:
rows differ by up to 0.9 on the samples below); each basis gives its own
z-parametrisation, roots and solution-loss cases. So:

- the RANSAC draws are compared exactly;
- the bases are compared as subspaces (their projectors within 1e-10);
- ``_solutions`` — everything after the basis — is given the reference's
  basis, and the genuine solutions (essential-constraint residual < 1e-8)
  of each package are found by the other up to sign within 1e-4 (max abs;
  the back-substitution's conditioning, measured up to 8.9e-5). The
  ``valid`` flags agree on at least 99 % of the slots: a spurious
  sign change of the fitted determinant right at a grid point flips with
  rounding (2 of 480 slots over ten sample sets);
- ``estimate_essential`` runs with each package's own basis and is held by
  results on test_essential.py's well-posed scenes (four draws each):
  ``ok`` equal, the inlier sets within ESS_INLIER_FLIPS of 200 points, the
  rotation within ESS_ROT_RAD and the translation direction within
  ESS_T_RAD (two RANSAC winners of the same data; measured up to 3.6e-3
  rad, 0.054 rad and 5 points; test_essential.py holds each package to the
  truth within 0.01 and 0.05 rad). On the planar scene the essential
  matrices of both (R, t) folds explain every point, and which one RANSAC
  keeps depends on the basis (the packages differ on two of four draws,
  a rotation guess does not help), so the planar scene is compared with
  the reference's basis handed over. The 8-point solver is rank-degenerate
  on it (its nullspace is not unique either), so there it is held only to
  the reference's own claim: the 5-point does better. With the reference's
  basis handed over, the 5-point results agree within ESS_SAME_BASIS and
  the inlier sets exactly;
- the scan step with ``prior_mode="essential"``: step by step from the
  reference's state on the small depth drive, the port given the
  reference's basis: equal decisions, the prior within ESS_PRIOR (the
  solutions' 1e-4 times a ~4 m keyframe displacement: 2.7e-4 measured) and
  the refined and output poses within 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu.frontend import essential as je
from limo_tpu.geometry import quaternion as jquat
from limo_tpu.pipeline import scan_odometry as jso
from limo_tpu_torch import state as tstate
from limo_tpu_torch.frontend import essential as te
from limo_tpu_torch.pipeline import scan_odometry as tso
from test_essential import CX, CY, F, synth_pair, synth_planar_pair
from torch_parity import assert_close, port_of, scan_drive

ESS_ROT_RAD = 5e-3
ESS_T_RAD = 8e-2
ESS_INLIER_FLIPS = 6
ESS_SAME_BASIS = 1e-4
ESS_PRIOR = 1e-3
_STATIC = ("num_hypotheses", "thres_px", "min_flow_px", "seed", "method",
           "vote_margin")
_ref_estimate = jax.jit(je.estimate_essential, static_argnames=_STATIC)


def reference_basis(x0s, x1s):
    """The reference package's nullspace basis of the samples (JAX's SVD),
    as the port's ``_nullspace_basis`` returns it."""
    A = jax.vmap(je._epipolar_rows)(jnp.asarray(x0s.numpy()),
                                    jnp.asarray(x1s.numpy()))
    Vt = np.asarray(jax.vmap(
        lambda a: jnp.linalg.svd(a, full_matrices=True)[2])(A))
    return torch.from_numpy(Vt[:, 5:9].reshape(-1, 4, 3, 3).copy()).to(
        x0s.dtype)


@pytest.fixture
def with_reference_basis(monkeypatch):
    monkeypatch.setattr(te, "_nullspace_basis", reference_basis)


def _normalized(uv0, uv1):
    x0 = (np.asarray(uv0) - [CX, CY]) / F
    x1 = (np.asarray(uv1) - [CX, CY]) / F
    return x0, x1


def _qy(angle):
    q = jquat.qfrom_axis_angle(jnp.array([0.0, 1.0, 0.0], jnp.float64),
                               jnp.asarray(angle, jnp.float64))
    return np.asarray(jquat.qto_matrix(q))


def _unit(v):
    v = np.asarray(v, float)
    return v / np.linalg.norm(v)


# test_essential.py's scenes: (points, motion, noise, outliers, planar,
# method)
SCENES = {
    "pure_translation": (np.eye(3), [0.0, 0.0, -1.0], 0.0, 0, False,
                         "5point"),
    "rotation_translation": (_qy(0.05), _unit([0.2, 0.0, -1.0]), 0.3, 0,
                             False, "5point"),
    "outliers": (np.eye(3), _unit([0.1, 0.05, -1.0]), 0.3, 60, False,
                 "5point"),
    "planar_5point": (_qy(0.03), _unit([0.05, 0.0, -1.0]), 0.2, 0, True,
                      "5point"),
    "planar_8point": (np.eye(3), _unit([0.05, 0.0, -1.0]), 0.2, 0, True,
                      "8point"),
    "general_8point": (_qy(0.04), _unit([0.2, 0.1, -1.0]), 0.3, 0, False,
                       "8point"),
}


def scene(name, seed=42):
    R, t, noise, outliers, planar, method = SCENES[name]
    rng = np.random.default_rng(seed)
    if planar:
        uv0, uv1 = synth_planar_pair(rng, R, t, noise=noise)
    else:
        uv0, uv1 = synth_pair(rng, R, t, noise=noise, outliers=outliers)
    return np.array(uv0), np.array(uv1), method


def run_both(uv0, uv1, mask, method="5point", **kw):
    ref = _ref_estimate(jnp.asarray(uv0), jnp.asarray(uv1), jnp.asarray(mask),
                        jnp.asarray(F, jnp.float64),
                        jnp.asarray([CX, CY], jnp.float64), method=method,
                        **{k: (jnp.asarray(v) if k == "q_guess" else v)
                           for k, v in kw.items()})
    port = te.estimate_essential(
        torch.from_numpy(uv0), torch.from_numpy(uv1), torch.from_numpy(mask),
        F, torch.tensor([CX, CY], dtype=torch.float64), method=method,
        **{k: (torch.from_numpy(np.asarray(v)) if k == "q_guess" else v)
           for k, v in kw.items()})
    return jax.device_get(ref), port


def angle(q0, q1):
    return float(2 * np.arccos(min(abs(float(np.dot(q0, q1))), 1.0)))


def assert_results(ref, port, rot_rad, t_rad, flips, where=""):
    assert bool(port.ok) == bool(ref.ok), where
    assert abs(int(port.n_inliers) - int(ref.n_inliers)) <= flips, where
    n_flip = int((np.asarray(ref.inliers) != port.inliers.numpy()).sum())
    assert n_flip <= flips, (where, n_flip)
    assert angle(np.asarray(ref.q), port.q.numpy()) <= rot_rad, where
    tr, tp = np.asarray(ref.t), port.t.numpy()
    if bool(ref.ok):
        c = np.dot(tr, tp) / (np.linalg.norm(tr) * np.linalg.norm(tp))
        assert np.arccos(min(c, 1.0)) <= t_rad, (where, tr, tp)
    else:
        np.testing.assert_array_equal(tp, tr)


@pytest.mark.parametrize("n_hyp,size,seed,n_valid", [
    (256, 5, 0, 200), (64, 5, 3, 1536), (100, 8, 1, 37), (16, 5, 0, 1)])
def test_draws_exact(n_hyp, size, seed, n_valid):
    """The hypotheses' samples, bit for bit: the reference's uint32 hash of
    (hypothesis + 7919·seed, pick) into the valid-first order."""
    rng = np.random.default_rng(seed)
    mask = np.zeros(max(n_valid * 2, 40), bool)
    mask[rng.choice(mask.size, n_valid, replace=False)] = True
    valid_idx = jnp.argsort(~jnp.asarray(mask))
    r = je._hash2(jnp.arange(n_hyp, dtype=jnp.uint32)[:, None]
                  + jnp.uint32(seed * 7919),
                  jnp.arange(size, dtype=jnp.uint32)[None, :])
    ref = valid_idx[(r % jnp.maximum(jnp.sum(mask).astype(jnp.uint32), 1))
                    .astype(jnp.int32)]
    port = te._draw_samples(torch.from_numpy(mask), n_hyp, size, seed)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _samples(n=48, seed=11):
    uv0, uv1, _ = scene("rotation_translation")
    x0, x1 = _normalized(uv0, uv1)
    # distinct points: a sample with a repeated point has a 5-dim
    # nullspace, of which each package keeps some 4-dim part
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(x0.shape[0], 5, replace=False)
                    for _ in range(n)])
    return x0, x1, idx


def test_nullspace_spans_the_reference_subspace():
    x0, x1, idx = _samples()
    t0, t1 = torch.from_numpy(x0)[idx], torch.from_numpy(x1)[idx]
    port = te._nullspace_basis(t0, t1).reshape(-1, 4, 9).numpy()
    ref = reference_basis(t0, t1).reshape(-1, 4, 9).numpy()
    proj = lambda b: np.einsum("hki,hkj->hij", b, b)
    np.testing.assert_allclose(proj(port), proj(ref), rtol=0, atol=1e-10)


def _constraint_residual(E):
    return np.abs(np.asarray(jax.vmap(jax.vmap(je._essential_constraints))(
        jnp.asarray(E)))).max(-1)


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_solutions_with_the_reference_basis(seed):
    """Everything after the basis: det-polynomial fit, grid and bisection
    roots, back-substitution."""
    x0, x1, idx = _samples(seed=seed)
    Er, vr = jax.vmap(lambda s: je._five_point_one(
        jnp.asarray(x0)[s], jnp.asarray(x1)[s], jnp.float64))(jnp.asarray(idx))
    Er, vr = np.asarray(Er), np.asarray(vr)
    basis = reference_basis(torch.from_numpy(x0)[idx],
                            torch.from_numpy(x1)[idx])
    Ep, vp = (x.numpy() for x in te._solutions(basis))
    assert (vp == vr).mean() >= 0.99
    n = 0
    for Es, vs, Ed, vd in ((Er, vr, Ep, vp), (Ep, vp, Er, vr)):
        genuine = vs & (_constraint_residual(Es) < 1e-8)
        for h, i in zip(*np.nonzero(genuine)):
            cand = Ed[h][vd[h]].reshape(-1, 9)
            e = Es[h, i].reshape(9)
            gap = np.minimum(np.abs(cand - e).max(1), np.abs(cand + e).max(1))
            assert gap.size and gap.min() <= 1e-4, (h, i, gap)
            n += 1
    assert n >= 30, n


WELL_POSED = ["pure_translation", "rotation_translation", "outliers",
              "general_8point"]


@pytest.mark.parametrize("seed", [42, 1, 2, 3])
@pytest.mark.parametrize("name", WELL_POSED)
def test_estimate_essential_scenes(name, seed):
    uv0, uv1, method = scene(name, seed)
    mask = np.ones(uv0.shape[0], bool)
    ref, port = run_both(uv0, uv1, mask, method)
    assert bool(ref.ok)
    assert_results(ref, port, ESS_ROT_RAD, ESS_T_RAD, ESS_INLIER_FLIPS,
                   f"{name} seed {seed}")


def test_planar_five_point_beats_eight_point():
    uv0, uv1, _ = scene("planar_8point")
    mask = np.ones(uv0.shape[0], bool)
    t_gt = SCENES["planar_8point"][1]
    err = {}
    for method in ("5point", "8point"):
        ref, port = run_both(uv0, uv1, mask, method)
        assert bool(port.ok) and bool(ref.ok)
        err[method] = np.arccos(min(float(np.dot(port.t.numpy(), t_gt)), 1.0))
    assert err["5point"] < 0.05 and err["5point"] < err["8point"], err


@pytest.mark.parametrize("seed", [42, 1])
@pytest.mark.parametrize("name", ["pure_translation", "rotation_translation",
                                  "outliers", "planar_5point"])
def test_estimate_essential_same_basis(name, seed, with_reference_basis):
    uv0, uv1, method = scene(name, seed)
    mask = np.ones(uv0.shape[0], bool)
    ref, port = run_both(uv0, uv1, mask, method)
    assert_results(ref, port, ESS_SAME_BASIS, ESS_SAME_BASIS, 0, name)
    np.testing.assert_array_equal(port.inliers.numpy(),
                                  np.asarray(ref.inliers))


def test_standstill_masks_and_guess():
    """Sub-threshold flow gives identity motion; a partial match mask and a
    rotation guess (the scan path's tie-break) go through both packages."""
    uv0, _, _ = scene("pure_translation")
    ref, port = run_both(uv0, uv0 + 0.5, np.ones(uv0.shape[0], bool))
    assert not bool(port.ok) and not bool(ref.ok)
    np.testing.assert_array_equal(port.q.numpy(), [1.0, 0, 0, 0])
    np.testing.assert_array_equal(port.t.numpy(), [0.0, 0, 0])
    assert not port.inliers.any()
    uv0, uv1, _ = scene("rotation_translation")
    mask = np.random.default_rng(2).uniform(size=uv0.shape[0]) < 0.7
    q_guess = np.array([0.9999, 0.0, 0.0141, 0.0])
    ref, port = run_both(uv0, uv1, mask, num_hypotheses=64, seed=5,
                         q_guess=q_guess / np.linalg.norm(q_guess))
    assert bool(ref.ok)
    assert not (port.inliers.numpy() & ~mask).any()
    assert_results(ref, port, ESS_ROT_RAD, ESS_T_RAD, ESS_INLIER_FLIPS)


def test_motion_prior_unscaled():
    rng = np.random.default_rng(4)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    t = _unit(rng.normal(size=3))
    tcv = np.concatenate([_unit(rng.normal(size=4)), rng.normal(size=3)])
    ref = je.motion_prior_unscaled(
        je.EssentialResult(q=jnp.asarray(q), t=jnp.asarray(t), inliers=None,
                           n_inliers=None, ok=None),
        jnp.asarray(tcv), 13.0, 0.1)
    port = te.motion_prior_unscaled(
        te.EssentialResult(q=torch.from_numpy(q), t=torch.from_numpy(t),
                           inliers=None, n_inliers=None, ok=None),
        torch.from_numpy(tcv), 13.0, 0.1)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-14)


def test_scan_step_essential_prior(with_reference_basis):
    """The scan step with the 5-point prior, frame by frame from the
    reference's state (the depth drive's first 12 frames)."""
    chans, rig, cfg, _ = scan_drive("depth", num_frames=12)
    trig, tcfg = port_of(rig, cfg)
    st = jso.init_state(cfg.capacity, jnp.float64, cfg.prior.default_speed)
    jstep = jax.jit(jso.make_scan_step(rig, cfg, prior_mode="essential"))
    tstep = tso.make_scan_step(trig, tcfg, prior_mode="essential")
    args = (chans["stamps"], chans["uvd_seq"], chans["valid_seq"])
    xs = jso.frame_arrays(*args, cfg, jnp.float64, stamp_dtype=jnp.float64)
    txs = tso.frame_arrays(*args, tcfg, torch.float64,
                           stamp_dtype=torch.float64, device="cpu")
    n_kf = 0
    for i in range(len(chans["stamps"])):
        port_st = tstate.scan_state_from_numpy(jax.device_get(st), "cpu")
        st, out = jstep(st, tuple(x[i] for x in xs))
        _, port_out = tstep(port_st, tuple(x[i] for x in txs))
        out = jax.device_get(out)
        for f in ("is_keyframe", "solved", "po_ok", "n_usable"):
            np.testing.assert_array_equal(np.asarray(getattr(port_out, f)),
                                          np.asarray(getattr(out, f)),
                                          err_msg=f"frame {i} {f}")
        assert_close(port_out.prior, out.prior, 0, ESS_PRIOR,
                     f"frame {i} prior")
        for f in ("refined", "pose"):
            assert_close(getattr(port_out, f), getattr(out, f), 0, 1e-8,
                         f"frame {i} {f}")
        n_kf += int(out.is_keyframe)
    assert n_kf >= 4
