"""The port's robust losses and trimmers (``limo_tpu_torch.robust``)
against the reference package's ``limo_tpu.robust``: the same numpy
inputs, weights within 1e-12 in f64 and masks exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu import robust as jrobust
from limo_tpu_torch import robust

TRIMMERS = [("quantile", 0.5), ("quantile", 0.9), ("fixed", 2.0)]


def _scores(seed=0, n=200):
    rng = np.random.default_rng(seed)
    return rng.gamma(2.0, 1.0, n), rng.uniform(size=n) < 0.8


@pytest.mark.parametrize("name", ["cauchy", "huber", "trivial"])
def test_losses_match_reference(name):
    assert set(robust.LOSSES) == set(jrobust.LOSSES)
    s = np.random.default_rng(1).gamma(1.0, 3.0, 500)
    for scale in (0.5, 1.6):
        got = robust.LOSSES[name](torch.as_tensor(s), scale).numpy()
        want = np.asarray(jrobust.LOSSES[name](jnp.asarray(s), scale))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(
        robust.trivial_weight(torch.as_tensor(s)).numpy(), np.ones_like(s))


def test_min_groups_guard_reference_case():
    """tests/test_residuals.py::test_min_groups_guard: three valid groups
    against a minimum of 30 trim nothing."""
    scores, valid = np.array([0.1, 10.0, 0.2]), np.ones(3, bool)
    got = robust.residuals_to_remove(torch.as_tensor(scores),
                                     torch.as_tensor(valid), "quantile", 0.5,
                                     min_groups=30)
    want = jrobust.residuals_to_remove(jnp.asarray(scores),
                                       jnp.asarray(valid), "quantile", 0.5,
                                       min_groups=30)
    assert not bool(got.any())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("trimmer,param", TRIMMERS)
@pytest.mark.parametrize("side", [0, 1])
def test_residuals_to_remove_matches_reference(trimmer, param, side):
    """Both sides of the min-groups threshold: at n_valid groups the
    trimmer runs, at n_valid + 1 nothing is trimmed."""
    scores, valid = _scores()
    min_groups = int(valid.sum()) + side
    got = robust.residuals_to_remove(torch.as_tensor(scores),
                                     torch.as_tensor(valid), trimmer, param,
                                     min_groups=min_groups).numpy()
    want = np.asarray(jrobust.residuals_to_remove(
        jnp.asarray(scores), jnp.asarray(valid), trimmer, param,
        min_groups=min_groups))
    np.testing.assert_array_equal(got, want)
    assert bool(got.any()) == (side == 0)


def test_unknown_trimmer_raises():
    scores, valid = _scores()
    for mod, arr in ((robust, torch.as_tensor), (jrobust, jnp.asarray)):
        with pytest.raises(ValueError):
            mod.residuals_to_remove(arr(scores), arr(valid), "median", 0.5,
                                    min_groups=1)
