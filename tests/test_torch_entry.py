"""The port's flagship step and multi-device dry run (``limo_tpu_torch.
entry``): ``entry(device="cpu")`` against the reference package's
``__graft_entry__.entry()`` in f32 (final cost rtol 1e-4: f32 sum order
differs between the packages), and the dry run's stages on four ``gloo``
ranks on the CPU (``parallel.spawn``). The bench-scale parity and the
fleet stage (~25 s together on an idle 8-core CPU, four ranks of one
thread) are marked slow, to keep the tier-1 share of these tests small."""

import jax
import numpy as np
import pytest

from __graft_entry__ import entry as j_entry
from limo_tpu_torch.entry import entry
from limo_tpu_torch.parallel import spawn
from torch_dist_worker import dryrun_stage
import torch_parity  # noqa: F401  (one torch thread, as in the ranks)


def test_entry_matches_reference():
    fn, args = entry(device="cpu")
    w, sel, info = fn(*args)
    jfn, jargs = j_entry()
    _, _, jinfo = jax.jit(jfn)(*jargs)
    assert w.poses.dtype == args[0].poses.dtype
    assert int(info.n_trimmed) == int(jinfo.n_trimmed)
    np.testing.assert_allclose(float(info.initial_cost),
                               float(jinfo.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(info.final_cost),
                               float(jinfo.final_cost), rtol=1e-4)
    assert float(info.final_cost) < float(info.initial_cost)


def _stage(name):
    lines = spawn(dryrun_stage, 4, "gloo", args=(name,), timeout_s=1200)
    assert all(" ok" in line for line in lines), lines
    return lines[0]


def test_dryrun_tiny_four_ranks():
    line = _stage("tiny")
    assert "mesh=(2x2)" in line and "2 elements equal" in line


@pytest.mark.slow
@pytest.mark.parametrize("name", ["production", "fleet"])
def test_dryrun_stage_four_ranks(name):
    _stage(name)
