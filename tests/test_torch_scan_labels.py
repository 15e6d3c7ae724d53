"""The port's scan step against the reference package's, step by step in
float64 on the CPU, on the two drives that take the branches the depth
drive does not (tests/test_torch_scan.py has that one):

- the labelled drive (shrubbery and dynamic objects, per-row semantic
  labels): the label flow (outlier labels, shrubbery weights, ground flags)
  and the groundplane wiring of ``selection_for_solve``;
- the mono drive with external priors: the external prior and the
  post-solve guard's accepted branch, which replaces the window with the
  solve's result (compared by the next state's window).
"""

import numpy as np
import pytest

from torch_parity import scan_step_by_step

# (keyframes, attempted solves, accepted solves) of the reference's f64
# run on each drive
COUNTS = {"labels": (15, 13, 0), "mono_prior": (12, 5, 5)}


@pytest.mark.parametrize("kind", sorted(COUNTS))
def test_drive_step_by_step(kind):
    outs, step = scan_step_by_step(kind)
    kf = sum(bool(o.is_keyframe) for o in outs)
    attempted = sum(float(o.cost) != 0 for o in outs)
    accepted = sum(bool(o.solved) for o in outs)
    assert (kf, attempted, accepted) == COUNTS[kind]
    assert len(step.stats.solves) == attempted
    if kind == "mono_prior":
        # accepted solves move the pose off the pose-only result
        moved = [np.abs(np.asarray(o.pose) - np.asarray(o.refined)).max()
                 for o in outs if bool(o.solved)]
        assert min(moved) > 0
