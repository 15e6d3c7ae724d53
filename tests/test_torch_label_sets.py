"""The scan step's label ontology: ``make_scan_step``'s outlier,
shrubbery and ground label sets.

- With sets other than the cityscapes defaults (vegetation rejected as
  dynamic, cars down-weighted as vegetation, road and sidewalk as ground),
  the port's step against the reference's step built with the same sets,
  frame by frame in f64 on the CPU with the reference's state handed over
  before every frame (``torch_parity.scan_step_by_step``; its tolerances).
- Every label id permuted by a fixed bijection, alike in the frames' label
  channel and in the three sets: the drive is bit-identical to the one
  with the default ontology (the step reads labels only through the sets).
"""

import numpy as np
import torch

from limo_tpu_torch.pipeline import scan_odometry as tso
from limo_tpu_torch.window_manager import (DEFAULT_GROUND_LABELS,
                                           DEFAULT_OUTLIER_LABELS,
                                           DEFAULT_SHRUBBERY_LABELS)
from torch_parity import port_of, scan_drive, scan_step_by_step, trees_equal

FRAMES = 16
CUSTOM = dict(outlier_labels=frozenset({21, 22}),
              shrubbery_labels=frozenset({26}),
              ground_labels=frozenset({7, 8}))


def test_custom_sets_against_reference():
    outs, step = scan_step_by_step("labels", FRAMES, **CUSTOM)
    attempted = sum(float(o.cost) != 0 for o in outs)
    assert attempted > 0 and len(step.stats.solves) == attempted


def permutation(seed=5):
    """A fixed bijection of the label ids -2..33 (those the drives and the
    default sets use) onto 100..135."""
    ids = np.arange(-2, 34)
    image = 100 + np.random.default_rng(seed).permutation(len(ids))
    return dict(zip(ids.tolist(), image.tolist()))


def _drive(labels, sets):
    chans, rig, cfg, _ = scan_drive("labels", FRAMES)
    trig, tcfg = port_of(rig, cfg)
    xs = tso.frame_arrays(chans["stamps"], chans["uvd_seq"],
                          chans["valid_seq"], tcfg, torch.float64,
                          labels=labels, stamp_dtype=torch.float64,
                          device="cpu")
    step = tso.make_scan_step(trig, tcfg, **sets)
    st = tso.init_state(tcfg.capacity, torch.float64,
                        tcfg.prior.default_speed, "cpu")
    outs = []
    for i in range(FRAMES):
        st, out = step(st, tuple(x[i] for x in xs))
        outs.append(out)
    return st, outs, step


def test_permuted_ontology_bit_identical():
    labels = scan_drive("labels", FRAMES)[0]["labels"].astype(np.int32)
    perm = permutation()
    mapped = np.vectorize(perm.__getitem__)(labels).astype(np.int32)
    assert set(np.unique(labels)) >= {-2, 7, 21, 26}
    sets = {k: frozenset(perm[i] for i in v) for k, v in (
        ("outlier_labels", DEFAULT_OUTLIER_LABELS),
        ("shrubbery_labels", DEFAULT_SHRUBBERY_LABELS),
        ("ground_labels", DEFAULT_GROUND_LABELS))}
    st0, outs0, step0 = _drive(labels, {})
    st1, outs1, step1 = _drive(mapped, sets)
    assert len(step0.stats.solves) > 0
    assert trees_equal(st0, st1)
    assert all(trees_equal(a, b) for a, b in zip(outs0, outs1))
    # the labels reached the step: the default ontology read as custom sets
    # on the unmapped labels gives another drive
    st2, _, _ = _drive(labels, CUSTOM)
    assert not trees_equal(st0, st2)
