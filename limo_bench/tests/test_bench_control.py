"""The control of ``correct`` comes out as not correct, on the card.

The control is the program with its full-float32 pin switched to TF32, the
nearest precision below the configuration's float32 with TF32 off. TF32
exists only on the card (on the CPU a float32 product is a float32
product), so this test needs one and skips without it. It drives one pass
of the cell's drive, at the cell's own size, with the cell's limits.

    python -m pytest limo_bench/tests/test_bench_control.py -m gpu
"""

from __future__ import annotations

import time

import pytest
import torch

from limo_bench import control, harness
from limo_bench.drivers import scan


@pytest.mark.gpu
def test_tf32_control_is_not_correct(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    from limo_tpu_torch.utils import precision
    monkeypatch.setattr(precision, "_tf32_off", control.tf32_on)
    manifest = harness.load_manifest()
    cell, _, traffic, config = harness.cell_files("scan.drive", manifest)
    record = scan.run(cell=cell, traffic=traffic, config=config,
                      seed=2**31 + 101, seconds=0.0, trace=False,
                      device=torch.device("cuda", 0),
                      t_process=time.perf_counter())
    compared = record.compare()
    line = harness.result_line(record, [], False, compared,
                               {"platform": "gpu"}, None)
    assert not line["correct"], compared
