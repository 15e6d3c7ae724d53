"""The benchmark's frame of a run: the manifest, the chip check, the
measured window's record, the metric readers found by name, the import
check and the result line.

A run is ``python -m limo_bench.run --workload NAME --seed N --seconds S
--trace 0|1`` from the root of a checkout. Everything that belongs to one
cell, configuration, driver kind or metric sits in a file of its own under
``limo_bench/`` and is found here by the name ``BENCHMARK.json`` gives it:

- ``workloads/<cell>.json``: the cell's driver kind, traffic and the
  limits of ``correct``;
- ``configs/<config>.json``: the configuration as it is run;
- ``drivers/<kind>.py``: ``run(cell, traffic, config, seed, seconds,
  trace, device, t_process) -> Record`` builds the inputs from the seed,
  sets the program up, warms it, measures and hands back the window's
  record with a ``compare`` that judges the window's outputs against the
  reference (``(name, value, limit or None)`` rows);
- ``endtoend/<metric>.py`` and ``metrics/<metric>.py``: ``read(record)``
  gives the metric's number, or None where the record holds nothing to
  read (the metric is then left out of the line).
"""

from __future__ import annotations

import importlib
import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# whole top-level module names that may not be loaded in a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "limo_tpu")


@dataclass
class Record:
    """What a driver hands back from one run."""

    frame_ms: List[float]          # wall ms of each frame of the window
    frame_kind: List[str]          # "solve" (ran a trimmed solve) | "track"
    window_s: float                # the window's whole wall time
    setup_s: float                 # process start to the first timed frame
    counters: Dict[str, float] = field(default_factory=dict)
    solves: List[dict] = field(default_factory=list)   # per traced solve
    trace: Optional[dict] = None   # trace.summarize() of the traced window
    memory_peak_bytes: int = 0
    failed: int = 0                # frames whose outputs are not finite
    compare: Optional[Callable[[], List[tuple]]] = None


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_files(name: str, manifest: dict):
    """(workload entry, configuration entry, cell file, configuration file)
    for the cell ``name``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[name]
    config = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(BENCH / "workloads" / f"{name}.json") as f:
        traffic = json.load(f)
    with open(ROOT / config["file"]) as f:
        config_file = json.load(f)
    if traffic["config"] != cell["config"]:
        raise SystemExit(f"{name}: its file names configuration "
                         f"{traffic['config']!r}, BENCHMARK.json "
                         f"{cell['config']!r}")
    return cell, config, traffic, config_file


def metrics_of(name: str, manifest: dict, trace: bool) -> List[dict]:
    """The metrics the cell ``name`` reports in a run with or without the
    trace: each metric whose ``workloads`` list names it or that has none."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric: str, trace: bool) -> Callable[[Record], Optional[float]]:
    pkg = "metrics" if trace else "endtoend"
    return importlib.import_module(f"limo_bench.{pkg}.{metric}").read


def driver(kind: str):
    return importlib.import_module(f"limo_bench.drivers.{kind}")


def forbidden_loaded() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def process_age_s() -> Optional[float]:
    """Seconds since this process started (the kernel's start time), or
    None where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def result_line(record: Record, metrics: List[dict], trace: bool,
                compared: List[tuple], device: dict,
                breakdown: Optional[dict]) -> dict:
    """The run's last line. ``compared`` rows are (name, value, limit or
    None); the run is correct where every number with a limit is finite
    and at most its limit."""
    compared = [r for r in compared if r[2] is not None]
    out_metrics = {}
    for m in metrics:
        value = reader(m["name"], trace)(record)
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = record.failed == 0 and all(
        v == v and v <= lim for _, v, lim in compared)
    line = {"correct": correct, "attempted": len(record.frame_ms),
            "failed": record.failed, "metrics": out_metrics,
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["compared"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in compared}
    return line
