"""Diagnostics heartbeat — the ROS ``diagnostic_updater`` equivalent.

The reference registers a "MonoLidar Sensor Status" check on a
``diagnostic_updater::Updater`` with a hardware id; the status starts STALE
("Starting...") and flips to OK ("Valid operation") once frames flow
(mono_lidar.cpp:490-507).  It also sketches (commented upstream) a
frequency-diagnosed publisher with a min/max rate + tolerance window of 5
(mono_lidar.cpp:40-48).  This module provides both, host-side and
ROS-free: a :class:`DiagnosticUpdater` that runs registered checks at a
throttled rate, and a :class:`FrequencyStatus` task that watches an event
rate over a sliding window.

A copy of the reference package's ``limo_tpu/utils/diagnostics.py`` (plain
Python), so that the port's odometry drivers run without that package.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

# diagnostic_msgs::DiagnosticStatus levels
OK = 0
WARN = 1
ERROR = 2
STALE = 3

_LEVEL_NAMES = {OK: "OK", WARN: "WARN", ERROR: "ERROR", STALE: "STALE"}


@dataclass
class DiagnosticStatus:
    """One check's result (diagnostic_msgs/DiagnosticStatus analogue)."""

    name: str
    level: int = STALE
    message: str = "Starting..."
    hardware_id: str = ""
    values: Dict[str, str] = field(default_factory=dict)

    def summary(self, level: int, message: str) -> None:
        self.level = level
        self.message = message

    def add(self, key: str, value) -> None:
        self.values[key] = str(value)

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "level": _LEVEL_NAMES.get(self.level, str(self.level)),
            "message": self.message,
            "hardware_id": self.hardware_id,
            "values": dict(self.values),
        }


class FrequencyStatus:
    """Sliding-window event-rate check (FrequencyStatusParam analogue:
    min/max rate, tolerance, window of 5 intervals).

    ``max_freq=None`` means no upper bound (events may legitimately arrive
    faster than the monitored minimum — e.g. frames vs keyframe cadence).
    Frequency is measured over the tick *stamps* (which may be sim time);
    staleness — a stopped event source — is detected on the wall clock:
    if no tick arrives for ``stale_after`` wall seconds the check reports
    STALE regardless of the frozen stamp window."""

    def __init__(self, min_freq: float, max_freq: Optional[float] = None,
                 tolerance: float = 0.1, window_size: int = 5,
                 stale_after: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.min_freq = min_freq
        self.max_freq = max_freq
        self.tolerance = tolerance
        self.stale_after = (stale_after if stale_after is not None
                            else 3.0 / max(min_freq, 1e-9))
        self._clock = clock
        self._ticks: deque = deque(maxlen=window_size + 1)
        self._last_wall: Optional[float] = None

    def tick(self, stamp: Optional[float] = None) -> None:
        self._last_wall = self._clock()
        self._ticks.append(self._last_wall if stamp is None else stamp)

    def __call__(self, status: DiagnosticStatus) -> None:
        if len(self._ticks) < 2:
            status.summary(STALE, "No events recorded")
            return
        idle = self._clock() - self._last_wall
        span = self._ticks[-1] - self._ticks[0]
        events = len(self._ticks) - 1
        freq = events / span if span > 0 else float("inf")
        status.add("measured_frequency_hz", f"{freq:.3f}")
        status.add("window_events", events)
        if idle > self.stale_after:
            status.summary(STALE, f"No events for {idle:.1f} s")
        elif freq < self.min_freq * (1.0 - self.tolerance):
            status.summary(WARN, f"Frequency too low: {freq:.3f} Hz "
                                 f"< {self.min_freq:.3f} Hz")
        elif (self.max_freq is not None
              and freq > self.max_freq * (1.0 + self.tolerance)):
            status.summary(WARN, f"Frequency too high: {freq:.3f} Hz "
                                 f"> {self.max_freq:.3f} Hz")
        else:
            status.summary(OK, "Frequency within bounds")


class DiagnosticUpdater:
    """Runs registered checks at most every ``period`` seconds
    (diagnostic_updater::Updater analogue; update rate defaults to 1 Hz).

    Checks are callables taking a :class:`DiagnosticStatus` to fill in.
    ``update()`` is cheap to call every frame; it no-ops until the period
    elapses (``force_update()`` bypasses the throttle, as the reference
    calls it once at setup)."""

    def __init__(self, hardware_id: str = "none", period: float = 1.0,
                 sink: Optional[Callable[[List[dict]], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.hardware_id = hardware_id
        self.period = period
        self._sink = sink
        self._clock = clock
        self._checks: List[tuple] = []
        self._last_update: Optional[float] = None
        self.last_statuses: List[DiagnosticStatus] = []
        # bounded: long-lived nodes update once a second for hours
        self.history: deque = deque(maxlen=256)

    def set_hardware_id(self, hw: str) -> None:
        self.hardware_id = hw

    def add(self, name: str, fn: Callable[[DiagnosticStatus], None]) -> None:
        self._checks.append((name, fn))

    def update(self) -> Optional[List[DiagnosticStatus]]:
        now = self._clock()
        if self._last_update is not None and now - self._last_update < self.period:
            return None
        return self.force_update()

    def force_update(self) -> List[DiagnosticStatus]:
        self._last_update = self._clock()
        out: List[DiagnosticStatus] = []
        for name, fn in self._checks:
            st = DiagnosticStatus(name=name, hardware_id=self.hardware_id)
            try:
                fn(st)
            except Exception as e:  # a failing check must not kill the node
                st.summary(ERROR, f"check raised: {e!r}")
            out.append(st)
        self.last_statuses = out
        snap = [s.as_dict() for s in out]
        self.history.append(snap)
        if self._sink is not None:
            self._sink(snap)
        return out


class SensorStatusCheck:
    """The reference's ``checkSensorStatus``: STALE "Starting..." until the
    first heartbeat, then OK "Valid operation" (mono_lidar.cpp:496-507)."""

    def __init__(self):
        self.level = STALE
        self.message = "Starting..."
        self.frames = 0
        self.last_stamp: Optional[float] = None

    def heartbeat(self, stamp: Optional[float] = None) -> None:
        self.frames += 1
        self.last_stamp = stamp
        self.level = OK
        self.message = "Valid operation"

    def __call__(self, status: DiagnosticStatus) -> None:
        status.summary(self.level, self.message)
        status.add("frames_processed", self.frames)
        if self.last_stamp is not None:
            status.add("last_stamp", f"{self.last_stamp:.6f}")
