"""Median wall ms of the traced window's frames that ran no solve."""

import statistics


def read(record):
    ms = [m for m, k in zip(record.frame_ms, record.frame_kind)
          if k == "track"]
    return statistics.median(ms) if ms else None
