"""Percent of the traced window in which no operation ran on the card."""


def read(record):
    if record.trace is None or record.trace["window_s"] <= 0:
        return None
    t = record.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
