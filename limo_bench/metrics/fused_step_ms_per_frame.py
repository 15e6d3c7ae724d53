"""Host ms per traced frame in the fused step's own work before the scan
step: guided matching (``limo.match``) and the track table
(``limo.track_table``)."""

NAMES = ("limo.match", "limo.track_table")


def read(record):
    frames = record.counters.get("frames", 0)
    if record.trace is None or not frames:
        return None
    ranges = record.trace["ranges"]
    if not any(n in ranges for n in NAMES):
        return None
    return sum(ranges[n]["host_ms"] for n in NAMES if n in ranges) / frames
