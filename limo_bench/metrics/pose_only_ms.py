"""Host ms per frame in the motion-only solve's range (``limo.pose_only``)
over the traced window."""


def read(record):
    if record.trace is None:
        return None
    r = record.trace["ranges"].get("limo.pose_only")
    frames = record.counters.get("frames", 0)
    return r["host_ms"] / frames if r and frames else None
