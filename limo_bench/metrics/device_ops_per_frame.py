"""Device operations per frame over the traced window."""


def read(record):
    frames = record.counters.get("frames", 0)
    if record.trace is None or not frames:
        return None
    return record.trace["device_ops"] / frames
