"""Device ms per traced frame of the operations launched in the front
end's ranges (``limo.upload``, ``limo.gamma_detect``, ``limo.labels``,
``limo.depth_plane``: none nests in another, so each operation counts
once)."""

NAMES = ("limo.upload", "limo.gamma_detect", "limo.labels",
         "limo.depth_plane")


def read(record):
    frames = record.counters.get("frames", 0)
    # limo.upload marks a program whose front end is spanned whole
    if record.trace is None or not frames or \
            "limo.upload" not in record.trace["ranges"]:
        return None
    ranges = record.trace["ranges"]
    return sum(ranges[n]["device_ms"] for n in NAMES if n in ranges) / frames
