"""Host ms per traced frame in the front end's ranges, each instant once
(the outermost of ``limo.upload``, ``limo.gamma_detect``, ``limo.labels``,
``limo.depth_plane``)."""

from ..trace import outermost_ms

NAMES = ("limo.upload", "limo.gamma_detect", "limo.labels",
         "limo.depth_plane")


def read(record):
    frames = record.counters.get("frames", 0)
    # limo.upload marks a program whose front end is spanned whole
    if record.trace is None or not frames or \
            "limo.upload" not in record.trace["ranges"]:
        return None
    return outermost_ms(record.trace["spans"], NAMES) / frames
