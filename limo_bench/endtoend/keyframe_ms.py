"""Wall ms of the window's frames that ran a trimmed solve, summed, over
how many there were: the pause a keyframe costs."""


def read(record):
    ms = [m for m, k in zip(record.frame_ms, record.frame_kind)
          if k == "solve"]
    return sum(ms) / len(ms) if ms else None
