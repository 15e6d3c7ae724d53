"""Frames completed over the window's whole wall time."""


def read(record):
    if not record.frame_ms or record.window_s <= 0:
        return None
    return len(record.frame_ms) / record.window_s
