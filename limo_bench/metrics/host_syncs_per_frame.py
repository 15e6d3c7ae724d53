"""The program's device-to-host reads per frame over the traced window
(the scan step's ``ScanStats.host_syncs``)."""


def read(record):
    frames = record.counters.get("frames", 0)
    if not frames or "host_syncs" not in record.counters:
        return None
    return record.counters["host_syncs"] / frames
