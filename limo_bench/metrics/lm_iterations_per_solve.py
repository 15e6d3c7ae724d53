"""LM iterations per trimmed solve over the traced window (``SolveInfo``)."""


def read(record):
    n = record.counters.get("solves", 0)
    return record.counters["lm_iterations"] / n if n else None
