"""Host ms per trimmed solve in the assembly's ranges, each instant once
(the outermost of ``limo.assemble``, ``limo.regularizers``,
``limo.gp_system``, ``limo.compute_cost``), over the traced window."""

from ..trace import outermost_ms

NAMES = ("limo.assemble", "limo.regularizers", "limo.gp_system",
         "limo.compute_cost")


def read(record):
    n = record.counters.get("solves", 0)
    if record.trace is None or not n:
        return None
    return outermost_ms(record.trace["spans"], NAMES) / n
