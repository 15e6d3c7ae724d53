"""Multi-process execution: the landmark-sharded solve and the helpers
that start ranks and move a batch between them."""

from .multihost import (global_mesh, host_local_to_global, initialize,
                        pad_rows, process_local_batch, spawn)
from .sharding import (
    DATA_AXIS, MODEL_AXIS, gather_selection, gather_window, make_mesh,
    make_shard_map_solver, make_sharded_solver, selection_pspecs,
    shard_selection, shard_window, window_pspecs,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "gather_selection", "gather_window",
    "global_mesh", "host_local_to_global", "initialize", "make_mesh",
    "make_shard_map_solver", "make_sharded_solver", "pad_rows",
    "process_local_batch", "selection_pspecs", "shard_selection",
    "shard_window", "spawn", "window_pspecs",
]
