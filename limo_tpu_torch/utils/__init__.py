from .checkpoint import dump_map, load_adjuster, save_adjuster
from .precision import full_f32
from .profiling import StageTimer, device_trace, traced
from .transforms import TransformLookupError, TransformTree
from .viz import (accumulate_map, color_by_index_hsv, export_landmarks,
                  export_paths, export_planes, flow_image, write_ply)

__all__ = [
    "dump_map", "load_adjuster", "save_adjuster",
    "full_f32",
    "StageTimer", "device_trace", "traced",
    "TransformLookupError", "TransformTree",
    "accumulate_map", "color_by_index_hsv", "export_landmarks",
    "export_paths", "export_planes", "flow_image", "write_ply",
]
