from .keyframe import KeyframeDecision, mean_flow, select_keyframe
from .landmark import (
    CAT_FAR, CAT_MIDDLE, CAT_NEAR, CAT_NONE, VoxelResult,
    add_depth_scheme, cheirality_mask, dimension_plausibility_mask,
    landmark_flow, observability_scheme, random_scheme, track_lengths,
    voxel_scheme,
)

__all__ = [
    "KeyframeDecision", "mean_flow", "select_keyframe",
    "CAT_FAR", "CAT_MIDDLE", "CAT_NEAR", "CAT_NONE", "VoxelResult",
    "add_depth_scheme", "cheirality_mask", "dimension_plausibility_mask",
    "landmark_flow", "observability_scheme", "random_scheme",
    "track_lengths", "voxel_scheme",
]
