"""The sensor front end: feature tracking, lidar depth, the RANSAC
groundplane and semantic label sampling."""

from .groundplane import PlaneResult, estimate_groundplane, fit_plane_lsq
from .lidar_depth import (DepthResult, LidarDepthConfig, estimate_depths,
                          gather_neighbors, ground_feature_depths,
                          ground_patch_depths)
from .semantics import dilate_labels, sample_labels
from .tracker import Features, MatchResult, TrackerConfig, detect, match

__all__ = [
    "PlaneResult", "estimate_groundplane", "fit_plane_lsq",
    "DepthResult", "LidarDepthConfig", "estimate_depths", "gather_neighbors",
    "ground_feature_depths", "ground_patch_depths",
    "dilate_labels", "sample_labels",
    "Features", "MatchResult", "TrackerConfig", "detect", "match",
]
