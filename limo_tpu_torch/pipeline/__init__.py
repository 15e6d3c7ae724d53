"""The scan-odometry step on track tensors, the fused images + clouds
pipeline that feeds it (:mod:`.fused`), and the numpy drive and metric
instruments they are run and scored with."""

from .scan_odometry import (FrameOut, ScanState, ScanStats, frame_arrays,
                            init_state, make_scan_step, poses_kitti,
                            run_sequence)

__all__ = ["FrameOut", "ScanState", "ScanStats", "frame_arrays", "init_state",
           "make_scan_step", "poses_kitti", "run_sequence"]
