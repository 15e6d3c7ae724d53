"""KITTI odometry dataset I/O and the PNG codec it reads images with."""
