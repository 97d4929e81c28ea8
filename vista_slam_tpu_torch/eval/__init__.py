"""Trajectory and reconstruction evaluation (host numpy / scipy), copies of
vista_slam_tpu/eval."""
