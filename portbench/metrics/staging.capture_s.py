"""CUDA-graph warm-up and capture seconds in set-up."""

from portbench.readers import capture_s as read  # noqa: F401
