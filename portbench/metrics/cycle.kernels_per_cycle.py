"""Device operations per V-cycle (moves solve_ms)."""

from portbench.readers import kernels_per_cycle as read  # noqa: F401
