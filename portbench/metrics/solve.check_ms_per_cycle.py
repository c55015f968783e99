"""Device ms of the residual checks between cycles, per cycle (moves solve_ms)."""

from portbench.spans import check_ms_per_cycle as read  # noqa: F401
