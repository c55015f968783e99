"""Device-idle ms inside graph-replay ranges, per cycle (moves solve_ms)."""

from portbench.spans import launch_idle_ms_per_cycle as read  # noqa: F401
