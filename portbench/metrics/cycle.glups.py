"""Fine nodes per second of one V-cycle (moves solve_ms)."""

from portbench.readers import glups as read  # noqa: F401
