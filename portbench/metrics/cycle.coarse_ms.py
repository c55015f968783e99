"""Device ms per cycle below the finest level, from the spans (moves solve_ms)."""

from portbench.spans import cycle_coarse_ms as read  # noqa: F401
