"""Device ms of one cycle of the timed solves, from its span (moves solve_ms)."""

from portbench.spans import cycle_device_ms as read  # noqa: F401
