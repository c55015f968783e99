"""The V-cycle's share of its memory-bound roofline (moves solve_ms)."""

from portbench.readers import cycle_roofline_share as read  # noqa: F401
