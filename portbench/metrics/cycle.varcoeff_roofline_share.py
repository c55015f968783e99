"""The variable-coefficient V-cycle's share of its memory-bound roofline (moves solve_ms)."""

from portbench.varcoeff import varcoeff_roofline_share as read  # noqa: F401
