"""Device ms per cycle in levels that run plain ops, from the spans (moves solve_ms)."""

from portbench.varcoeff import plain_ms as read  # noqa: F401
