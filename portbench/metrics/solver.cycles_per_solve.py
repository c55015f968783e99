"""Cycles per solve (moves solve_ms)."""

from portbench.readers import cycles_per_solve as read  # noqa: F401
