"""The device's idle share over the traced solves (moves solve_ms)."""

from portbench.readers import idle_share as read  # noqa: F401
