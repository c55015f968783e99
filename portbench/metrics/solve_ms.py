"""Time to solution in the cells whose device sets the pace."""

from portbench.readers import solve_ms as read  # noqa: F401
