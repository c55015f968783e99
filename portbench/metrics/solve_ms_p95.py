"""The 95th percentile of a solve's time in the cells whose device sets the pace."""

from portbench.readers import solve_ms_p95 as read  # noqa: F401
