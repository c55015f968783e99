"""Host reads inside a solve span, per cycle (moves solve_ms)."""

from portbench.spans import host_reads_per_cycle as read  # noqa: F401
