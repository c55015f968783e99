"""Host reads of a device loop's exit flag per cycle (moves solve_ms)."""

from portbench.readers import host_reads_per_cycle as read  # noqa: F401
