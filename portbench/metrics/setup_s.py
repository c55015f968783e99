"""Process start to the first timed solve."""

from portbench.readers import setup_s as read  # noqa: F401
