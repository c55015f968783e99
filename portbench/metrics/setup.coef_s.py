"""Seconds of building the coefficient arrays in set-up, from the spans (moves setup_s)."""

from portbench.varcoeff import coef_s as read  # noqa: F401
