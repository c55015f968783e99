"""Execution backends (reference: exastencils_tpu/parallel/)."""
