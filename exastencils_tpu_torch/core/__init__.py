"""Core data model of the port (reference: exastencils_tpu/core/__init__.py)."""
