"""Multigrid and Krylov solvers (reference: exastencils_tpu/solver/)."""
