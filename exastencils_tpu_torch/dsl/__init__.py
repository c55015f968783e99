"""ExaSlang L4 execution on PyTorch (reference: exastencils_tpu/dsl).

The front end (lexer, parser, nodes, L1-L3, solver generation, grid
calls) is a copy of the JAX package's jax-free front end, so the port
imports nothing of exastencils_tpu; beside it this package ports the
executor and what it reaches."""
