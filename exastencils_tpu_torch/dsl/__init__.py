"""ExaSlang L4 execution on PyTorch (reference: exastencils_tpu/dsl).

The front end (lexer, parser, nodes, L1-L3, solver generation, grid
calls) is imported from exastencils_tpu.dsl, which is jax-free; this
package ports the executor and what it reaches."""
