"""PyTorch/CUDA port of the exastencils_tpu geometric-multigrid framework.

Reference: exastencils_tpu/__init__.py.  The package mirrors the module
layout of `exastencils_tpu` one file at a time (each file names its
reference), imports `torch` and never `jax`.  The jax-free modules of the
reference that the port needs (`config`, the DSL front end, `native`,
`utils.printing`) are copied into it, so it imports nothing of
`exastencils_tpu`.

Plain tensor code is PyTorch; the two Pallas kernels of the Poisson3D
V-cycle main path (whole down leg, whole up leg) are hand-written CUDA C++
for Hopper in `csrc/stream3d.cu`, bound in `ops/cuda/stream3d.py`.
"""

from exastencils_tpu_torch.config import Knowledge, parse_config_file  # noqa: F401

__all__ = ["Knowledge", "parse_config_file"]
