"""Field reductions (dot products, norms).

Reference: exastencils_tpu/ops/reductions.py.  Each returns a 0-dim
tensor on the operands' device.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def norm_l2(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(a * a))


def norm_max(a: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.abs(a))
