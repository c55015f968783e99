"""Smoother sweeps on dense level tensors.

Reference: exastencils_tpu/ops/smoothers.py (`color_mask`,
`jacobi_update`, `make_smoother`).  Colour masks come from the global
index sum `(i+j+k) % num_colors` or a custom colour function of the
indices; on the dense path global and local indices agree.  The update
keeps the reference's FP order `(omega/diag) * (rhs - A sol)`.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from exastencils_tpu_torch.core.stencil import BoundStencil
from exastencils_tpu_torch.ops.stencil_apply import apply_stencil


def color_mask(shape: Tuple[int, ...], color: int, device, num_colors: int = 2,
               color_fn: Callable = None) -> torch.Tensor:
    """Mask of DOFs with `(sum_d i_d) % num_colors == color` (default; red
    = 0, black = 1), or `color_fn(*index_grids) % num_colors == color`.
    The index grids are int32 and broadcast against each other."""
    nd = len(shape)
    grids = []
    for d, n in enumerate(shape):
        view = [1] * nd
        view[d] = n
        grids.append(torch.arange(n, dtype=torch.int32, device=device).reshape(view))
    expr = color_fn(*grids) if color_fn is not None else sum(grids)
    return torch.broadcast_to((expr % num_colors) == color, tuple(shape))


def jacobi_update(
    sol: torch.Tensor,
    rhs: torch.Tensor,
    A: BoundStencil,
    omega: float,
    mask: torch.Tensor = None,
) -> torch.Tensor:
    """sol + omega / diag(A) * (rhs - A sol), optionally only where `mask`."""
    corr = (omega / A.diag()) * (rhs - apply_stencil(A, sol))
    if mask is None:
        return sol + corr
    return torch.where(mask, sol + corr, sol)


def make_smoother(
    A: BoundStencil,
    bc_apply: Callable,
    omega: float = 1.0,
    coloring: Sequence = None,
):
    """One smoother iteration sol, rhs -> sol (out of place).

    coloring = None      : damped Jacobi
    coloring = [m0, m1]  : coloured Gauss-Seidel, one masked Jacobi
                           half-sweep per colour with bc in between.
    Masks may be callables that build the mask on first use."""
    if coloring is None:

        def smooth(sol, rhs):
            return bc_apply(jacobi_update(sol, rhs, A, omega))

        return smooth

    def smooth_colored(sol, rhs):
        for mask in coloring:
            if callable(mask):
                mask = mask()
            sol = bc_apply(jacobi_update(sol, rhs, A, omega, mask))
        return sol

    return smooth_colored
