"""Smoother sweeps on level tensors.

Reference: exastencils_tpu/ops/smoothers.py (`color_mask`,
`jacobi_update`, `make_smoother`, and for the sharded backend
`is_star_radius1`, `make_overlap_smoother`, `make_aggregated_smoother`,
:100-239).  Colour masks come from the global index sum
`(i+j+k) % num_colors` or a custom colour function of the indices; a
fragment passes its global origin as `index_offset`, so shard boundaries
keep the red/black phase.  The update keeps the reference's FP order
`(omega/diag) * (rhs - A sol)`.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from exastencils_tpu_torch.core.stencil import BoundStencil
from exastencils_tpu_torch.ops.stencil_apply import apply_stencil


def color_mask(shape: Tuple[int, ...], color: int, device, num_colors: int = 2,
               color_fn: Callable = None, index_offset: Tuple[int, ...] = None) -> torch.Tensor:
    """Mask of DOFs with `(sum_d i_d) % num_colors == color` (default; red
    = 0, black = 1), or `color_fn(*index_grids) % num_colors == color`.
    The index grids are int32, offset by `index_offset` (a fragment's
    global origin), and broadcast against each other."""
    nd = len(shape)
    index_offset = index_offset or (0,) * nd
    grids = []
    for d, n in enumerate(shape):
        view = [1] * nd
        view[d] = n
        grids.append(torch.arange(n, dtype=torch.int32, device=device).reshape(view)
                     + index_offset[d])
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
    exchange: Callable = None,
):
    """One smoother iteration sol, rhs -> sol (out of place).

    coloring = None      : damped Jacobi
    coloring = [m0, m1]  : coloured Gauss-Seidel, one masked Jacobi
                           half-sweep per colour with halo exchange and
                           bc in between.
    Masks may be callables that build the mask on first use; `exchange`
    (default none) runs before every update."""
    exchange = exchange or (lambda x: x)
    if coloring is None:

        def smooth(sol, rhs):
            return bc_apply(jacobi_update(exchange(sol), rhs, A, omega))

        return smooth

    def smooth_colored(sol, rhs):
        for mask in coloring:
            if callable(mask):
                mask = mask()
            sol = bc_apply(jacobi_update(exchange(sol), rhs, A, omega, mask))
        return sol

    return smooth_colored


def is_star_radius1(A: BoundStencil) -> bool:
    """Axis-only offsets of magnitude <= 1 with scalar coefficients: the
    contract of the split-exchange overlap path (no corner reads)."""
    for off, c in zip(A.offsets, A.coefs):
        if isinstance(c, torch.Tensor) and c.dim() > 0:
            return False
        nz = [o for o in off if o != 0]
        if len(nz) > 1 or (nz and abs(nz[0]) != 1):
            return False
    return True


def make_overlap_smoother(A: BoundStencil, bc_apply: Callable, topo, local_cells,
                          omega: float = 1.0, coloring: Sequence = None):
    """Smoother with communication/compute overlap (`tpu_overlap_halo`,
    reference :118-190 after IR_Communicate.scala:31 and
    IR_SplitLoops.scala).  Per colour, all neighbour messages are posted
    from the pre-update array (exchange_start), the interior update runs
    while they are in flight, then the received slabs land and only the
    dup planes (the sole points whose radius-1 star stencil reads ghosts)
    are recomputed from 3-plane slabs: O(surface) extra work,
    bitwise-equal values to the exchange-every-colour smoother."""
    if not is_star_radius1(A):
        raise ValueError("the overlap smoother needs a radius-1 star stencil")
    nd = topo.ndim
    masks = list(coloring) if coloring is not None else [None]
    g = topo.ghost

    def one_color(sol, rhs, mask):
        shell = topo.dup_plane_mask(sol.shape, local_cells, sol.device)
        if shell is None:  # no sharded dim: plain update
            return bc_apply(jacobi_update(sol, rhs, A, omega, mask))
        pending = topo.exchange_start(sol, local_cells)
        interior_m = ~shell if mask is None else mask & ~shell
        corr = (omega / A.diag()) * (rhs - apply_stencil(A, sol))
        sol_read = topo.exchange_finish(sol, pending, local_cells)
        out = topo.exchange_finish(torch.where(interior_m, sol + corr, sol), pending,
                                   local_cells)
        # boundary shell: dup planes recomputed from 3-plane slabs of the
        # pre-update values and fresh ghosts; points on an earlier dim's
        # dup plane are excluded so every point updates exactly once
        for d in range(nd):
            if topo.P[d] == 1:
                continue
            for plane in (g, g + local_cells[d]):
                sl3 = tuple(slice(plane - 1, plane + 2) if i == d else slice(None)
                            for i in range(nd))
                slc = tuple(slice(1, 2) if i == d else slice(None) for i in range(nd))
                pl = tuple(slice(plane, plane + 1) if i == d else slice(None)
                           for i in range(nd))
                corr_c = (omega / A.diag()) * (rhs[pl] - apply_stencil(A, sol_read[sl3])[slc])
                cur = out[pl]
                sel = (torch.ones(cur.shape, dtype=torch.bool, device=cur.device)
                       if mask is None else torch.broadcast_to(mask[pl], cur.shape))
                for dp in range(d):
                    if topo.P[dp] == 1:
                        continue
                    view = [1] * nd
                    view[dp] = cur.shape[dp]
                    i2 = torch.arange(cur.shape[dp], device=cur.device).reshape(view)
                    sel = sel & ~((i2 == g) | (i2 == g + local_cells[dp]))
                out[pl] = torch.where(sel, sol_read[pl] + corr_c, cur)
        return bc_apply(out)

    def smooth(sol, rhs):
        for mask in masks:
            if callable(mask):
                mask = mask()
            sol = one_color(sol, rhs, mask)
        return sol

    return smooth


def make_aggregated_smoother(A: BoundStencil, bc_apply: Callable, topo, local_cells,
                             omega: float, coloring: Sequence, factor: int):
    """k-wide-halo smoother (`comm_haloAggregationFactor = k`, reference
    :193-239): ghost width >= k, ONE halo exchange per k half-sweeps.
    Between exchanges the valid zone shrinks one ghost layer per
    half-sweep and never reaches the dup planes, so interior and dup
    values stay bitwise-equal to the exchange-every-colour smoother.  The
    rhs is exchanged once per call: ghost-zone updates need the
    neighbour's rhs to reproduce its interior results.  Returns
    smooth_n(n, sol, rhs)."""
    if topo.ghost < max(1, factor):
        raise ValueError(f"ghost width {topo.ghost} < aggregation factor {factor}")
    masks = list(coloring) if coloring is not None else [None]
    per_ex = max(1, factor // len(masks))

    def smooth_n(n, sol, rhs):
        rhsx = topo.exchange(rhs, local_cells)
        done = 0
        while done < n:
            k = min(per_ex, n - done)
            sol = topo.exchange(sol, local_cells)
            for _ in range(k):
                for mask in masks:
                    if callable(mask):
                        mask = mask()
                    sol = bc_apply(jacobi_update(sol, rhsx, A, omega, mask))
            done += k
        return sol

    return smooth_n
