"""Boundary-condition application on dense node tensors.

Reference: exastencils_tpu/ops/boundary.py (`make_bc_applier`).  The
boundary DOFs of a node field are the outermost planes (of a Face_d
field, its outermost planes along d; cell fields have none); the applier writes
them by slice assignment on a clone, so its input is never modified.  The
reference's iota-select plane writes (ops/shardsafe.py) work around an
XLA SPMD miscompile and have no counterpart here.
"""

from __future__ import annotations

from typing import Callable

import torch

from exastencils_tpu_torch.core.field import DirichletBC, Field, NeumannBC, NoBC
from exastencils_tpu_torch.core.grid import FACES, NODE, LevelGrid


def _plane(nd: int, dim: int, index) -> tuple:
    return tuple(index if d == dim else slice(None) for d in range(nd))


def make_bc_applier(field: Field, grid: LevelGrid, level: int = None) -> Callable:
    """Build `apply_bc(arr) -> arr` for `field` on `grid`."""
    bc = field.bc_at(grid.level if level is None else level)
    nd = grid.ndim

    if isinstance(bc, NoBC):
        return lambda arr: arr
    if field.localization != NODE:
        # cell dims take their bc through the DSL's virtual ghosts at
        # stencil-apply time; Face_d fields also have on-boundary DOF
        # planes along d that Dirichlet sets
        if field.localization in FACES and isinstance(bc, DirichletBC):
            fd = FACES.index(field.localization)
            values = {idx: bc.value for idx in (0, -1)}
            if callable(bc.value):
                coords = grid.coord_mesh(field.localization)
                plane_shape = tuple(n for i, n in enumerate(grid.shape_of(field.localization))
                                    if i != fd)
                for idx in (0, -1):
                    pl = _plane(nd, fd, idx)
                    values[idx] = bc.value(*(c[pl] for c in coords)) + torch.zeros(
                        plane_shape, dtype=grid.dtype, device=grid.device)

            def apply_face_dirichlet(arr):
                out = arr.clone(memory_format=torch.contiguous_format)
                for idx in (0, -1):
                    out[_plane(nd, fd, idx)] = values[idx]
                return out

            return apply_face_dirichlet
        return lambda arr: arr

    if isinstance(bc, DirichletBC):
        # values only on the 2*nd boundary planes, computed once per level
        plane_values = None
        if callable(bc.value):
            plane_values = {}
            coords = grid.coord_mesh(NODE)
            shape = grid.shape_of(NODE)
            for d in range(nd):
                plane_shape = tuple(s for i, s in enumerate(shape) if i != d)
                for idx in (0, -1):
                    pl = _plane(nd, d, idx)
                    vals = bc.value(*(c[pl] for c in coords))
                    plane_values[(d, idx)] = vals + torch.zeros(
                        plane_shape, dtype=grid.dtype, device=grid.device)

        def apply_dirichlet(arr):
            out = arr.clone(memory_format=torch.contiguous_format)
            for d in range(nd):
                for idx in (0, -1):
                    pl = _plane(nd, d, idx)
                    out[pl] = bc.value if plane_values is None else plane_values[(d, idx)]
            return out

        return apply_dirichlet

    if isinstance(bc, NeumannBC):
        order = bc.order
        if order not in (1, 2):
            raise ValueError(f"Neumann order {order} not supported")

        def apply_neumann(arr):
            # zero-flux: extrapolate the boundary plane from the interior
            out = arr.clone(memory_format=torch.contiguous_format)
            for d in range(nd):
                lo, hi = _plane(nd, d, 0), _plane(nd, d, -1)
                if order == 1:
                    out[lo] = out[_plane(nd, d, 1)]
                    out[hi] = out[_plane(nd, d, -2)]
                else:
                    out[lo] = (4.0 * out[_plane(nd, d, 1)] - out[_plane(nd, d, 2)]) / 3.0
                    out[hi] = (4.0 * out[_plane(nd, d, -2)] - out[_plane(nd, d, -3)]) / 3.0
            return out

        return apply_neumann

    raise TypeError(f"unsupported bc {bc!r}")
