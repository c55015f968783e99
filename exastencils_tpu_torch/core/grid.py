"""Grid geometry: per-level sizes, spacings and node/cell coordinates.

Reference: exastencils_tpu/core/grid.py.  Uniform grids and the stretched
axis-aligned grids of `grid_spacingModel = "linearFct"`; coordinates are
torch tensors on the level's device.  A non-uniform level keeps its node
positions as host (numpy) arrays and moves them to the device once, so
code that runs inside a staged (captured) run reads device tensors only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field
from functools import cached_property
from typing import Optional, Tuple

import numpy as np
import torch

from exastencils_tpu_torch.core.domain import Domain
from exastencils_tpu_torch.device import check_device, real_dtype

def linearfct_node_positions(lo: float, width: float, n_cells: int) -> np.ndarray:
    """Node positions of the reference's `grid_spacingModel = "linearFct"`
    (reference core/grid.py:25-50, after grid/ir/IR_SetupNodePositions.scala:
    128-231 for_AA_LinearFct): three zones, the spacing growing linearly
    over the first quarter of the cells, constant over the middle half and
    shrinking linearly over the last quarter, with the largest:smallest
    cell-width ratio fixed to 8."""
    N = int(n_cells)
    if N % 4 != 0:
        raise ValueError(f"linearFct spacing needs 4 | numCells (got {N})")
    xf = N // 4 - 1
    xs = (N // 4) * 3
    alpha_coeff = (-0.5 * xf * xf - 0.5 * xf + xf * N - 0.5 * N * N
                   + 0.5 * N + N * xs - 0.5 * xs * xs - 0.5 * xs)
    factor = (N // 4) / 8.0
    alpha = width / (alpha_coeff + N * factor)
    beta = factor * alpha
    i = np.arange(N + 1, dtype=np.float64)
    zone1 = lo + 0.5 * alpha * i * i + (beta - 0.5 * alpha) * i
    zone2 = lo - 0.5 * alpha * (xf * xf + xf) + (beta + alpha * xf) * i
    zone3 = (lo - 0.5 * alpha * i * i
             + (alpha * xf + alpha * xs + 0.5 * alpha + beta) * i
             - 0.5 * alpha * (xf * xf + xf + xs * xs + xs))
    return np.where(i <= xf + 1, zone1, np.where(i <= xs + 1, zone2, zone3))


NODE = "Node"
CELL = "Cell"
FACE_X = "Face_x"
FACE_Y = "Face_y"
FACE_Z = "Face_z"

FACES = (FACE_X, FACE_Y, FACE_Z)


@dataclass(frozen=True)
class LevelGrid:
    """Geometry of one multigrid level over the global domain."""

    domain: Domain
    level: int
    cells: Tuple[int, ...]  # global cell count per dim
    dtype: torch.dtype
    device: torch.device
    # non-uniform axis-aligned grids (grid_spacingModel != "uniform"): the
    # node positions per dim, numpy float64 on the host
    node_positions: Optional[Tuple[np.ndarray, ...]] = dc_field(
        default=None, compare=False, repr=False)

    @property
    def ndim(self) -> int:
        return len(self.cells)

    @property
    def is_uniform(self) -> bool:
        return self.node_positions is None

    @cached_property
    def _positions(self) -> Tuple[torch.Tensor, ...]:
        """The node positions on the device, made once."""
        return tuple(torch.as_tensor(np.asarray(p), dtype=self.dtype, device=self.device)
                     for p in self.node_positions)

    def grid_width(self, dim: int) -> float:
        """Scalar spacing; on a non-uniform grid the MEAN width, so
        position-dependent code uses cell_widths_1d / width_b."""
        return self.domain.aabb.width(dim) / self.cells[dim]

    def cell_widths_1d(self, dim: int) -> torch.Tensor:
        """Per-cell widths along `dim` (length cells[dim])."""
        if self.is_uniform:
            return torch.full((self.cells[dim],), self.grid_width(dim), dtype=self.dtype,
                              device=self.device)
        p = self._positions[dim]
        return p[1:] - p[:-1]

    def width_b(self, dim: int, localization: str = NODE):
        """vf_gridWidth as an expression operand: a scalar on uniform
        grids, a per-cell tensor broadcastable along `dim` on non-uniform
        ones (a WindowGrid keeps the cells of the `localization` window)."""
        if self.is_uniform:
            return self.grid_width(dim)
        w = self.cell_widths_1d(dim)
        shape = [1] * self.ndim
        shape[dim] = w.shape[0]
        return w.reshape(shape)

    @property
    def widths(self) -> Tuple[float, ...]:
        return tuple(self.grid_width(d) for d in range(self.ndim))

    def volume_b(self, localization: str = NODE):
        """vf_cellVolume as an expression operand (width_b's product)."""
        if self.is_uniform:
            return math.prod(self.widths)
        vol = 1.0
        for d in range(self.ndim):
            vol = vol * self.width_b(d, localization)
        return vol

    def node_pos_1d(self, dim: int) -> torch.Tensor:
        if not self.is_uniform:
            return self._positions[dim]
        lo = self.domain.aabb.lower[dim]
        n = self.cells[dim]
        return lo + self.grid_width(dim) * torch.arange(
            n + 1, dtype=self.dtype, device=self.device)

    def cell_center_1d(self, dim: int) -> torch.Tensor:
        if not self.is_uniform:
            return self._centers[dim]
        lo = self.domain.aabb.lower[dim]
        n = self.cells[dim]
        return lo + self.grid_width(dim) * (
            torch.arange(n, dtype=self.dtype, device=self.device) + 0.5)

    @cached_property
    def _centers(self) -> Tuple[torch.Tensor, ...]:
        """The cell centres on the device, made once."""
        return tuple(torch.as_tensor(0.5 * (p[1:] + p[:-1]), dtype=self.dtype, device=self.device)
                     for p in self.node_positions)

    def face_pos_1d(self, dim: int, face_dim: int) -> torch.Tensor:
        """Position along `dim` of the DOFs of a Face_{face_dim} field."""
        return self.node_pos_1d(dim) if dim == face_dim else self.cell_center_1d(dim)

    def coords_1d(self, localization: str, dim: int) -> torch.Tensor:
        if localization == NODE:
            return self.node_pos_1d(dim)
        if localization == CELL:
            return self.cell_center_1d(dim)
        if localization in FACES:
            return self.face_pos_1d(dim, FACES.index(localization))
        raise ValueError(f"unknown localization {localization!r}")

    def coord_mesh(self, localization: str) -> Tuple[torch.Tensor, ...]:
        """ndim broadcastable coordinate tensors of the DOFs of a field
        with the given localization."""
        axes = []
        for d in range(self.ndim):
            c = self.coords_1d(localization, d)
            shape = [1] * self.ndim
            shape[d] = c.shape[0]
            axes.append(c.reshape(shape))
        return tuple(axes)

    def shape_of(self, localization: str) -> Tuple[int, ...]:
        if localization == NODE:
            return tuple(c + 1 for c in self.cells)
        if localization == CELL:
            return tuple(self.cells)
        if localization in FACES:
            fd = FACES.index(localization)
            return tuple(c + 1 if d == fd else c for d, c in enumerate(self.cells))
        raise ValueError(f"unknown localization {localization!r}")


@dataclass(frozen=True)
class WindowGrid(LevelGrid):
    """One rank's window of a level of the sharded DSL: the geometry of
    the global grid (domain, mean widths), with the shapes, coordinates
    and (on a non-uniform grid) cell widths of the window's points.
    `windows[loc][d]` is the global [lo, hi) along d of the local array
    of localization `loc` (parallel/topology.FieldWindow.bounds); only
    the localizations it names have a window."""

    windows: dict = dc_field(default=None, compare=False, repr=False)

    def coords_1d(self, localization: str, dim: int) -> torch.Tensor:
        lo, hi = self._bounds(localization)[dim]
        return super().coords_1d(localization, dim)[lo:hi]

    def width_b(self, dim: int, localization: str = NODE):
        """The widths of the window's cells along `dim`: those of its
        `localization` points, clipped to the grid's cells (the dense
        run edge-pads the last node's, _fit_coord)."""
        w = super().width_b(dim)
        if self.is_uniform:
            return w
        lo, hi = self._bounds(localization)[dim]
        return w.narrow(dim, lo, min(hi, self.cells[dim]) - lo)

    def shape_of(self, localization: str) -> Tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self._bounds(localization))

    def _bounds(self, localization: str):
        if localization not in self.windows:
            raise NotImplementedError(f"the sharded DSL with {localization} fields")
        return self.windows[localization]


def window_grid(grid: LevelGrid, windows: dict) -> WindowGrid:
    """`grid` seen through one rank's windows (WindowGrid)."""
    return WindowGrid(grid.domain, grid.level, grid.cells, grid.dtype, grid.device,
                      grid.node_positions, windows)


def level_grids(domain: Domain, knowledge, device, dtype=None) -> dict:
    """LevelGrid per level in [minLevel, maxLevel] on `device`.

    grid_spacingModel = "linearFct" builds the stretched grid at the finest
    level and takes every second node for each coarser one (reference
    core/grid.py:169-207, after for_AA_LinearFct and
    for_AA_restrictFromFiner, grid/ir/IR_VF_NodePosition.scala:130-133)."""
    device = check_device(device)
    dtype = dtype if dtype is not None else real_dtype(knowledge)
    nd = domain.ndim
    model = getattr(knowledge, "grid_spacingModel", "uniform")
    positions = {}
    if model == "linearFct":
        pos = tuple(
            linearfct_node_positions(domain.aabb.lower[d], domain.aabb.width(d),
                                     knowledge.cells_per_dim(knowledge.maxLevel, d))
            for d in range(nd))
        for lvl in range(knowledge.maxLevel, knowledge.minLevel - 1, -1):
            positions[lvl] = pos
            pos = tuple(p[::2] for p in pos)
    elif model != "uniform":
        raise NotImplementedError(
            f"grid_spacingModel {model!r} (supported: uniform, linearFct)")
    return {
        lvl: LevelGrid(
            domain, lvl,
            tuple(knowledge.cells_per_dim(lvl, d) for d in range(nd)),
            dtype=dtype, device=device, node_positions=positions.get(lvl),
        )
        for lvl in range(knowledge.minLevel, knowledge.maxLevel + 1)
    }
