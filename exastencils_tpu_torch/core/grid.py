"""Grid geometry: per-level sizes, spacings and node/cell coordinates.

Reference: exastencils_tpu/core/grid.py.  Uniform grids only in this port
(`grid_spacingModel = "uniform"`); coordinates are torch tensors on the
level's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from exastencils_tpu_torch.core.domain import Domain
from exastencils_tpu_torch.device import check_device, real_dtype

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

    @property
    def ndim(self) -> int:
        return len(self.cells)

    def grid_width(self, dim: int) -> float:
        return self.domain.aabb.width(dim) / self.cells[dim]

    def width_b(self, dim: int) -> float:
        """vf_gridWidth as an expression operand (a scalar on uniform
        grids)."""
        return self.grid_width(dim)

    @property
    def widths(self) -> Tuple[float, ...]:
        return tuple(self.grid_width(d) for d in range(self.ndim))

    @property
    def cell_volume(self) -> float:
        return math.prod(self.widths)

    def node_pos_1d(self, dim: int) -> torch.Tensor:
        lo = self.domain.aabb.lower[dim]
        n = self.cells[dim]
        return lo + self.grid_width(dim) * torch.arange(
            n + 1, dtype=self.dtype, device=self.device)

    def cell_center_1d(self, dim: int) -> torch.Tensor:
        lo = self.domain.aabb.lower[dim]
        n = self.cells[dim]
        return lo + self.grid_width(dim) * (
            torch.arange(n, dtype=self.dtype, device=self.device) + 0.5)

    def coords_1d(self, localization: str, dim: int) -> torch.Tensor:
        if localization == NODE:
            return self.node_pos_1d(dim)
        if localization == CELL:
            return self.cell_center_1d(dim)
        if localization in FACES:
            face_dim = FACES.index(localization)
            return self.node_pos_1d(dim) if dim == face_dim else self.cell_center_1d(dim)
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


def level_grids(domain: Domain, knowledge, device, dtype=None) -> dict:
    """LevelGrid per level in [minLevel, maxLevel] on `device`."""
    model = getattr(knowledge, "grid_spacingModel", "uniform")
    if model != "uniform":
        raise NotImplementedError(
            f"grid_spacingModel {model!r}: the port has uniform grids only")
    device = check_device(device)
    dtype = dtype if dtype is not None else real_dtype(knowledge)
    nd = domain.ndim
    return {
        lvl: LevelGrid(
            domain, lvl,
            tuple(knowledge.cells_per_dim(lvl, d) for d in range(nd)),
            dtype=dtype, device=device,
        )
        for lvl in range(knowledge.minLevel, knowledge.maxLevel + 1)
    }
