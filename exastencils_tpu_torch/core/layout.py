"""Per-fragment field layouts: [pad | ghost | dup | inner | dup | ghost | pad].

Reference: exastencils_tpu/core/layout.py (copied: importing it goes
through exastencils_tpu/core/__init__.py, which imports jax).  Pure index
algebra, the reference's field/ir/IR_FieldLayout.scala:51-73; the port's
dense DSL executor keeps no ghost or pad storage, so it reads only the
segment sizes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from exastencils_tpu_torch.core.grid import CELL, FACES, NODE


@dataclass(frozen=True)
class LayoutPerDim:
    """Segment sizes along one dimension (reference IR_FieldLayoutPerDim)."""

    pad_left: int = 0
    ghost_left: int = 0
    dup_left: int = 0
    inner: int = 0
    dup_right: int = 0
    ghost_right: int = 0
    pad_right: int = 0

    @property
    def total(self) -> int:
        return (
            self.pad_left + self.ghost_left + self.dup_left + self.inner
            + self.dup_right + self.ghost_right + self.pad_right
        )


@dataclass(frozen=True)
class FieldLayout:
    """Reference IR_FieldLayout analog.  `idx(id, dim)` follows the
    reference's defIdxByIdFixed naming: P/G/D/I segments, L/R side, B/E."""

    name: str
    localization: str
    per_dim: Tuple[LayoutPerDim, ...]
    communicates_duplicated: bool = False
    communicates_ghosts: bool = False

    @property
    def ndim(self) -> int:
        return len(self.per_dim)

    def idx(self, ident: str, dim: int) -> int:
        L = self.per_dim[dim]
        plb = 0
        ple = glb = plb + L.pad_left
        gle = dlb = glb + L.ghost_left
        dle = ib = dlb + L.dup_left
        ie = drb = ib + L.inner
        dre = grb = drb + L.dup_right
        gre = prb = grb + L.ghost_right
        pre = prb + L.pad_right
        table = {
            "PLB": plb, "PLE": ple, "GLB": glb, "GLE": gle,
            "DLB": dlb, "DLE": dle, "IB": ib, "ILB": ib, "IRB": ib,
            "IE": ie, "ILE": ie, "IRE": ie, "DRB": drb, "DRE": dre,
            "GRB": grb, "GRE": gre, "PRB": prb, "PRE": pre, "TOT": pre,
        }
        return table[ident]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(L.total for L in self.per_dim)

    def owned_slice(self, dim: int, at_lo_boundary: bool) -> slice:
        """Index range this fragment computes in a `loop over field`
        (reference IR_LoopOverPointsInOneFragment.scala:78-101): dup-left
        is skipped unless the fragment touches the physical lower boundary
        (IterationOffsetBegin semantics); dup-right is always owned."""
        lo = self.idx("DLB", dim) if at_lo_boundary else self.idx("DLB", dim) + self.per_dim[dim].dup_left
        return slice(lo, self.idx("DRE", dim))


def fragment_layout(
    name: str,
    localization: str,
    cells_per_frag: Tuple[int, ...],
    ghost: int = 1,
    comm_dup: bool = True,
    comm_ghost: bool = True,
) -> FieldLayout:
    """Build the default layout for a fragment with `cells_per_frag` cells:
    node fields get dup layers of width 1 (shared interface nodes), cell
    fields have no duplication (reference field layout synthesis in
    field/ir + `Layout ...` blocks of ExaSlang 4)."""
    pds = []
    for d, n in enumerate(cells_per_frag):
        if localization == NODE:
            dup, inner = 1, n - 1
        elif localization == CELL:
            dup, inner = 0, n
        elif localization in FACES:
            if FACES.index(localization) == d:
                dup, inner = 1, n - 1
            else:
                dup, inner = 0, n
        else:
            raise ValueError(f"unknown localization {localization!r}")
        pds.append(LayoutPerDim(0, ghost, dup, inner, dup, ghost, 0))
    return FieldLayout(name, localization, tuple(pds), comm_dup, comm_ghost and ghost > 0)
