"""Dense single-device execution backend.

Reference: exastencils_tpu/parallel/backend.py (`DenseLevelHandle`,
`DenseBackend`, :53-137).  Global dense node tensors on one device; halo
exchange is absent.  `wrap` stages on CUDA, as the reference's jax.jit
does (:132-133): the wrapped function is captured as CUDA graphs per
binding of its argument tensors and replayed (runtime/staging `Staged`),
its donated outputs written back into the caller's tensors.  On the CPU
`wrap` returns the function itself.  The fragment-sharded backend is later
work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from exastencils_tpu_torch.core.field import Field
from exastencils_tpu_torch.core.grid import NODE, LevelGrid
from exastencils_tpu_torch.core.stencil import IntergridStencil
from exastencils_tpu_torch.ops.boundary import make_bc_applier
from exastencils_tpu_torch.ops.reductions import dot as _dot, norm_l2 as _norm_l2, norm_max as _norm_max
from exastencils_tpu_torch.ops.smoothers import color_mask
from exastencils_tpu_torch.ops.stencil_apply import prolong as dense_prolong, restrict as dense_restrict
from exastencils_tpu_torch.ops.transfer import (
    apply_separable,
    build_prolong_mats,
    build_restrict_mats,
)
from exastencils_tpu_torch.runtime.staging import Staged


@dataclass
class DenseLevelHandle:
    grid: LevelGrid
    shape: Tuple[int, ...]

    @property
    def device(self) -> torch.device:
        return self.grid.device

    @property
    def work_shape(self):
        """Shape solver code sees (== global shape on the dense path)."""
        return self.shape

    def bc_applier(self, field: Field, level: int) -> Callable:
        return make_bc_applier(field, self.grid, level)

    def color_masks(self, num_colors: int = 2, color_fn=None):
        """One mask per colour, each built on first use and kept."""
        cache = {}

        def mask(c):
            if c not in cache:
                cache[c] = color_mask(self.shape, c, self.device, num_colors, color_fn)
            return cache[c]

        return [(lambda c=c: mask(c)) for c in range(num_colors)]

    def coords(self):
        return self.grid.coord_mesh(NODE)

    def dot(self, a, b):
        return _dot(a, b)

    def norm_l2(self, a):
        return _norm_l2(a)

    def norm_max(self, a):
        return _norm_max(a)

    def zeros(self, dtype):
        return torch.zeros(self.shape, dtype=dtype, device=self.device)

    def init_field_local(self, fn, dtype):
        if fn is None:
            return self.zeros(dtype)
        return fn(*self.coords()) + self.zeros(dtype)


class DenseBackend:
    """Single-device backend over global dense node tensors."""

    is_sharded = False

    def __init__(self, grids: Dict[int, LevelGrid]):
        self.grids = grids
        self.handles = {
            lvl: DenseLevelHandle(g, g.shape_of(NODE)) for lvl, g in grids.items()
        }

    def handle(self, level: int) -> DenseLevelHandle:
        return self.handles[level]

    def transfer_fns(self, fine_level: int, restrict_op: IntergridStencil,
                     prolong_op: IntergridStencil):
        fine = self.handles[fine_level]
        coarse = self.handles[fine_level - 1]
        dev, dt = fine.device, fine.grid.dtype
        try:
            # per-dim banded-matrix contractions (ops/transfer.py), moved
            # to the device once
            r_mats = [torch.as_tensor(m, dtype=dt, device=dev) for m in
                      build_restrict_mats(restrict_op, coarse.shape, fine.shape, coarse.shape)]
            p_mats = [torch.as_tensor(m, dtype=dt, device=dev) for m in
                      build_prolong_mats(prolong_op, fine.shape, coarse.shape, fine.shape)]
            return (
                lambda res: apply_separable(r_mats, res),
                lambda sol_c: apply_separable(p_mats, sol_c),
            )
        except ValueError:  # non-separable window -> slicing fallback
            return (
                lambda res: dense_restrict(restrict_op, res, coarse.shape),
                lambda sol_c: dense_prolong(prolong_op, sol_c, fine.shape),
            )

    @property
    def device(self) -> torch.device:
        return next(iter(self.handles.values())).device

    def wrap(self, fn, in_kinds=None, out_kinds=None, donate_argnums=()):
        """`fn` staged on CUDA (output i written back into argument
        donate_argnums[i]); `fn` itself on the CPU."""
        if self.device.type != "cuda":
            return fn
        return Staged(fn, donate=donate_argnums)
