"""Stencil application and 2:1 inter-grid transfers on dense level tensors.

Reference: exastencils_tpu/ops/stencil_apply.py.  Shifted-slice sums over
a zero-padded operand; the term order is the stencil's offset order, which
the CUDA kernels of ops/cuda reproduce for bitwise parity.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from exastencils_tpu_torch.core.stencil import BoundStencil, IntergridStencil


def _pad(x: torch.Tensor, pads, mode: str = "constant") -> torch.Tensor:
    """numpy-style padding (jnp.pad): `pads` is one (lo, hi) pair per dim,
    or one int for all dims; mode 'constant' (zeros) or 'edge'."""
    if isinstance(pads, int):
        pads = ((pads, pads),) * x.dim()
    if mode == "constant":
        flat = []
        for lo, hi in reversed(tuple(pads)):
            flat += [int(lo), int(hi)]
        return F.pad(x, flat)
    if mode != "edge":
        raise ValueError(f"pad mode {mode!r}")
    for d, (lo, hi) in enumerate(pads):
        parts = [x]
        if lo:
            parts.insert(0, x.narrow(d, 0, 1).expand(*[lo if i == d else -1 for i in range(x.dim())]))
        if hi:
            last = x.narrow(d, x.shape[d] - 1, 1)
            parts.append(last.expand(*[hi if i == d else -1 for i in range(x.dim())]))
        if len(parts) > 1:
            x = torch.cat(parts, dim=d)
    return x


def apply_stencil(st: BoundStencil, x: torch.Tensor, padded_radius: int = None,
                  out_shape: Tuple[int, ...] = None) -> torch.Tensor:
    """out[i] = sum_k c_k * x[i + off_k] over the full array, with zero
    ghosts (the node-field boundary semantics).  When the caller already
    supplies a ghost-padded operand (the DSL's bc-aware padding), pass
    `padded_radius` and the unpadded `out_shape`."""
    if len(st.offsets) == 1 and st.radius == 0:
        if padded_radius is not None:
            x = x[tuple(slice(padded_radius, padded_radius + n) for n in out_shape)]
        return st.coefs[0] * x
    if padded_radius is None:
        r, shape = st.radius, x.shape
        xp = _pad(x, [(r, r)] * x.dim())
    else:
        r, shape, xp = padded_radius, tuple(out_shape), x
    out = None
    for off, c in st.items():
        sl = tuple(slice(r + o, r + o + n) for o, n in zip(off, shape))
        term = c * xp[sl]
        out = term if out is None else out + term
    return out


def _restriction_padding(ig: IntergridStencil, coarse_shape, fine_shape):
    pads = []
    for d in range(ig.ndim):
        lo = ig.lo[d]
        ws = ig.weights.shape[d]
        lo_pad = max(0, -lo)
        hi_pad = max(0, 2 * (coarse_shape[d] - 1) + lo + ws - 1 - (fine_shape[d] - 1))
        pads.append((lo_pad, hi_pad))
    return pads


def restrict(ig: IntergridStencil, fine: torch.Tensor, coarse_shape: Tuple[int, ...]) -> torch.Tensor:
    """coarse[i] = sum_d w[d] * fine[2*i + lo + d] with zero ghosts."""
    if ig.kind != "restriction":
        raise ValueError(f"restrict needs a restriction, got {ig.kind}")
    pads = _restriction_padding(ig, coarse_shape, fine.shape)
    fp = _pad(fine, pads)
    out = None
    for idx in np.ndindex(*ig.weights.shape):
        w = float(ig.weights[idx])
        if w == 0.0:
            continue
        sl = tuple(
            slice(p[0] + ig.lo[d] + idx[d], p[0] + ig.lo[d] + idx[d] + 2 * (coarse_shape[d] - 1) + 1, 2)
            for d, p in enumerate(pads)
        )
        term = w * fp[sl]
        out = term if out is None else out + term
    return out


def prolong(ig: IntergridStencil, coarse: torch.Tensor, fine_shape: Tuple[int, ...]) -> torch.Tensor:
    """fine[j] = sum_c w[j - 2*c - lo] * coarse[c] (transpose of restrict),
    as zero-stuffing followed by a correlation with the weight window."""
    if ig.kind != "prolongation":
        raise ValueError(f"prolong needs a prolongation, got {ig.kind}")
    nd = ig.ndim
    up_shape = tuple(2 * (coarse.shape[d] - 1) + 1 for d in range(nd))
    up = torch.zeros(up_shape, dtype=coarse.dtype, device=coarse.device)
    up[tuple(slice(None, None, 2) for _ in range(nd))] = coarse
    pads = []
    for d in range(nd):
        lo = ig.lo[d]
        ws = ig.weights.shape[d]
        min_ix = 0 - (ws - 1) - lo
        max_ix = (fine_shape[d] - 1) - lo
        pads.append((max(0, -min_ix), max(0, max_ix - (up_shape[d] - 1))))
    upp = _pad(up, pads)
    out = None
    for idx in np.ndindex(*ig.weights.shape):
        w = float(ig.weights[idx])
        if w == 0.0:
            continue
        sl = tuple(
            slice(pads[d][0] - idx[d] - ig.lo[d], pads[d][0] - idx[d] - ig.lo[d] + fine_shape[d])
            for d in range(nd)
        )
        term = w * upp[sl]
        out = term if out is None else out + term
    return out
