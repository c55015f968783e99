"""Carry state from the JAX package into the port.

The port has no learned weights; what the two packages share is the
solver state (`GeneratedSolver.init_state()` of exastencils_tpu, handed
over as numpy arrays) and bound stencils / transfer operators.  This
module never imports jax: it reads the JAX objects' plain attributes.
"""

from __future__ import annotations

import numpy as np
import torch

from exastencils_tpu_torch.core.stencil import BoundStencil, IntergridStencil
from exastencils_tpu_torch.device import check_device


def from_jax_state(sol_np, rhs_np, device, dtype: torch.dtype):
    """(sol, rhs) tensors on `device` from the JAX solver's init_state()
    arrays (converted to numpy by the caller)."""
    device = check_device(device)
    return tuple(
        torch.from_numpy(np.array(a)).to(device=device, dtype=dtype).contiguous()
        for a in (sol_np, rhs_np)
    )


def _coef_from_jax(c):
    a = np.asarray(c)
    return float(a) if a.ndim == 0 else torch.from_numpy(a.copy())


def stencil_from_jax(st):
    """The port's counterpart of a JAX `BoundStencil` or
    `IntergridStencil`: offsets, coefficients and weights are copied.
    Array coefficients become CPU tensors."""
    if hasattr(st, "offsets"):
        return BoundStencil(
            st.name,
            tuple(tuple(int(o) for o in off) for off in st.offsets),
            tuple(_coef_from_jax(c) for c in st.coefs),
        )
    kernels = None
    if st.kernels_1d is not None:
        kernels = tuple(tuple(float(v) for v in k) for k in st.kernels_1d)
    return IntergridStencil(st.kind, np.array(st.weights, dtype=np.float64),
                            tuple(int(v) for v in st.lo), kernels)


def dsl_state_from_jax(state_np, device, dtype: torch.dtype):
    """The port's DSL state from a JAX `L4Executable.state` whose arrays
    the caller converted to numpy: {(field, level): tensor on `device`},
    slots included (a slotted field keeps its leading slot dim).  Real
    arrays become `dtype`, complex arrays its complex counterpart, other
    arrays keep their dtype.  The caller copies `slot_index` as is."""
    device = check_device(device)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    out = {}
    for key, a in state_np.items():
        t = torch.from_numpy(np.array(a))
        if t.dtype.is_complex:
            t = t.to(cdtype)
        elif t.dtype.is_floating_point:
            t = t.to(dtype)
        out[key] = t.to(device).contiguous()
    return out
