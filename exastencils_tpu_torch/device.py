"""Device and dtype selection for the port.

Reference: `Knowledge.real_dtype` (exastencils_tpu/config/knowledge.py:224-229),
which returns a jax.numpy dtype; the port's copy of Knowledge returns
this module's torch dtype instead.  The device is always
passed explicitly; only the CPU (the plain PyTorch path) and CUDA (the
hand-written kernels) are supported.
"""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


def real_dtype(knowledge) -> torch.dtype:
    """torch dtype of the solver fields: `tpu_compute_dtype` if set, else
    float64/float32 from `useDblPrecision` (same rule as the reference)."""
    name = knowledge.tpu_compute_dtype
    if name:
        if name not in _DTYPES:
            raise ValueError(f"unsupported tpu_compute_dtype {name!r}")
        return _DTYPES[name]
    return torch.float64 if knowledge.useDblPrecision else torch.float32


def check_device(device) -> torch.device:
    """torch.device for `device`; anything but cpu or cuda is rejected."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev} (cpu or cuda)")
    return dev
