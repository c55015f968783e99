"""The residual check of a dense 3D level, K9 and K10: wrappers and plain
PyTorch versions.

    K9  residual           res = rhs - A sol on the inner nodes, in place
                           in `res`; the ring set to zero or left as it is
    K10 inner_sum_squares  the sum of res * res over the inner nodes

They replace no TPU kernel (the JAX package leaves a program's standalone
residual and norm to XLA).  dsl/fastpath.py routes a float32 or float64
ExaSlang program's `CalcRes`-shaped function bodies (`res = f - A * u`
over res, then `apply bc to res`) and its `+ : acc += res * res`
reductions here, on levels of at least 33 nodes a dim: the plain ops took
~40 passes a check.  The kernels are csrc/check3d.cu's, built into the
library of ops/cuda/stream3d.py.  As for K1-K8, a wrapper given CUDA tensors launches
(or raises), given CPU tensors runs the plain version, and counts its
launches on its `.launches` (runtime/staging `count_launch`: replays of a
captured launch count too); K10's count is one per sum, though each sum is
two launches (block partials, then their one-block sum).

The plain versions repeat the DSL executor's arithmetic: K9 the masked
`rhs - A sol` (ops/stencil_apply.apply_stencil, the stencil's term order)
with the ring zeroed as `apply bc` zeroes it, K10 `torch.sum(torch.where(
inner, res * res, 0))`.  K9's kernel sums the star's terms centre, z-, z+,
y-, y+, x-, x+, bitwise the plain version for a stencil written in that
order; K10's kernel sums in double in another order than torch.sum.  In
bfloat16 both keep csrc/star3d.cuh's rounding contract (float32
arithmetic, each stored value rounded once: the residual, each square,
the sum).
"""

from __future__ import annotations

import functools

import torch

from exastencils_tpu_torch.core.stencil import BoundStencil
from exastencils_tpu_torch.ops.cuda.stream3d import (
    DTYPE_CODES,
    NO_EXCL,
    _check,
    _check_cuda_fields,
    _check_shapes,
    _compute,
    _device_type,
    _inner_mask,
    _sm_count,
    _star_array,
    _stored,
    _stream,
    load_library,
)
from exastencils_tpu_torch.ops.stencil_apply import apply_stencil
from exastencils_tpu_torch.runtime.staging import count_launch

# K9: a block's (y, x) tile of inner columns and the bytes of a column its
# z-chunk of inner planes holds at most; K10: a block's threads and blocks a
# SM (check3d.cu kResTileY, kResTileX, kSumThreads; the chunk and the grid
# are the wrapper's).  Chunks of 32 bytes ran fastest at 513^3 on an H100 in
# each dtype (8 float32 planes: 0.62 ms, against 0.92 at 64; PERF.md §6).
RES_TILE, RES_CHUNK_BYTES = (8, 32), 32
SUM_THREADS, SUM_BLOCKS_PER_SM = 256, 4


@functools.cache
def _library():
    """The kernel library, its check3d.cu constants checked against these."""
    lib = load_library()
    const = tuple(lib.exa_check_constant(k) for k in range(3))
    if const != (*RES_TILE, SUM_THREADS):
        raise RuntimeError(f"check3d.cu's layout constants {const} differ from the wrapper's")
    return lib


# ----------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the reference on the card)
# ----------------------------------------------------------------------


def residual_plain(sol, rhs, A: BoundStencil, ring=None):
    """rhs - A sol on the inner nodes; on the ring zero (`ring` None) or
    `ring`'s values.  Returns a new tensor."""
    inner = _inner_mask(sol.shape, NO_EXCL, sol.device)
    dtype = sol.dtype
    res = _stored(_compute(rhs) - apply_stencil(A, _compute(sol)), dtype)
    return torch.where(inner, res, 0.0 if ring is None else _compute(ring)).to(dtype)


def inner_sum_squares_plain(res):
    """The sum of res * res over the inner nodes, a 0-dim tensor of res's
    dtype: the DSL executor's masked sum."""
    inner = _inner_mask(res.shape, NO_EXCL, res.device)
    return torch.sum(torch.where(inner, res * res, 0))


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------


def res_chunk(shape, itemsize: int, n_sm: int) -> int:
    """Inner z-planes of one K9 block: RES_CHUNK_BYTES of a column of
    `itemsize`-byte values, halved (down to 2) while the grid would give
    fewer than eight blocks to each of the card's `n_sm` SMs."""
    nz, ny, nx = (int(n) for n in shape)
    tiles = -(-(ny - 1) // RES_TILE[0]) * -(-(nx - 1) // RES_TILE[1])
    chunk = max(RES_CHUNK_BYTES // itemsize, 1)
    while chunk > 2 and -(-(nz - 2) // chunk) * tiles < 8 * n_sm:
        chunk //= 2
    return chunk


def _shares(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def residual(sol, rhs, A: BoundStencil, res, zero_ring: bool = True):
    """K9: res = rhs - A sol on the inner nodes, in place in `res` (sol's
    shape, sharing storage with neither sol nor rhs); the ring set to zero
    with `zero_ring`, else left as it is.  Returns res.  On CUDA one
    check3d.cu launch in z-chunks of res_chunk planes."""
    if _shares(res, sol) or _shares(res, rhs):
        raise ValueError("res must not share storage with sol or rhs")
    if _device_type(sol, rhs, res) == "cpu":
        return res.copy_(residual_plain(sol, rhs, A, None if zero_ring else res))
    _check_cuda_fields(sol, rhs, res)
    _check_shapes(sol, rhs)
    _check_shapes(sol, res)
    _, coefs = _star_array(A)
    lib = _library()
    nz, ny, nx = sol.shape
    with torch.cuda.device(sol.device):
        chunk = res_chunk(sol.shape, sol.element_size(), _sm_count(sol.device.index))
        err = lib.exa_residual(res.data_ptr(), sol.data_ptr(), rhs.data_ptr(), nz, ny, nx, coefs,
                               int(zero_ring), chunk, DTYPE_CODES[sol.dtype], _stream())
        _check(lib, err, "residual")
        count_launch(residual)
    return res


residual.launches = 0


def inner_sum_squares(res):
    """K10: the sum of res * res over the inner nodes, as a new 0-dim tensor
    of res's dtype.  On CUDA the block partials (SUM_BLOCKS_PER_SM blocks a
    SM, so the same card always sums in the same order) into a float64
    buffer of this call, then their sum in one block."""
    if _device_type(res) == "cpu":
        return inner_sum_squares_plain(res)
    _check_cuda_fields(res)
    lib = _library()
    nz, ny, nx = res.shape
    with torch.cuda.device(res.device):
        blocks = SUM_BLOCKS_PER_SM * _sm_count(res.device.index)
        partial = torch.empty(blocks, dtype=torch.float64, device=res.device)
        out = torch.empty((), dtype=res.dtype, device=res.device)
        err = lib.exa_sum_squares(res.data_ptr(), partial.data_ptr(), out.data_ptr(), nz, ny, nx,
                                  blocks, DTYPE_CODES[res.dtype], _stream())
        _check(lib, err, "inner_sum_squares")
        count_launch(inner_sum_squares)
    return out


inner_sum_squares.launches = 0
