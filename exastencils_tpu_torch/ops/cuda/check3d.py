"""The residual check of a dense 3D level, K9, K10 and K13: wrappers and
plain PyTorch versions.

    K9  residual           res = rhs - A sol on the inner nodes, in place
                           in `res`; the ring set to zero or left as it is
    K10 inner_sum_squares  the sum of res * res over the inner nodes
    K13 res_norm           the l2 norm of rhs - A sol over the inner nodes,
                           the residual never stored; A a constant star or
                           a variable-coefficient star's face arrays

They replace no TPU kernel (the JAX package leaves a program's standalone
residual and norm to XLA).  dsl/fastpath.py routes a float32 or float64
ExaSlang program's `CalcRes`-shaped function bodies (`res = f - A * u`
over res, then `apply bc to res`) and its `+ : acc += res * res`
reductions here, on levels of at least 33 nodes a dim: the plain ops took
~40 passes a check.  K13 is the solver API's check: `Multigrid.res_norm`
calls it where solver/synthesis.py set the level's `res_norm_fn`
(ops/cuda `make_fused_res_norm_3d`), in place of `norm_l2(bc_res(rhs -
A sol))` on plain ops.  The kernels are csrc/check3d.cu's, built into the
library of library.py.  As for K1-K8, a wrapper given CUDA tensors launches
(or raises), given CPU tensors runs the plain version, and counts its
launches on its `.launches` (runtime/staging `count_launch`: replays of a
captured launch count too); K10's and K13's counts are one per sum or
norm, though each is two launches (block partials, then their one-block
sum).

The plain versions repeat the DSL executor's arithmetic: K9 the masked
`rhs - A sol` (ops/stencil_apply.apply_stencil, the stencil's term order)
with the ring zeroed as `apply bc` zeroes it, K10 `torch.sum(torch.where(
inner, res * res, 0))`.  K9's kernel sums the star's terms centre, z-, z+,
y-, y+, x-, x+, bitwise the plain version for a stencil written in that
order; K10's kernel sums in double in another order than torch.sum.  In
bfloat16 both keep csrc/star3d.cuh's rounding contract (float32
arithmetic, each stored value rounded once: the residual, each square,
the sum).  K13's plain version is the solver's plain check, `norm_l2` of
K9's plain residual with the ring zeroed; its kernel forms each node's
residual as K9 does (bitwise, the centre of a face-array star rebuilt in
the stencil's order), squares it in the field's type and sums in double
in K10's way, then takes the square root in the field's type.  float32
and float64 only.
"""

from __future__ import annotations

import functools
import math

import torch

from exastencils_tpu_torch.core.stencil import BoundStencil
from exastencils_tpu_torch.ops.cuda.library import (
    DTYPE_CODES,
    NO_EXCL,
    check_cuda_fields,
    check_error,
    check_shapes,
    compute,
    current_stream,
    device_type,
    inner_mask,
    load_library,
    sm_count,
    star_array,
    stored,
)
from exastencils_tpu_torch.ops.cuda.stream3d import FACE_DTYPES, check_faces
from exastencils_tpu_torch.ops.reductions import norm_l2
from exastencils_tpu_torch.ops.stencil_apply import apply_stencil
from exastencils_tpu_torch.runtime.staging import count_launch

# K9: a block's (y, x) tile of inner columns and the bytes of a column its
# z-chunk of inner planes holds at most; K10: a block's threads and blocks a
# SM (check3d.cu kResTileY, kResTileX, kSumThreads; the chunk and the grid
# are the wrapper's).  Chunks of 32 bytes ran fastest at 513^3 on an H100 in
# each dtype (8 float32 planes: 0.62 ms, against 0.92 at 64; PERF.md §6).
RES_TILE, RES_CHUNK_BYTES = (8, 32), 32
SUM_THREADS, SUM_BLOCKS_PER_SM = 256, 4
# K13: K9's tiles; the bytes of a column its z-chunk holds at most
NORM_CHUNK_BYTES = 128


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
    inner = inner_mask(sol.shape, NO_EXCL, sol.device)
    dtype = sol.dtype
    res = stored(compute(rhs) - apply_stencil(A, compute(sol)), dtype)
    return torch.where(inner, res, 0.0 if ring is None else compute(ring)).to(dtype)


def inner_sum_squares_plain(res):
    """The sum of res * res over the inner nodes, a 0-dim tensor of res's
    dtype: the DSL executor's masked sum."""
    inner = inner_mask(res.shape, NO_EXCL, res.device)
    return torch.sum(torch.where(inner, res * res, 0))


def res_norm_plain(sol, rhs, A: BoundStencil):
    """The l2 norm of rhs - A sol with the ring zeroed, a 0-dim tensor of
    sol's dtype: `Multigrid.res_norm`'s plain ops for a node residual whose
    Dirichlet value is 0, bit for bit."""
    return norm_l2(residual_plain(sol, rhs, A))


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------


def res_chunk(shape, itemsize: int, n_sm: int, chunk_bytes: int = RES_CHUNK_BYTES) -> int:
    """Inner z-planes of one K9 (K13: chunk_bytes NORM_CHUNK_BYTES) block:
    `chunk_bytes` of a column of `itemsize`-byte values, halved (down to 2)
    while the grid would give fewer than eight blocks to each of the
    card's `n_sm` SMs."""
    nz, ny, nx = (int(n) for n in shape)
    tiles = -(-(ny - 1) // RES_TILE[0]) * -(-(nx - 1) // RES_TILE[1])
    chunk = max(chunk_bytes // itemsize, 1)
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
    if device_type(sol, rhs, res) == "cpu":
        return res.copy_(residual_plain(sol, rhs, A, None if zero_ring else res))
    check_cuda_fields(sol, rhs, res)
    check_shapes(sol, rhs)
    check_shapes(sol, res)
    _, coefs = star_array(A)
    lib = _library()
    nz, ny, nx = sol.shape
    with torch.cuda.device(sol.device):
        chunk = res_chunk(sol.shape, sol.element_size(), sm_count(sol.device.index))
        err = lib.exa_residual(res.data_ptr(), sol.data_ptr(), rhs.data_ptr(), nz, ny, nx, coefs,
                               int(zero_ring), chunk, DTYPE_CODES[sol.dtype], current_stream())
        check_error(lib, err, "residual")
        count_launch(residual)
    return res


residual.launches = 0


def inner_sum_squares(res):
    """K10: the sum of res * res over the inner nodes, as a new 0-dim tensor
    of res's dtype.  On CUDA the block partials (SUM_BLOCKS_PER_SM blocks a
    SM, so the same card always sums in the same order) into a float64
    buffer of this call, then their sum in one block."""
    if device_type(res) == "cpu":
        return inner_sum_squares_plain(res)
    check_cuda_fields(res)
    lib = _library()
    nz, ny, nx = res.shape
    with torch.cuda.device(res.device):
        blocks = SUM_BLOCKS_PER_SM * sm_count(res.device.index)
        partial = torch.empty(blocks, dtype=torch.float64, device=res.device)
        out = torch.empty((), dtype=res.dtype, device=res.device)
        err = lib.exa_sum_squares(res.data_ptr(), partial.data_ptr(), out.data_ptr(), nz, ny, nx,
                                  blocks, DTYPE_CODES[res.dtype], current_stream())
        check_error(lib, err, "inner_sum_squares")
        count_launch(inner_sum_squares)
    return out


inner_sum_squares.launches = 0


def norm_blocks(shape, chunk: int) -> int:
    """K13's blocks, and partials: a RES_TILE tile of inner columns and
    `chunk` inner planes each (check3d.cu res_norm_grid)."""
    nz, ny, nx = (int(n) for n in shape)
    return math.prod(-(-(n - 2) // t) for n, t in ((nx, RES_TILE[1]), (ny, RES_TILE[0]),
                                                    (nz, chunk)))


def res_norm(sol, rhs, A: BoundStencil, faces=None, chunk=None):
    """K13: the l2 norm of rhs - A sol over the inner nodes (the ring's
    residual is zero), a new 0-dim tensor of sol's dtype.  A is a constant
    radius-1 star, or, with `faces` (stream3d.face_arrays(sol.shape, A)),
    the variable-coefficient star they hold, which the kernel reads alone.
    On CUDA the block partials (res_chunk planes of NORM_CHUNK_BYTES a
    block, so the same shape on the same card always sums in the same
    order) into a float64 buffer of this call, then their sum and its root
    in one block; on the CPU res_norm_plain."""
    if device_type(sol, rhs, *(faces or ())) == "cpu":
        return res_norm_plain(sol, rhs, A)
    check_cuda_fields(sol, rhs)
    if sol.dtype not in FACE_DTYPES:
        raise ValueError(f"res_norm takes float32 or float64, not {sol.dtype}")
    check_shapes(sol, rhs)
    if faces is None:
        _, coefs = star_array(A)
        ptrs = (None, None, None)
    else:
        check_faces(sol, faces)
        coefs, ptrs = None, tuple(f.data_ptr() for f in faces)
    lib = _library()
    nz, ny, nx = sol.shape
    with torch.cuda.device(sol.device):
        if chunk is None:
            chunk = res_chunk(sol.shape, sol.element_size(), sm_count(sol.device.index),
                              NORM_CHUNK_BYTES)
        blocks = norm_blocks(sol.shape, chunk)
        partial = torch.empty(blocks, dtype=torch.float64, device=sol.device)
        out = torch.empty((), dtype=sol.dtype, device=sol.device)
        err = lib.exa_res_norm(sol.data_ptr(), rhs.data_ptr(), *ptrs, partial.data_ptr(),
                               out.data_ptr(), nz, ny, nx, coefs, chunk, blocks,
                               DTYPE_CODES[sol.dtype], current_stream())
        check_error(lib, err, "res_norm")
        count_launch(res_norm)
    return out


res_norm.launches = 0
