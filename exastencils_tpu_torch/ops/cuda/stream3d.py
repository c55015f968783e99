"""The 3D streaming kernels K1-K8, K11 and K12: wrappers, their launch
geometry, plain PyTorch versions and the schedule dispatchers.

Reference: exastencils_tpu/ops/pallas/stream3d.py (`rbgs_fused_3d` :192,
`res_restrict_fused_3d` :365, `prolong_correct_fused_3d` :454,
`smooth_res_restrict_fused_3d` :603, `prolong_correct_smooth_fused_3d`
:746, `_pair_schedule` :184, `_star_coefs`, `pallas_applicable_3d`, and
the v1 kernels behind them) and exastencils_tpu/ops/pallas/stream3d_pair.py
(the v2 kernels).

    K1 smooth_res_restrict     K RBGS iterations + residual + restriction
    K2 prolong_correct_smooth  prolongation + correction + K RBGS iterations
    K3 rbgs_fused              K RBGS iterations
    K4 res_restrict            residual + restriction
    K5 prolong_correct         prolongation + correction
    K6 rbgs_wavefront                    K3's maths, one pass, cluster-shared halo
    K7 smooth_res_restrict_wavefront     K1's maths, one pass, cluster-shared halo
    K8 prolong_correct_smooth_wavefront  K2's maths, one pass, cluster-shared halo
    K11 smooth_res_restrict_faces     K1 for a variable-coefficient star (face arrays)
    K12 prolong_correct_smooth_faces  K2 for a variable-coefficient star (face arrays)

As in the JAX package, the dispatchers `rbgs_fused_3d`,
`smooth_res_restrict_fused_3d` and `prolong_correct_smooth_fused_3d` run
K3/K1/K2 (the v2 schedule, the default) or, with EXA_STREAM_V1=1 in the
environment when they are called, K6/K7/K8 (the v1 single-plane
schedule).

K11/K12 replace no TPU kernel (the JAX package has no variable-coefficient
model): they run K1/K2's maths on the star of
models/poisson.varcoeff_laplace_stencil, which carries its three face
arrays (`face_arrays` states the contract).

The kernels are CUDA C++ for sm_90a in ../../csrc/ (legs3d.cu: K1-K3,
one z-chunked pass per call, K3 its transfer-free mode, K11/K12 its
variable-coefficient build; stream3d.cu: K4/K5, z-streamed tiles;
cluster_legs3d.cu: K6-K8, the same one-pass design on thread-block
clusters that share their y/x halo, K6 its transfer-free mode), in the
library of library.py.  A wrapper given CUDA tensors
launches the kernels (or raises); given CPU tensors it runs the plain
version; any other device raises.  Each wrapper counts the kernel
launches it makes in its own `.launches` (runtime/staging
`count_launch`: a launch captured into a CUDA graph is counted by the
recording at every replay of that graph).  K1-K3 and K5 update `sol` in
place and return it, where the JAX version relied on the donated
iterate: K1-K3's blocks run concurrently on overlapping windows, so their
kernel writes a second tensor, which the wrapper copies back into `sol`.
K6-K8 write a new tensor and return it.

Fields are float32, float64 or bfloat16 (DTYPE_CODES; any other dtype
raises on the CUDA path).  In bfloat16 the kernels and the plain versions
keep csrc/star3d.cuh's rounding contract: float32 arithmetic inside a node
update or transfer sum, one rounding to bfloat16 where a kernel stores, so
the kernels' sweeps are the plain versions' bitwise and their transfers
within a rounding of them.  The float32 and float64 paths are as they
were.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import os
from typing import Sequence, Tuple

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
    library_path,
    load_library,
    sm_count,
    star_array,
    star_coefs,
    stored,
)
from exastencils_tpu_torch.ops.smoothers import color_mask, jacobi_update
from exastencils_tpu_torch.ops.stencil_apply import apply_stencil
from exastencils_tpu_torch.ops.transfer import (
    apply_separable,
    prolongation_matrix_full_ghosted,
    restriction_matrix_1d,
)
from exastencils_tpu_torch.runtime.staging import count_launch

NO_GHOST = (0, 0, 0)  # per-dim ghost width of a halo-extended fragment (K1/K2)
MAX_TAPS = 3  # transfer taps per dim the kernels take (kMaxTaps)

# The dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
# The kernels' modes (legs3d.cu, cluster_legs3d.cu): LEG_SMOOTH is K3/K6,
# LEG_PROLONG K2/K8, LEG_RESTRICT K1/K7.
LEG_SMOOTH, LEG_PROLONG, LEG_RESTRICT = 0, 1, 2
# K1-K3 (legs3d.cu): one block's (y, x) output tile edge and largest
# z-chunk, the planes in flight ahead of the one swept, and the iterations
# one launch holds (kLegTile, kLegChunk, kLegAhead, kMaxLegK)
LEG_TILE, LEG_CHUNK, LEG_AHEAD, MAX_LEG_K = 32, 128, 2, 3
# K6-K8 (cluster_legs3d.cu): one block's (y, x) output tile edge, the
# planes in flight, the iterations one launch holds, the most blocks a
# cluster has in x, and a block's threads, at most (kTile, kAhead, kMaxK,
# kMaxClusterX, kMaxThreads)
CLUSTER_TILE, CLUSTER_AHEAD, MAX_CLUSTER_K, MAX_CLUSTER_X, CLUSTER_THREADS = 32, 2, 3, 2, 1024
# The cluster shapes, (y, x) blocks, that chip_smoke.py times, and the one
# each kernel launches on: the fastest at 513^3 f32, K=3, on an H100
# (PERF.md §6): K7 shares its x-halo in pairs of blocks; for K8 the cluster
# barrier and the reads across the edge cost more than the halo they save.
CLUSTER_SHAPES = ((2, 2), (4, 2), (1, 2), (2, 1), (1, 1))
CLUSTER = {LEG_SMOOTH: (1, 1), LEG_RESTRICT: (1, 2), LEG_PROLONG: (1, 1)}
# K4/K5 (stream3d.cu): K5's (y, x) tile of inner fine nodes, K4's (y, x)
# tile of coarse nodes (the last tile of a dim takes one node more), a
# block's threads, its largest z-chunk of fine planes and K4's planes in
# flight (kUpTileY/X, kDownTileY/X, kTransferThreads, kTransferChunk,
# kDownAhead)
UP_TILE, DOWN_TILE = (16, 64), (8, 32)
TRANSFER_THREADS, TRANSFER_CHUNK, TRANSFER_AHEAD = 256, 32, 1


def _kernel_shape(shape) -> bool:
    """3D, at least 5 z-planes and 3 nodes in y/x."""
    return len(shape) == 3 and shape[0] >= 5 and shape[1] >= 3 and shape[2] >= 3


def cuda_applicable_3d(shape, offsets, coefs) -> bool:
    """The kernels' contract: 3D, at least 5 z-planes and 3 nodes in y/x,
    constant radius-1 star stencil.  (The TPU version also checked a VMEM
    budget, which has no counterpart here.)"""
    return _kernel_shape(tuple(shape)) and star_coefs(offsets, coefs, 3) is not None


# The radius-1 star's entries in the kernels' order (csrc/star3d.cuh Star):
# centre, z-, z+, y-, y+, x-, x+
STAR_OFFSETS = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))
# The field dtypes K11-K13 take (legs3d.cu and check3d.cu build them for float and double)
FACE_DTYPES = (torch.float32, torch.float64)


def face_arrays(shape, A: BoundStencil):
    """K11/K12's (and check3d.py's K13's) contract on a level of `shape`:
    the face arrays that a bound stencil carries (`BoundStencil.faces`,
    which only models/poisson.varcoeff_laplace_stencil's bind sets), as
    (face_z, face_y, face_x), or None.  They are float32 or float64, of one dtype,
    on one device, face_d n_d + 1 long along d; the stencil's minus and
    plus entries of axis d are face_d's views at offsets 0 and 1 and its
    centre their negative sum, built together with them, so the kernels
    read no centre array.  The shape is the kernels' (`_kernel_shape`).
    EXA_STREAM_V1=1 does not apply: it chooses between K1-K3 and K6-K8,
    and K11/K12 have one schedule."""
    shape, faces = tuple(int(n) for n in shape), A.faces
    if faces is None or len(faces) != 3 or not _kernel_shape(shape):
        return None
    if faces[0].dtype not in FACE_DTYPES:
        return None
    for d, f in enumerate(faces):
        want = tuple(n + (i == d) for i, n in enumerate(shape))
        if f.dtype != faces[0].dtype or f.device != faces[0].device or tuple(f.shape) != want:
            return None
    return faces


@functools.cache
def _library():
    """The kernel library (library.load_library), the layout constants of
    stream3d.cu, legs3d.cu and cluster_legs3d.cu checked against these."""
    lib, so = load_library(), library_path()
    if lib.exa_max_taps() != MAX_TAPS:
        raise RuntimeError(f"{so}: kMaxTaps {lib.exa_max_taps()} != {MAX_TAPS}")
    transfer = tuple(lib.exa_transfer_constant(k) for k in range(7))
    if transfer != (*UP_TILE, *DOWN_TILE, TRANSFER_THREADS, TRANSFER_CHUNK, TRANSFER_AHEAD):
        raise RuntimeError(f"{so}: stream3d.cu's layout constants {transfer} differ from the wrapper's")
    leg = tuple(lib.exa_leg_constant(k) for k in range(4))
    if leg != (LEG_TILE, LEG_CHUNK, LEG_AHEAD, MAX_LEG_K):
        raise RuntimeError(f"{so}: legs3d.cu's layout constants {leg} differ from the wrapper's")
    for mode, k, reach, dtype in itertools.product((LEG_SMOOTH, LEG_PROLONG, LEG_RESTRICT),
                                                   range(1, MAX_LEG_K + 1), (0, 1), DTYPE_CODES):
        if (lib.exa_leg_smem(mode, k, reach, DTYPE_CODES[dtype])
                != _leg_smem(mode, k, reach, smem_itemsize(dtype))):
            raise RuntimeError(f"{so}: legs3d.cu's leg_smem{(mode, k, reach, dtype)} differs"
                               " from the wrapper's")
        if lib.exa_leg_faces_threads(mode, k, reach) != _leg_threads(mode, k, reach):
            raise RuntimeError(f"{so}: legs3d.cu's K11/K12 threads of"
                               f" {(mode, k, reach)} differ from the wrapper's")
    const = tuple(lib.exa_cluster_constant(k) for k in range(5))
    if const != (CLUSTER_TILE, CLUSTER_AHEAD, MAX_CLUSTER_K, MAX_CLUSTER_X, CLUSTER_THREADS):
        raise RuntimeError(f"{so}: cluster_legs3d.cu's constants {const} differ from the wrapper's")
    for mode, k, reach, cluster, dtype in itertools.product(
            (LEG_SMOOTH, LEG_PROLONG, LEG_RESTRICT), range(1, MAX_CLUSTER_K + 1), (0, 1),
            CLUSTER_SHAPES, DTYPE_CODES):
        if (lib.exa_cluster_smem(mode, k, reach, *cluster, DTYPE_CODES[dtype])
                != _cluster_smem(mode, k, reach, smem_itemsize(dtype), cluster)
                or lib.exa_cluster_threads(mode, k, reach, *cluster)
                != _cluster_threads(mode, k, reach, cluster)):
            raise RuntimeError(f"{so}: cluster_legs3d.cu's launch shape of"
                               f" {(mode, k, reach, cluster, dtype)} differs from the wrapper's")
    bad = max(DTYPE_CODES.values()) + 1
    if (lib.exa_leg_smem(LEG_SMOOTH, 1, 0, bad) != -1
            or lib.exa_cluster_smem(LEG_SMOOTH, 1, 0, 1, 1, bad) != -1):
        raise RuntimeError(f"{so}: a dtype code that a kernel does not take is not rejected")
    return lib


# ----------------------------------------------------------------------
# argument marshalling and launches
# ----------------------------------------------------------------------


def _taps_arrays(kernels: Sequence[Sequence[float]], lo: Sequence[int]):
    if len(kernels) != 3 or len(lo) != 3:
        raise ValueError("need one transfer kernel and lo per dim")
    if any(len(k) > MAX_TAPS for k in kernels):
        raise ValueError(f"transfer kernels have at most {MAX_TAPS} taps")
    flat = []
    for k in kernels:
        flat += [float(v) for v in k] + [0.0] * (MAX_TAPS - len(k))
    return ((ctypes.c_double * (3 * MAX_TAPS))(*flat),
            (ctypes.c_int * 3)(*(len(k) for k in kernels)),
            (ctypes.c_int * 3)(*(int(v) for v in lo)))


def _excl_array(excl: Sequence[int]):
    if len(excl) != 6:
        raise ValueError(f"excl needs 6 plane indices (z lo/hi, y lo/hi, x lo/hi), got {excl}")
    return (ctypes.c_int * 6)(*(int(p) for p in excl))


def smem_itemsize(dtype: torch.dtype) -> int:
    """Bytes of one value in a kernel's shared memory: its compute type's
    (csrc/star3d.cuh), so 4 for bfloat16, whose rings are float32."""
    return 4 if dtype == torch.bfloat16 else torch.empty((), dtype=dtype).element_size()


def _check_plane(sol):
    """K4/K5 index within a plane in 32 bits."""
    if sol.shape[1] * sol.shape[2] >= 2 ** 31:
        raise ValueError(f"shape {tuple(sol.shape)}: a plane must hold < 2^31 nodes")


# ----------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the reference on the card)
# ----------------------------------------------------------------------


def _rbgs_plain(sol, rhs, A, omega, K, inner):
    masks = [color_mask(sol.shape, c, sol.device) & inner for c in (0, 1)]
    dtype, sol, rhs = sol.dtype, compute(sol), compute(rhs)
    for _ in range(K):
        for m in masks:
            sol = stored(jacobi_update(sol, rhs, A, omega, m), dtype)
    return sol.to(dtype)


def coarse_window(coarse_shape, ghost=NO_GHOST):
    """K1's coarse write window per dim, (lo, hi) inclusive, on a fragment
    with `ghost` layers: every z-plane, and in y/x the rows g .. n-1-g
    (the reference's ghosted restriction matrices write those only,
    ops/pallas/__init__.py:187-199); every node without ghosts."""
    return tuple((0 if d == 0 else g, int(n) - 1 - (0 if d == 0 else g))
                 for d, (n, g) in enumerate(zip(coarse_shape, ghost)))


def _res_restrict_plain(sol, rhs, A, r_kernels, r_lo, coarse_shape, inner, ghost=NO_GHOST):
    """The residual on `inner` nodes, restricted: coarse node c of the
    write window (coarse_window) takes the fine nodes 2c + lo - ghost + k
    (zero elsewhere)."""
    dtype, sol, rhs = sol.dtype, compute(sol), compute(rhs)
    res = stored(torch.where(inner, rhs - apply_stencil(A, sol), 0.0), dtype)
    mats = []
    for d, (w0, w1) in enumerate(coarse_window(coarse_shape, ghost)):
        mats.append(restriction_matrix_1d(r_kernels[d], r_lo[d] - ghost[d] + 2 * w0, w1 - w0 + 1,
                                          sol.shape[d], coarse_shape[d], 0, w0))
    return apply_separable(mats, res).to(dtype)


def _prolong_correct_plain(sol, sol_c, p_kernels, p_lo, inner, ghost=NO_GHOST):
    mats = [prolongation_matrix_full_ghosted(p_kernels[d], p_lo[d], sol_c.shape[d],
                                             sol.shape[d], ghost[d]) for d in range(3)]
    new = compute(sol) + apply_separable(mats, compute(sol_c))
    return torch.where(inner, new.to(sol.dtype), sol)


def rbgs_fused_plain(sol, rhs, A: BoundStencil, omega: float, K: int, excl=NO_EXCL):
    """K RBGS iterations as masked-Jacobi half-sweeps, red first, on the
    inner non-excl nodes.  Out of place: returns the new sol."""
    return _rbgs_plain(sol, rhs, A, omega, K, inner_mask(sol.shape, excl, sol.device))


def res_restrict_plain(sol, rhs, A: BoundStencil, r_kernels, r_lo, coarse_shape):
    """The residual masked to inner nodes, then the banded-matrix
    restriction.  Returns the coarse rhs."""
    inner = inner_mask(sol.shape, NO_EXCL, sol.device)
    return _res_restrict_plain(sol, rhs, A, r_kernels, r_lo, coarse_shape, inner)


def prolong_correct_plain(sol, sol_c, p_kernels, p_lo):
    """sol + P sol_c on inner nodes (banded-matrix prolongation); the
    boundary keeps its values.  Out of place: returns the new sol."""
    inner = inner_mask(sol.shape, NO_EXCL, sol.device)
    return _prolong_correct_plain(sol, sol_c, p_kernels, p_lo, inner)


def smooth_res_restrict_plain(sol, rhs, A: BoundStencil, omega: float, K: int,
                              r_kernels, r_lo, coarse_shape, excl=NO_EXCL, ghost=NO_GHOST):
    """K RBGS iterations, then the residual restricted (on a halo-extended
    fragment: `ghost` as smooth_res_restrict's).  Out of place: returns
    (smoothed sol, coarse rhs)."""
    inner = inner_mask(sol.shape, excl, sol.device)
    sol = _rbgs_plain(sol, rhs, A, omega, K, inner)
    return sol, _res_restrict_plain(sol, rhs, A, r_kernels, r_lo, coarse_shape, inner, ghost)


def prolong_correct_smooth_plain(sol, sol_c, rhs, A: BoundStencil, omega: float,
                                 K: int, p_kernels, p_lo, excl=NO_EXCL, ghost=NO_GHOST):
    """sol + P sol_c on inner nodes (on a halo-extended fragment the
    prolongation shifted by `ghost`), then K RBGS iterations.  Out of
    place: returns the new sol."""
    inner = inner_mask(sol.shape, excl, sol.device)
    sol = _prolong_correct_plain(sol, sol_c, p_kernels, p_lo, inner, ghost)
    return _rbgs_plain(sol, rhs, A, omega, K, inner)


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------


def leg_halo(mode: int, K: int, reach: int) -> int:
    """The window's halo around one block's tile (legs3d.cu geom_for):
    2K, K1 2K+1+reach."""
    return 2 * K + 1 + reach if mode == LEG_RESTRICT else 2 * K


def _leg_smem(mode: int, K: int, reach: int, itemsize: int) -> int:
    """Dynamic shared memory of one K1/K2 block (leg_smem in legs3d.cu):
    rings of 2K+2+LEG_AHEAD window planes (K1: one more) of sol and of rhs,
    then K2's 4 coarse boxes and 2 boxes of their z-sums, or K1's 4 boxes
    of z-sums (the tile plus `reach`)."""
    r = LEG_TILE + 2 * leg_halo(mode, K, reach)
    down = mode == LEG_RESTRICT
    slots = 2 * (2 * K + 2 + down + LEG_AHEAD)
    extra = (6 * ((r + MAX_TAPS) // 2 + 1) ** 2 if mode == LEG_PROLONG
             else 4 * (LEG_TILE + 2 * reach) ** 2 if down else 0)
    return (slots * r * r + extra) * itemsize


def _leg_threads(mode: int, K: int, reach: int) -> int:
    """One thread per pair of window columns (K1: per two pairs), in whole
    warps (leg_threads in legs3d.cu)."""
    r = LEG_TILE + 2 * leg_halo(mode, K, reach)
    threads = -(-r * (r // 2) // (2 if mode == LEG_RESTRICT else 1))
    return -(-threads // 32) * 32


def max_leg_k(dtype: torch.dtype, mode: int, reach: int = 1) -> int:
    """The deepest K that one K1-K3 launch of `mode` holds: at most
    MAX_LEG_K, its shared memory within one block's 227 KB and its threads
    within 1024 (K1: 768).  With the node restriction: 3 in float32 and
    bfloat16 (float32 rings); in float64 K2 and K3 2, K1 1."""
    itemsize = smem_itemsize(dtype)
    limit = 768 if mode == LEG_RESTRICT else 1024
    k = 0
    while (k < MAX_LEG_K and _leg_smem(mode, k + 1, reach, itemsize) <= SMEM_LIMIT
           and _leg_threads(mode, k + 1, reach) <= limit):
        k += 1
    return k


def leg_chunk(shape, n_sm: int) -> int:
    """Fine z-planes of one K1/K2 block on a level of `shape`: LEG_CHUNK,
    halved (down to 4) while the grid would give fewer than two blocks to
    each of the card's `n_sm` SMs; small levels trade the z-halo's
    recomputation for parallelism."""
    nz, ny, nx = (int(n) for n in shape)
    tiles = -(-ny // LEG_TILE) * -(-nx // LEG_TILE)
    chunk = LEG_CHUNK
    while chunk > 4 and -(-nz // chunk) * tiles < 2 * n_sm:
        chunk //= 2
    return chunk


def leg_chain(mode: int, K: int, dtype: torch.dtype, reach: int = 1):
    """The launches [(mode, k), ...] of one K1 (LEG_RESTRICT), K2
    (LEG_PROLONG) or K3 (LEG_SMOOTH) call of K iterations: one launch up to
    max_leg_k; a deeper K2 or K3 smooths the rest in LEG_SMOOTH launches
    after its first, a deeper K1 before its last.  K3 with K = 0: none."""
    kmax, ksmooth = max_leg_k(dtype, mode, reach), max_leg_k(dtype, LEG_SMOOTH)
    if kmax < 1:
        raise ValueError(f"restriction reach {reach} leaves no room for K1's window")
    if mode == LEG_SMOOTH and K < 1:
        return []
    k = min(K, kmax)
    rest = []
    for _ in range(-(-(K - k) // ksmooth)):
        rest.append((LEG_SMOOTH, min(ksmooth, K - k - ksmooth * len(rest))))
    return rest + [(mode, k)] if mode == LEG_RESTRICT else [(mode, k)] + rest


_NO_TAPS = ((0.0,),) * 3, (0, 0, 0)


def coarse_geometry(fine_shape, coarse_shape, r_lo, ghost=NO_GHOST):
    """K1's coarse geometry (legs3d.cu Coarse) for a restriction with
    window offsets `r_lo` on a fragment with `ghost` layers: (the taps'
    aligned lo per dim, the 12 ints off, n, lo, hi).  Aligned coarse node
    c is array node c + ceil(g/2) and takes fine 2c + lo + g%2 + k, so the
    node restriction's reach stays 1 for either parity of g.  On a
    halo-extended fragment only the aligned nodes with a fine tap inside
    the array are computed; the others are zero, as are the array nodes
    below ceil(g/2), whose taps reach at most the array's edge, where the
    residual is zero."""
    off = tuple((g + 1) // 2 for g in ghost)
    lo = tuple(int(r_lo[d]) - ghost[d] + 2 * off[d] for d in range(3))
    if tuple(ghost) == NO_GHOST:
        n = tuple(int(c) for c in coarse_shape)
    else:
        n = tuple(min(int(coarse_shape[d]) - off[d], (int(fine_shape[d]) - 1 - lo[d]) // 2 + 1)
                  for d in range(3))
    win = coarse_window(coarse_shape, ghost)
    return lo, (*off, *n, *(w[0] for w in win), *(w[1] for w in win))


def _leg_launches(sol, rhs, A, omega, K, mode, kernels, lo, excl, counted,
                  sol_c=None, coarse_shape=(1, 1, 1), chunk=None, ghost=NO_GHOST, faces=None):
    """The launches of leg_chain(mode, K) on CUDA tensors, each out of place
    into the other of (sol, a scratch tensor); the result ends in sol.
    `chunk`: the fine z-planes of a block (default leg_chunk); `ghost`: a
    halo-extended fragment's geometry (K1: coarse_geometry; K2: taps lo
    shifted by the ghost width); `faces`: K11/K12's face arrays, read in
    place of A's star (dense, no excl planes).  Returns K1's coarse rhs
    (None for K2, K3)."""
    lib, excl_c = _library(), _excl_array(excl)
    if faces is None:
        c0, coefs = star_array(A)
    nz, ny, nx = sol.shape
    nzc, nyc, nxc = sol_c.shape if sol_c is not None else coarse_shape
    geom = (0, 0, 0, nzc, nyc, nxc, 0, 0, 0, nzc - 1, nyc - 1, nxc - 1)
    if mode == LEG_RESTRICT:
        lo, geom = coarse_geometry(sol.shape, (nzc, nyc, nxc), lo, ghost)
    elif mode == LEG_PROLONG:
        lo = tuple(int(lo[d]) - ghost[d] for d in range(3))
    geom_c = (ctypes.c_int * 12)(*geom)
    reach = restrict_reach(kernels, lo) if mode == LEG_RESTRICT else 0
    cur, spare, out_c = sol, torch.empty_like(sol), None
    chunk = leg_chunk(sol.shape, sm_count(sol.device.index)) if chunk is None else chunk
    new_c = torch.empty if tuple(ghost) == NO_GHOST else torch.zeros
    for m, k in leg_chain(mode, K, sol.dtype, reach):
        taps, ntaps, tlo = _taps_arrays(*((kernels, lo) if m != LEG_SMOOTH else _NO_TAPS))
        if m == LEG_RESTRICT:
            out_c = new_c((nzc, nyc, nxc), dtype=sol.dtype, device=sol.device)
        ptrs = (spare.data_ptr(), (out_c if out_c is not None else spare).data_ptr(),
                cur.data_ptr(), (sol_c if sol_c is not None else cur).data_ptr(), rhs.data_ptr())
        if faces is None:
            err = lib.exa_leg(*ptrs, nz, ny, nx, nzc, nyc, nxc, coefs, omega / c0, k, reach, m,
                              chunk, taps, ntaps, tlo, excl_c, geom_c, DTYPE_CODES[sol.dtype],
                              current_stream())
        else:
            err = lib.exa_leg_faces(*ptrs, *(f.data_ptr() for f in faces), nz, ny, nx, nzc, nyc,
                                    nxc, omega, k, reach, m, chunk, taps, ntaps, tlo,
                                    DTYPE_CODES[sol.dtype], current_stream())
        check_error(lib, err, "leg_kernel")
        count_launch(counted)
        cur, spare = spare, cur
    if cur is not sol:
        sol.copy_(cur)
    return out_c


def smooth_res_restrict(sol, rhs, A: BoundStencil, omega: float, K: int,
                        r_kernels, r_lo, coarse_shape: Tuple[int, int, int],
                        excl=NO_EXCL, ghost=NO_GHOST):
    """K1, the whole down leg: K RBGS iterations on `sol` (in place), then
    the residual restricted to `coarse_shape`.  Returns (sol, coarse rhs).
    `r_kernels`/`r_lo` are the per-dim restriction taps and window offsets
    (ops/transfer.separable_kernels, IntergridStencil.lo).  On a
    halo-extended fragment (the sharded path) coarse node c takes the fine
    nodes 2c + lo - ghost[d] + k, and only the coarse nodes in its write
    window (coarse_window: every z-plane, the y/x rows outside the coarse
    ghost layers) are written, the others zero.  On CUDA
    one legs3d.cu launch for K up to max_leg_k (leg_chain beyond)."""
    if device_type(sol, rhs) == "cpu":
        new, rc = smooth_res_restrict_plain(sol, rhs, A, omega, K, r_kernels,
                                            r_lo, coarse_shape, excl, ghost)
        return sol.copy_(new), rc
    check_cuda_fields(sol, rhs)
    check_shapes(sol, rhs, coarse_shape)
    with torch.cuda.device(sol.device):
        out = _leg_launches(sol, rhs, A, omega, K, LEG_RESTRICT, r_kernels, r_lo, excl,
                            smooth_res_restrict, coarse_shape=tuple(int(n) for n in coarse_shape),
                            ghost=ghost)
    return sol, out


smooth_res_restrict.launches = 0


def prolong_correct_smooth(sol, sol_c, rhs, A: BoundStencil, omega: float,
                           K: int, p_kernels, p_lo, excl=NO_EXCL, ghost=NO_GHOST):
    """K2, the whole up leg: sol += P sol_c on inner nodes, then K RBGS
    iterations, all in place on `sol`.  Returns sol.  On a halo-extended
    fragment fine node j takes the coarse nodes (j - lo + ghost[d] - k)/2,
    ghost nodes corrected too.  On CUDA one legs3d.cu launch for K up to
    max_leg_k (leg_chain beyond)."""
    if device_type(sol, sol_c, rhs) == "cpu":
        return sol.copy_(prolong_correct_smooth_plain(
            sol, sol_c, rhs, A, omega, K, p_kernels, p_lo, excl, ghost))
    check_cuda_fields(sol, sol_c, rhs)
    check_shapes(sol, rhs)
    with torch.cuda.device(sol.device):
        _leg_launches(sol, rhs, A, omega, K, LEG_PROLONG, p_kernels, p_lo, excl,
                      prolong_correct_smooth, sol_c=sol_c, ghost=ghost)
    return sol


prolong_correct_smooth.launches = 0


def check_faces(sol, faces):
    """The face-array kernels' fields (K11/K12, and check3d.py's K13):
    float32 or float64, and three contiguous face arrays of sol's dtype,
    n_d + 1 long along axis d."""
    if sol.dtype not in FACE_DTYPES:
        raise ValueError(f"K11-K13 take float32 or float64, not {sol.dtype}")
    for d, f in enumerate(faces):
        want = tuple(n + (i == d) for i, n in enumerate(sol.shape))
        if f.dtype != sol.dtype or tuple(f.shape) != want or not f.is_contiguous():
            raise ValueError(f"face array {d}: need a contiguous {sol.dtype} array of shape {want}")


def smooth_res_restrict_faces(sol, rhs, A: BoundStencil, faces, omega: float, K: int,
                              r_kernels, r_lo, coarse_shape: Tuple[int, int, int]):
    """K11, K1 for a variable-coefficient star: K RBGS iterations on `sol`
    (in place), then the residual restricted to `coarse_shape`.  Returns
    (sol, coarse rhs).  `A` is the level's bound star and `faces` its face
    arrays (face_arrays(sol.shape, A)): on CUDA the
    kernels read the face arrays alone, one legs3d.cu leg_kernel launch
    (its face-array build) for K up to max_leg_k (leg_chain beyond), and
    their sweeps are bitwise the plain version's, which the CPU runs on A.
    Dense only; a restriction reach of at most 1 (node and cell
    restrictions)."""
    if device_type(sol, rhs, *faces) == "cpu":
        new, rc = smooth_res_restrict_plain(sol, rhs, A, omega, K, r_kernels, r_lo, coarse_shape)
        return sol.copy_(new), rc
    check_cuda_fields(sol, rhs)
    check_faces(sol, faces)
    check_shapes(sol, rhs, coarse_shape)
    if restrict_reach(r_kernels, r_lo) > 1:
        raise ValueError("K11 takes a restriction reach of at most 1")
    with torch.cuda.device(sol.device):
        out = _leg_launches(sol, rhs, A, omega, K, LEG_RESTRICT, r_kernels, r_lo, NO_EXCL,
                            smooth_res_restrict_faces,
                            coarse_shape=tuple(int(n) for n in coarse_shape), faces=faces)
    return sol, out


smooth_res_restrict_faces.launches = 0


def prolong_correct_smooth_faces(sol, sol_c, rhs, A: BoundStencil, faces, omega: float, K: int,
                                 p_kernels, p_lo):
    """K12, K2 for a variable-coefficient star: sol += P sol_c on inner
    nodes, then K RBGS iterations, all in place on `sol`.  Returns sol.
    `A` and `faces` as smooth_res_restrict_faces's; on CUDA one legs3d.cu
    leg_kernel launch (its face-array build) for K up to max_leg_k
    (leg_chain beyond)."""
    if device_type(sol, sol_c, rhs, *faces) == "cpu":
        return sol.copy_(prolong_correct_smooth_plain(sol, sol_c, rhs, A, omega, K, p_kernels,
                                                      p_lo))
    check_cuda_fields(sol, sol_c, rhs)
    check_faces(sol, faces)
    check_shapes(sol, rhs)
    with torch.cuda.device(sol.device):
        _leg_launches(sol, rhs, A, omega, K, LEG_PROLONG, p_kernels, p_lo, NO_EXCL,
                      prolong_correct_smooth_faces, sol_c=sol_c, faces=faces)
    return sol


prolong_correct_smooth_faces.launches = 0


def rbgs_fused(sol, rhs, A: BoundStencil, omega: float, K: int, excl=NO_EXCL, chunk=None):
    """K3, the fused smoother: K damped RBGS iterations (global parity,
    red first; the ring and excl planes never written) in place on `sol`.
    Returns sol.  One call takes any K (the TPU dispatcher cut K into
    chunks of at most 8 for its VMEM window); K = 0 changes nothing.  On
    CUDA one legs3d.cu LEG_SMOOTH launch for K up to max_leg_k (leg_chain
    beyond), out of place and copied back into `sol`; `chunk` is a block's
    fine z-planes (default leg_chunk).  On the CPU the plain version, in
    the launches' chunks of K."""
    if device_type(sol, rhs) == "cpu":
        for _, k in leg_chain(LEG_SMOOTH, K, sol.dtype):
            sol.copy_(rbgs_fused_plain(sol, rhs, A, omega, k, excl))
        return sol
    check_cuda_fields(sol, rhs)
    check_shapes(sol, rhs)
    with torch.cuda.device(sol.device):
        _leg_launches(sol, rhs, A, omega, K, LEG_SMOOTH, *_NO_TAPS, excl, rbgs_fused, chunk=chunk)
    return sol


rbgs_fused.launches = 0


def _inner_tiles(n: int, t: int) -> int:
    """Tiles of `t` covering the n - 2 inner nodes of a dim (K5)."""
    return -(-(n - 2) // t)


def _own_tiles(n: int, t: int) -> int:
    """Tiles of `t` covering all n nodes of a dim, the last taking a
    remainder of one node (K4; stream3d.cu own_tiles)."""
    return max(n - 2, 0) // t + 1


def transfer_blocks(mode: int, shape, coarse_shape, chunk: int) -> int:
    """The blocks of one K5 (LEG_PROLONG) or K4 (LEG_RESTRICT) launch at
    z-chunks of `chunk` fine planes: K5 tiles the inner fine nodes, K4 the
    coarse nodes (chunk / 2 coarse planes)."""
    if mode == LEG_PROLONG:
        nz, ny, nx = (int(n) for n in shape)
        return _inner_tiles(nz, chunk) * _inner_tiles(ny, UP_TILE[0]) * _inner_tiles(nx, UP_TILE[1])
    nzc, nyc, nxc = (int(n) for n in coarse_shape)
    return _own_tiles(nzc, chunk // 2) * _own_tiles(nyc, DOWN_TILE[0]) * _own_tiles(nxc, DOWN_TILE[1])


def transfer_chunk(mode: int, shape, coarse_shape, n_sm: int) -> int:
    """Fine z-planes of one K4/K5 block: TRANSFER_CHUNK, halved (down to 2)
    while the grid would give fewer than four blocks to each of the card's
    `n_sm` SMs."""
    chunk = TRANSFER_CHUNK
    while chunk > 2 and transfer_blocks(mode, shape, coarse_shape, chunk) < 4 * n_sm:
        chunk //= 2
    return chunk


def res_restrict(sol, rhs, A: BoundStencil, r_kernels, r_lo,
                 coarse_shape: Tuple[int, int, int], chunk=None):
    """K4, the down-leg tail: the residual rhs - A sol (zero on the
    boundary) restricted to `coarse_shape` in one pass.  Returns the
    coarse rhs; sol and rhs are read only.  On CUDA one stream3d.cu
    launch; `chunk` (even) is a block's fine z-planes (default
    transfer_chunk)."""
    if device_type(sol, rhs) == "cpu":
        return res_restrict_plain(sol, rhs, A, r_kernels, r_lo, coarse_shape)
    check_cuda_fields(sol, rhs)
    check_shapes(sol, rhs, coarse_shape)
    _check_plane(sol)
    lib = _library()
    with torch.cuda.device(sol.device):
        if chunk is None:
            chunk = transfer_chunk(LEG_RESTRICT, sol.shape, coarse_shape, sm_count(sol.device.index))
        _, coefs = star_array(A)
        taps, ntaps, lo = _taps_arrays(r_kernels, r_lo)
        nz, ny, nx = sol.shape
        nzc, nyc, nxc = (int(n) for n in coarse_shape)
        out = torch.empty((nzc, nyc, nxc), dtype=sol.dtype, device=sol.device)
        err = lib.exa_residual_restrict(
            sol.data_ptr(), rhs.data_ptr(), out.data_ptr(), nz, ny, nx, nzc, nyc, nxc, coefs, taps,
            ntaps, lo, chunk, DTYPE_CODES[sol.dtype], current_stream())
        check_error(lib, err, "residual_restrict")
        count_launch(res_restrict)
    return out


res_restrict.launches = 0


def prolong_correct(sol, sol_c, p_kernels, p_lo, chunk=None):
    """K5, the up-leg head: sol += P sol_c on inner nodes, in place, in
    one pass; the boundary is not written and bc is not reapplied (for
    Dirichlet the same as bc_sol(sol + P sol_c)).  Returns sol.  On CUDA
    one stream3d.cu launch; `chunk` is a block's fine z-planes (default
    transfer_chunk)."""
    if device_type(sol, sol_c) == "cpu":
        return sol.copy_(prolong_correct_plain(sol, sol_c, p_kernels, p_lo))
    check_cuda_fields(sol, sol_c)
    _check_plane(sol)
    lib = _library()
    with torch.cuda.device(sol.device):
        if chunk is None:
            chunk = transfer_chunk(LEG_PROLONG, sol.shape, sol_c.shape, sm_count(sol.device.index))
        taps, ntaps, lo = _taps_arrays(p_kernels, p_lo)
        nz, ny, nx = sol.shape
        nzc, nyc, nxc = sol_c.shape
        err = lib.exa_prolong_correct(sol.data_ptr(), sol_c.data_ptr(), nz, ny, nx, nzc, nyc, nxc,
                                      taps, ntaps, lo, chunk, DTYPE_CODES[sol.dtype],
                                      current_stream())
        check_error(lib, err, "prolong_correct")
        count_launch(prolong_correct)
    return sol


prolong_correct.launches = 0


# ----------------------------------------------------------------------
# K6-K8: the v1 schedule, one-pass kernels on thread-block clusters
# ----------------------------------------------------------------------


def _cluster_window(mode: int, K: int, reach: int, cluster) -> Tuple[int, int]:
    """(rows, row length) of the largest window of a K7/K8 block in a
    cluster of (cy, cx) blocks (cluster_legs3d.cu geom_for): the tile plus
    the halo (leg_halo; x rounded up to even) on the cluster's outer sides
    only."""
    cy, cx = cluster
    hy = leg_halo(mode, K, reach)
    hx = hy + hy % 2
    return (CLUSTER_TILE + hy * (2 if cy == 1 else 1),
            CLUSTER_TILE + hx * (2 if cx == 1 else 1))


def _cluster_smem(mode: int, K: int, reach: int, itemsize: int, cluster) -> int:
    """Dynamic shared memory of one K6-K8 block (cluster_smem): rings of
    2K+2+CLUSTER_AHEAD window planes (K7: one more) of sol and of rhs, then
    K8's 4 coarse boxes and 2 boxes of their z-sums, or K7's 4 boxes of
    z-sums (the tile plus `reach`); K6 nothing more."""
    rows, rx = _cluster_window(mode, K, reach, cluster)
    down = mode == LEG_RESTRICT
    slots = 2 * (2 * K + 2 + down + CLUSTER_AHEAD)
    extra = (4 * (CLUSTER_TILE + 2 * reach) ** 2 if down
             else 6 * ((max(rows, rx) + MAX_TAPS) // 2 + 1) ** 2 if mode == LEG_PROLONG
             else 0)
    return (slots * rows * rx + extra) * itemsize


def _cluster_threads(mode: int, K: int, reach: int, cluster) -> int:
    """One thread per pair of window columns, two where that would exceed
    CLUSTER_THREADS, in whole warps (cluster_threads)."""
    rows, rx = _cluster_window(mode, K, reach, cluster)
    pairs = rows * rx // 2
    threads = -(-pairs // (2 if pairs > CLUSTER_THREADS else 1))
    return -(-threads // 32) * 32


def max_cluster_k(dtype: torch.dtype, mode: int, reach: int = 1, cluster=None) -> int:
    """The deepest K that one K6 (LEG_SMOOTH), K7 (LEG_RESTRICT) or K8
    (LEG_PROLONG) launch on clusters of `cluster` blocks (default
    CLUSTER[mode]) holds: at most MAX_CLUSTER_K, its shared memory within
    one block's 227 KB.  With the node restriction, for every shape of
    CLUSTER_SHAPES: 3 in float32 and bfloat16 (float32 rings); in float64 K8
    2 and K7 1, K6 2 (on 2 x 2 and 4 x 2 clusters 3)."""
    cluster = CLUSTER[mode] if cluster is None else cluster
    itemsize = smem_itemsize(dtype)
    reach = reach if mode == LEG_RESTRICT else 0
    k = 0
    while k < MAX_CLUSTER_K and _cluster_smem(mode, k + 1, reach, itemsize, cluster) <= SMEM_LIMIT:
        k += 1
    return k


def max_wavefront_k(dtype: torch.dtype, cluster=None) -> int:
    """The deepest K that one K6 launch on clusters of `cluster` blocks
    (default CLUSTER[LEG_SMOOTH]) takes."""
    return max_cluster_k(dtype, LEG_SMOOTH, 0, cluster)


def restrict_reach(r_kernels, r_lo) -> int:
    """How far the y/x restriction taps reach outside the fine tile that a
    coarse tile covers (1 for the node restriction, 0 for the cell one)."""
    return max(max(0, -int(r_lo[d]), int(r_lo[d]) + len(r_kernels[d]) - 2) for d in (1, 2))


# K6-K8 compute what K3, K1 and K2 compute; so do their plain versions.
rbgs_wavefront_plain = rbgs_fused_plain
smooth_res_restrict_wavefront_plain = smooth_res_restrict_plain
prolong_correct_smooth_wavefront_plain = prolong_correct_smooth_plain


def _on_cuda(sol, rhs, *others) -> bool:
    """True for CUDA tensors that the kernels take (else raises), False
    for CPU tensors."""
    if device_type(sol, rhs, *others) == "cpu":
        return False
    check_cuda_fields(sol, rhs, *others)
    check_shapes(sol, rhs)
    return True


def rbgs_wavefront(sol, rhs, A: BoundStencil, omega: float, K: int, excl=NO_EXCL,
                   cluster=None):
    """K6 (TPU: exastencils_tpu/ops/pallas/stream3d.py:_rbgs_kernel): K
    damped RBGS iterations (global parity, red first; the ring and excl
    planes never written), one cluster_legs3d.cu LEG_SMOOTH launch on
    clusters of `cluster` (y, x) blocks (default CLUSTER[LEG_SMOOTH]) per
    chunk of at most max_wavefront_k iterations (the TPU dispatcher chunked
    by its VMEM window; on the CPU the plain version in the same chunks).
    Not in place: returns a new tensor and leaves `sol` as it was (K = 0
    returns `sol`)."""
    cuda = _on_cuda(sol, rhs)
    cluster = CLUSTER[LEG_SMOOTH] if cluster is None else cluster
    kmax = max_wavefront_k(sol.dtype, cluster)
    while K > 0:
        k = min(K, kmax)
        if cuda:
            sol, _ = _cluster_leg_launch(LEG_SMOOTH, sol, rhs, A, omega, k, *_NO_TAPS, cluster,
                                         excl=excl)
            count_launch(rbgs_wavefront)
        else:
            sol = rbgs_wavefront_plain(sol, rhs, A, omega, k, excl)
        K -= k
    return sol


rbgs_wavefront.launches = 0


def _cluster_leg_launch(mode, sol, rhs, A, omega, K, kernels, lo, cluster, sol_c=None,
                        coarse_shape=(1, 1, 1), excl=NO_EXCL):
    """One cluster_legs3d.cu launch on CUDA tensors, out of place: returns
    the new sol and K7's coarse rhs (None for K6, K8).  Only K6 takes excl
    planes."""
    lib, excl_c = _library(), _excl_array(excl)
    c0, coefs = star_array(A)
    taps, ntaps, tlo = _taps_arrays(kernels, lo)
    reach = restrict_reach(kernels, lo) if mode == LEG_RESTRICT else 0
    nz, ny, nx = sol.shape
    nzc, nyc, nxc = sol_c.shape if sol_c is not None else coarse_shape
    out = torch.empty_like(sol)
    out_c = (torch.empty((nzc, nyc, nxc), dtype=sol.dtype, device=sol.device)
             if mode == LEG_RESTRICT else None)
    with torch.cuda.device(sol.device):
        chunk = leg_chunk(sol.shape, sm_count(sol.device.index))
        err = lib.exa_cluster_leg(
            out.data_ptr(), (out_c if out_c is not None else out).data_ptr(), sol.data_ptr(),
            (sol_c if sol_c is not None else sol).data_ptr(), rhs.data_ptr(), nz, ny, nx,
            nzc, nyc, nxc, coefs, omega / c0, K, reach, mode, chunk, taps, ntaps, tlo, excl_c,
            int(cluster[0]), int(cluster[1]), DTYPE_CODES[sol.dtype], current_stream())
        check_error(lib, err, "cluster_leg")
    return out, out_c


def smooth_res_restrict_wavefront(sol, rhs, A: BoundStencil, omega: float, K: int,
                                  r_kernels, r_lo, coarse_shape: Tuple[int, int, int],
                                  cluster=None):
    """K7 (TPU: exastencils_tpu/ops/pallas/stream3d.py:_smooth_down_kernel),
    the whole down leg in one launch of cluster_legs3d.cu on clusters of
    `cluster` (y, x) blocks (default CLUSTER[LEG_RESTRICT]): K RBGS
    iterations, then the residual (zero on
    the boundary) restricted to `coarse_shape`.  No excl planes, as the
    TPU kernel.  A K deeper than max_cluster_k first runs the excess as K6.
    Not in place: returns (new sol, coarse rhs)."""
    cuda = _on_cuda(sol, rhs)
    reach = restrict_reach(r_kernels, r_lo)
    cluster = CLUSTER[LEG_RESTRICT] if cluster is None else cluster
    kmax = max_cluster_k(sol.dtype, LEG_RESTRICT, reach, cluster)
    if kmax < 1:
        raise ValueError(f"restriction reach {reach} leaves no room for K7's window")
    if K > kmax:
        sol = rbgs_wavefront(sol, rhs, A, omega, K - kmax)
        K = kmax
    if not cuda:
        return smooth_res_restrict_wavefront_plain(sol, rhs, A, omega, K, r_kernels, r_lo,
                                                   coarse_shape)
    check_shapes(sol, rhs, coarse_shape)
    out = _cluster_leg_launch(LEG_RESTRICT, sol, rhs, A, omega, K, r_kernels, r_lo, cluster,
                              coarse_shape=tuple(int(n) for n in coarse_shape))
    count_launch(smooth_res_restrict_wavefront)
    return out


smooth_res_restrict_wavefront.launches = 0


def prolong_correct_smooth_wavefront(sol, sol_c, rhs, A: BoundStencil, omega: float,
                                     K: int, p_kernels, p_lo, cluster=None):
    """K8 (TPU: exastencils_tpu/ops/pallas/stream3d.py:_up_smooth_kernel),
    the whole up leg in one launch of cluster_legs3d.cu on clusters of
    `cluster` (y, x) blocks (default CLUSTER[LEG_PROLONG]): sol + P sol_c
    on inner nodes (bc not
    reapplied), then K RBGS iterations.  No excl planes, as the TPU kernel.
    A K deeper than max_cluster_k runs the excess afterwards as K6.  Not in
    place: returns the new sol."""
    cuda = _on_cuda(sol, rhs, sol_c)
    cluster = CLUSTER[LEG_PROLONG] if cluster is None else cluster
    k = min(K, max_cluster_k(sol.dtype, LEG_PROLONG, 0, cluster))
    if cuda:
        sol, _ = _cluster_leg_launch(LEG_PROLONG, sol, rhs, A, omega, k, p_kernels, p_lo,
                                     cluster, sol_c=sol_c)
        count_launch(prolong_correct_smooth_wavefront)
    else:
        sol = prolong_correct_smooth_wavefront_plain(sol, sol_c, rhs, A, omega, k,
                                                     p_kernels, p_lo)
    if K > k:
        sol = rbgs_wavefront(sol, rhs, A, omega, K - k)
    return sol


prolong_correct_smooth_wavefront.launches = 0


# ----------------------------------------------------------------------
# schedule dispatchers (the JAX package's names and switch)
# ----------------------------------------------------------------------


def _pair_schedule() -> bool:
    """The v2 kernels K1-K3 are the default; EXA_STREAM_V1=1 selects the
    single-plane wavefronts K6-K8.  Read at every call, as the JAX
    package's `_pair_schedule` is."""
    return os.environ.get("EXA_STREAM_V1", "0") != "1"


def rbgs_fused_3d(sol, rhs, A: BoundStencil, omega: float, K: int, excl=NO_EXCL):
    """K RBGS iterations: K3 (in place) or, under EXA_STREAM_V1=1, K6 (a
    new tensor).  Callers use the returned sol."""
    if _pair_schedule():
        return rbgs_fused(sol, rhs, A, omega, K, excl)
    return rbgs_wavefront(sol, rhs, A, omega, K, excl)


def smooth_res_restrict_fused_3d(sol, rhs, A: BoundStencil, omega: float, K: int,
                                 r_kernels, r_lo, coarse_shape):
    """The down leg: K1 (sol in place) or, under EXA_STREAM_V1=1, K7 (a
    new sol).  Returns (sol, coarse rhs)."""
    if _pair_schedule():
        return smooth_res_restrict(sol, rhs, A, omega, K, r_kernels, r_lo, coarse_shape)
    return smooth_res_restrict_wavefront(sol, rhs, A, omega, K, r_kernels, r_lo, coarse_shape)


def prolong_correct_smooth_fused_3d(sol, sol_c, rhs, A: BoundStencil, omega: float,
                                    K: int, p_kernels, p_lo):
    """The up leg: K2 (in place) or, under EXA_STREAM_V1=1, K8 (a new
    tensor).  Callers use the returned sol."""
    if _pair_schedule():
        return prolong_correct_smooth(sol, sol_c, rhs, A, omega, K, p_kernels, p_lo)
    return prolong_correct_smooth_wavefront(sol, sol_c, rhs, A, omega, K, p_kernels, p_lo)
