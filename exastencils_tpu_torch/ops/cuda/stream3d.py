"""The 3D streaming kernels K1-K5: wrappers, plain PyTorch versions and
the CUDA library loader.

Reference: exastencils_tpu/ops/pallas/stream3d.py (`rbgs_fused_3d` :192,
`res_restrict_fused_3d` :365, `prolong_correct_fused_3d` :454,
`smooth_res_restrict_fused_3d` :603, `prolong_correct_smooth_fused_3d`
:746, `_star_coefs`, `pallas_applicable_3d`) and
exastencils_tpu/ops/pallas/stream3d_pair.py (the kernels behind them).

    K1 smooth_res_restrict     K RBGS iterations + residual + restriction
    K2 prolong_correct_smooth  prolongation + correction + K RBGS iterations
    K3 rbgs_fused              K RBGS iterations
    K4 res_restrict            residual + restriction
    K5 prolong_correct         prolongation + correction

The kernels are CUDA C++ for sm_90a in ../../csrc/stream3d.cu, compiled
with nvcc on first use into build/exastencils_tpu_torch/ at the repository
root and loaded with ctypes.  A wrapper given CUDA tensors launches the
kernels (or raises); given CPU tensors it runs the plain version; any
other device raises.  Each wrapper counts the kernel launches it makes in
its own `.launches`.  Wrappers that update `sol` do so in place and return
it, where the JAX version relied on the donated iterate.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

import torch

from exastencils_tpu_torch.core.stencil import BoundStencil
from exastencils_tpu_torch.ops.smoothers import color_mask, jacobi_update
from exastencils_tpu_torch.ops.stencil_apply import apply_stencil
from exastencils_tpu_torch.ops.transfer import (
    apply_separable,
    prolongation_matrix_1d,
    restriction_matrix_1d,
)

NO_EXCL = (-1,) * 6  # per-dim lo/hi planes excluded from updates; -1 = none
MAX_TAPS = 3  # transfer taps per dim the kernels take (kMaxTaps)

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "stream3d.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "exastencils_tpu_torch"
# --fmad=false: no mul+add contraction, so the RBGS and residual
# arithmetic rounds exactly as the plain PyTorch path does
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _star_coefs(offsets, coefs, ndim: int):
    """Validate a radius-1 star stencil; return (c0, [(c_lo, c_hi)] per dim)
    as Python floats, or None if not representable."""
    c0 = None
    per_dim = [[0.0, 0.0] for _ in range(ndim)]
    for off, c in zip(offsets, coefs):
        try:
            c = float(c)
        except (TypeError, ValueError, RuntimeError):
            return None  # tensor (variable) coefficient
        nz = [d for d in range(ndim) if off[d] != 0]
        if not nz:
            c0 = c
        elif len(nz) == 1 and abs(off[nz[0]]) == 1:
            d = nz[0]
            per_dim[d][0 if off[d] < 0 else 1] += c
        else:
            return None  # diagonal entry -> not a star stencil
    if c0 is None or c0 == 0.0:
        return None
    return c0, [tuple(p) for p in per_dim]


def cuda_applicable_3d(shape, offsets, coefs) -> bool:
    """The kernels' contract: 3D, at least 5 z-planes and 3 nodes in y/x,
    constant radius-1 star stencil.  (The TPU version also checked a VMEM
    budget, which has no counterpart here.)"""
    if len(shape) != 3:
        return False
    nz, ny, nx = shape
    if nz < 5 or ny < 3 or nx < 3:
        return False
    return _star_coefs(offsets, coefs, 3) is not None


# ----------------------------------------------------------------------
# library loader
# ----------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libstream3d_{tag.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library.  The
    compiler's output, including ptxas register counts, is kept beside the
    library as .log."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    pd, pi = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int)
    lib.exa_max_taps.argtypes, lib.exa_max_taps.restype = [], i
    lib.exa_error_string.argtypes, lib.exa_error_string.restype = [i], ctypes.c_char_p
    lib.exa_rbgs_half_sweep.argtypes = [p, p, i, i, i, pd, d, i, pi, i, p]
    lib.exa_residual_restrict.argtypes = [p, p, p, i, i, i, i, i, i, pd, pd, pi, pi, pi, i, p]
    lib.exa_prolong_correct.argtypes = [p, p, i, i, i, i, i, i, pd, pi, pi, pi, i, p]
    for fn in (lib.exa_rbgs_half_sweep, lib.exa_residual_restrict, lib.exa_prolong_correct):
        fn.restype = i
    if lib.exa_max_taps() != MAX_TAPS:
        raise RuntimeError(f"{so}: kMaxTaps {lib.exa_max_taps()} != {MAX_TAPS}")
    return lib


# ----------------------------------------------------------------------
# argument marshalling and launches
# ----------------------------------------------------------------------


def _device_type(*tensors) -> str:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev} (cpu or cuda)")
    return dev.type


def _check_cuda_fields(sol: torch.Tensor, *others: torch.Tensor):
    if sol.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"kernels take float32 or float64, not {sol.dtype}")
    for t in (sol, *others):
        if t.dtype != sol.dtype:
            raise ValueError(f"dtype mismatch: {t.dtype} vs {sol.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError("kernels take contiguous 3D tensors")
        if max(t.shape[:2]) > 65535:
            raise ValueError(f"shape {tuple(t.shape)}: z and y must be <= 65535 (grid dims)")


def _check_shapes(sol, rhs, coarse_shape=None):
    if tuple(rhs.shape) != tuple(sol.shape):
        raise ValueError("rhs must match sol")
    if coarse_shape is not None and len(coarse_shape) != 3:
        raise ValueError("coarse_shape must be 3D")


def _star_array(A: BoundStencil):
    cs = _star_coefs(A.offsets, A.coefs, 3)
    if cs is None:
        raise ValueError(f"{A.name}: not a constant radius-1 star stencil")
    c0, ((czm, czp), (cym, cyp), (cxm, cxp)) = cs
    return c0, (ctypes.c_double * 7)(c0, czm, czp, cym, cyp, cxm, cxp)


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


def _check(lib, err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.exa_error_string(err).decode()})")


def _is_double(t: torch.Tensor) -> int:
    return int(t.dtype == torch.float64)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _half_sweeps(lib, sol, rhs, A, omega, K, excl_c, counted):
    """2K rbgs_half_sweep launches, red first, in place on sol."""
    c0, coefs = _star_array(A)
    nz, ny, nx = sol.shape
    for _ in range(K):
        for color in (0, 1):
            err = lib.exa_rbgs_half_sweep(
                sol.data_ptr(), rhs.data_ptr(), nz, ny, nx, coefs, omega / c0,
                color, excl_c, _is_double(sol), _stream())
            _check(lib, err, "rbgs_half_sweep")
            counted.launches += 1


def _residual_restrict(lib, sol, rhs, A, r_kernels, r_lo, coarse_shape, excl_c):
    """One residual_restrict launch; returns the new coarse tensor."""
    _, coefs = _star_array(A)
    taps, ntaps, lo = _taps_arrays(r_kernels, r_lo)
    nz, ny, nx = sol.shape
    nzc, nyc, nxc = (int(n) for n in coarse_shape)
    out = torch.empty((nzc, nyc, nxc), dtype=sol.dtype, device=sol.device)
    err = lib.exa_residual_restrict(
        sol.data_ptr(), rhs.data_ptr(), out.data_ptr(), nz, ny, nx,
        nzc, nyc, nxc, coefs, taps, ntaps, lo, excl_c, _is_double(sol), _stream())
    _check(lib, err, "residual_restrict")
    return out


def _prolong_correct(lib, sol, sol_c, p_kernels, p_lo, excl_c):
    """One prolong_correct launch, in place on sol."""
    taps, ntaps, lo = _taps_arrays(p_kernels, p_lo)
    nz, ny, nx = sol.shape
    nzc, nyc, nxc = sol_c.shape
    err = lib.exa_prolong_correct(
        sol.data_ptr(), sol_c.data_ptr(), nz, ny, nx, nzc, nyc, nxc,
        taps, ntaps, lo, excl_c, _is_double(sol), _stream())
    _check(lib, err, "prolong_correct")


# ----------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the reference on the card)
# ----------------------------------------------------------------------


def _inner_mask(shape, excl, device) -> torch.Tensor:
    """Updatable nodes: not on the Dirichlet ring nor an excl plane."""
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    m[1:-1, 1:-1, 1:-1] = True
    for d in range(3):
        for p in excl[2 * d:2 * d + 2]:
            if p >= 0:
                m[tuple(p if i == d else slice(None) for i in range(3))] = False
    return m


def _rbgs_plain(sol, rhs, A, omega, K, inner):
    masks = [color_mask(sol.shape, c, sol.device) & inner for c in (0, 1)]
    for _ in range(K):
        for m in masks:
            sol = jacobi_update(sol, rhs, A, omega, m)
    return sol


def _res_restrict_plain(sol, rhs, A, r_kernels, r_lo, coarse_shape, inner):
    res = torch.where(inner, rhs - apply_stencil(A, sol), 0.0)
    mats = [restriction_matrix_1d(r_kernels[d], r_lo[d], coarse_shape[d],
                                  sol.shape[d], coarse_shape[d]) for d in range(3)]
    return apply_separable(mats, res)


def _prolong_correct_plain(sol, sol_c, p_kernels, p_lo, inner):
    mats = [prolongation_matrix_1d(p_kernels[d], p_lo[d], sol.shape[d],
                                   sol_c.shape[d], sol.shape[d]) for d in range(3)]
    return torch.where(inner, sol + apply_separable(mats, sol_c), sol)


def rbgs_fused_plain(sol, rhs, A: BoundStencil, omega: float, K: int, excl=NO_EXCL):
    """K RBGS iterations as masked-Jacobi half-sweeps, red first, on the
    inner non-excl nodes.  Out of place: returns the new sol."""
    return _rbgs_plain(sol, rhs, A, omega, K, _inner_mask(sol.shape, excl, sol.device))


def res_restrict_plain(sol, rhs, A: BoundStencil, r_kernels, r_lo, coarse_shape):
    """The residual masked to inner nodes, then the banded-matrix
    restriction.  Returns the coarse rhs."""
    inner = _inner_mask(sol.shape, NO_EXCL, sol.device)
    return _res_restrict_plain(sol, rhs, A, r_kernels, r_lo, coarse_shape, inner)


def prolong_correct_plain(sol, sol_c, p_kernels, p_lo):
    """sol + P sol_c on inner nodes (banded-matrix prolongation); the
    boundary keeps its values.  Out of place: returns the new sol."""
    inner = _inner_mask(sol.shape, NO_EXCL, sol.device)
    return _prolong_correct_plain(sol, sol_c, p_kernels, p_lo, inner)


def smooth_res_restrict_plain(sol, rhs, A: BoundStencil, omega: float, K: int,
                              r_kernels, r_lo, coarse_shape, excl=NO_EXCL):
    """K RBGS iterations, then the residual restricted.  Out of place:
    returns (smoothed sol, coarse rhs)."""
    inner = _inner_mask(sol.shape, excl, sol.device)
    sol = _rbgs_plain(sol, rhs, A, omega, K, inner)
    return sol, _res_restrict_plain(sol, rhs, A, r_kernels, r_lo, coarse_shape, inner)


def prolong_correct_smooth_plain(sol, sol_c, rhs, A: BoundStencil, omega: float,
                                 K: int, p_kernels, p_lo, excl=NO_EXCL):
    """sol + P sol_c on inner nodes, then K RBGS iterations.  Out of
    place: returns the new sol."""
    inner = _inner_mask(sol.shape, excl, sol.device)
    sol = _prolong_correct_plain(sol, sol_c, p_kernels, p_lo, inner)
    return _rbgs_plain(sol, rhs, A, omega, K, inner)


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------


def smooth_res_restrict(sol, rhs, A: BoundStencil, omega: float, K: int,
                        r_kernels, r_lo, coarse_shape: Tuple[int, int, int],
                        excl=NO_EXCL):
    """K1, the whole down leg: K RBGS iterations on `sol` (in place), then
    the residual restricted to `coarse_shape`.  Returns (sol, coarse rhs).
    `r_kernels`/`r_lo` are the per-dim restriction taps and window offsets
    (ops/transfer.separable_kernels, IntergridStencil.lo)."""
    if _device_type(sol, rhs) == "cpu":
        new, rc = smooth_res_restrict_plain(sol, rhs, A, omega, K, r_kernels,
                                            r_lo, coarse_shape, excl)
        return sol.copy_(new), rc
    _check_cuda_fields(sol, rhs)
    _check_shapes(sol, rhs, coarse_shape)
    lib, excl_c = load_library(), _excl_array(excl)
    with torch.cuda.device(sol.device):
        _half_sweeps(lib, sol, rhs, A, omega, K, excl_c, smooth_res_restrict)
        out = _residual_restrict(lib, sol, rhs, A, r_kernels, r_lo, coarse_shape, excl_c)
        smooth_res_restrict.launches += 1
    return sol, out


smooth_res_restrict.launches = 0


def prolong_correct_smooth(sol, sol_c, rhs, A: BoundStencil, omega: float,
                           K: int, p_kernels, p_lo, excl=NO_EXCL):
    """K2, the whole up leg: sol += P sol_c on inner nodes, then K RBGS
    iterations, all in place on `sol`.  Returns sol."""
    if _device_type(sol, sol_c, rhs) == "cpu":
        return sol.copy_(prolong_correct_smooth_plain(
            sol, sol_c, rhs, A, omega, K, p_kernels, p_lo, excl))
    _check_cuda_fields(sol, sol_c, rhs)
    _check_shapes(sol, rhs)
    lib, excl_c = load_library(), _excl_array(excl)
    with torch.cuda.device(sol.device):
        _prolong_correct(lib, sol, sol_c, p_kernels, p_lo, excl_c)
        prolong_correct_smooth.launches += 1
        _half_sweeps(lib, sol, rhs, A, omega, K, excl_c, prolong_correct_smooth)
    return sol


prolong_correct_smooth.launches = 0


def rbgs_fused(sol, rhs, A: BoundStencil, omega: float, K: int, excl=NO_EXCL):
    """K3, the fused smoother: K damped RBGS iterations (global parity,
    red first; the ring and excl planes never written) in place on `sol`.
    Returns sol.  One call takes any K (the TPU dispatcher cut K into
    chunks of at most 8 for its VMEM window); K = 0 changes nothing."""
    if _device_type(sol, rhs) == "cpu":
        return sol.copy_(rbgs_fused_plain(sol, rhs, A, omega, K, excl))
    _check_cuda_fields(sol, rhs)
    _check_shapes(sol, rhs)
    lib, excl_c = load_library(), _excl_array(excl)
    with torch.cuda.device(sol.device):
        _half_sweeps(lib, sol, rhs, A, omega, K, excl_c, rbgs_fused)
    return sol


rbgs_fused.launches = 0


def res_restrict(sol, rhs, A: BoundStencil, r_kernels, r_lo,
                 coarse_shape: Tuple[int, int, int]):
    """K4, the down-leg tail: the residual rhs - A sol (zero on the
    boundary) restricted to `coarse_shape` in one pass.  Returns the
    coarse rhs; sol and rhs are read only."""
    if _device_type(sol, rhs) == "cpu":
        return res_restrict_plain(sol, rhs, A, r_kernels, r_lo, coarse_shape)
    _check_cuda_fields(sol, rhs)
    _check_shapes(sol, rhs, coarse_shape)
    lib = load_library()
    with torch.cuda.device(sol.device):
        out = _residual_restrict(lib, sol, rhs, A, r_kernels, r_lo, coarse_shape,
                                 _excl_array(NO_EXCL))
        res_restrict.launches += 1
    return out


res_restrict.launches = 0


def prolong_correct(sol, sol_c, p_kernels, p_lo):
    """K5, the up-leg head: sol += P sol_c on inner nodes, in place, in
    one pass; the boundary is not written and bc is not reapplied (for
    Dirichlet the same as bc_sol(sol + P sol_c)).  Returns sol."""
    if _device_type(sol, sol_c) == "cpu":
        return sol.copy_(prolong_correct_plain(sol, sol_c, p_kernels, p_lo))
    _check_cuda_fields(sol, sol_c)
    lib = load_library()
    with torch.cuda.device(sol.device):
        _prolong_correct(lib, sol, sol_c, p_kernels, p_lo, _excl_array(NO_EXCL))
        prolong_correct.launches += 1
    return sol


prolong_correct.launches = 0
