"""The CUDA kernel library, and the helpers that more than one family of
kernel wrappers uses (stream3d.py: K1-K8, K11/K12; check3d.py: K9, K10, K13).

One library holds the CUDA C++ sources of ../../csrc/, compiled for sm_90a
with nvcc on first use into build/exastencils_tpu_torch/ at the repository
root and loaded with ctypes.  `load_library` builds, loads and declares
every entry point's C signature; each family checks its own layout
constants against the library before its first launch (its `_library`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from exastencils_tpu_torch.core.stencil import BoundStencil

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCES = (CSRC / "stream3d.cu", CSRC / "legs3d.cu", CSRC / "cluster_legs3d.cu",
           CSRC / "check3d.cu")
HEADERS = (CSRC / "star3d.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "exastencils_tpu_torch"
# --fmad=false: no mul+add contraction, so the RBGS and residual
# arithmetic rounds exactly as the plain PyTorch path does
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The field dtypes the kernels take, by their code in the C interface
# (csrc/star3d.cuh DType); bfloat16 under the rounding contract stated there
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
NO_EXCL = (-1,) * 6  # per-dim lo/hi planes excluded from updates; -1 = none


# ----------------------------------------------------------------------
# build and load
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
    """Where the build of the current sources and flags lives."""
    tag = hashlib.sha256()
    for f in (*SOURCES, *HEADERS):
        tag.update(f.read_bytes())
    tag.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libstream3d_{tag.hexdigest()[:16]}.so"


def _build(so: Path):
    """One nvcc per source, all started together, then one link.  The
    compilers' output, including ptxas register counts, is kept beside
    the library as .log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = so.with_name(f"{so.name}.{os.getpid()}")
    objs = [stem.with_name(f"{stem.name}.{src.stem}.o") for src in SOURCES]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    for src, proc, log in zip(SOURCES, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
    tmp = stem.with_name(f"{stem.name}.tmp")
    link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link {so.name}:\n{link.stdout}{link.stderr}")
    so.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, so)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library, every
    entry point's C signature declared."""
    so = library_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    pd, pi = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int)
    lib.exa_max_taps.argtypes, lib.exa_max_taps.restype = [], i
    lib.exa_leg_constant.argtypes, lib.exa_leg_constant.restype = [i], i
    lib.exa_leg_occupancy.argtypes, lib.exa_leg_occupancy.restype = [i, i, i, i], i
    lib.exa_leg_smem.argtypes, lib.exa_leg_smem.restype = [i, i, i, i], ctypes.c_longlong
    lib.exa_leg.argtypes = [p, p, p, p, p, i, i, i, i, i, i, pd, d, i, i, i, i, pd, pi, pi, pi, pi,
                            i, p]
    lib.exa_leg_faces_threads.argtypes, lib.exa_leg_faces_threads.restype = [i, i, i], i
    lib.exa_leg_faces.argtypes = [p] * 8 + [i] * 6 + [d, i, i, i, i, pd, pi, pi, i, p]
    lib.exa_error_string.argtypes, lib.exa_error_string.restype = [i], ctypes.c_char_p
    lib.exa_transfer_constant.argtypes, lib.exa_transfer_constant.restype = [i], i
    lib.exa_residual_restrict.argtypes = [p, p, p, i, i, i, i, i, i, pd, pd, pi, pi, i, i, p]
    lib.exa_prolong_correct.argtypes = [p, p, i, i, i, i, i, i, pd, pi, pi, i, i, p]
    lib.exa_cluster_constant.argtypes, lib.exa_cluster_constant.restype = [i], i
    lib.exa_cluster_smem.argtypes = [i, i, i, i, i, i]
    lib.exa_cluster_smem.restype = ctypes.c_longlong
    lib.exa_cluster_threads.argtypes, lib.exa_cluster_threads.restype = [i, i, i, i, i], i
    lib.exa_cluster_occupancy.argtypes, lib.exa_cluster_occupancy.restype = [i] * 7, i
    lib.exa_cluster_grid.argtypes, lib.exa_cluster_grid.restype = [i] * 10 + [pi], None
    lib.exa_cluster_leg.argtypes = [p, p, p, p, p, i, i, i, i, i, i, pd, d, i, i, i, i, pd, pi, pi,
                                    pi, i, i, i, p]
    lib.exa_check_constant.argtypes, lib.exa_check_constant.restype = [i], i
    lib.exa_residual.argtypes = [p, p, p, i, i, i, pd, i, i, i, p]
    lib.exa_sum_squares.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.exa_res_norm.argtypes = [p] * 7 + [i, i, i, pd, i, i, i, p]
    for fn in (lib.exa_residual_restrict, lib.exa_prolong_correct, lib.exa_leg,
               lib.exa_leg_faces, lib.exa_cluster_leg, lib.exa_residual, lib.exa_sum_squares,
               lib.exa_res_norm):
        fn.restype = i
    return lib


def check_error(lib, err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.exa_error_string(err).decode()})")


def current_stream():
    return torch.cuda.current_stream().cuda_stream


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ----------------------------------------------------------------------
# a wrapper's fields and stencil
# ----------------------------------------------------------------------


def device_type(*tensors) -> str:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev} (cpu or cuda)")
    return dev.type


def check_cuda_fields(sol: torch.Tensor, *others: torch.Tensor):
    if sol.dtype not in DTYPE_CODES:
        raise ValueError(f"kernels take float32, float64 or bfloat16, not {sol.dtype}")
    for t in (sol, *others):
        if t.dtype != sol.dtype:
            raise ValueError(f"dtype mismatch: {t.dtype} vs {sol.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError("kernels take contiguous 3D tensors")
        if max(t.shape[:2]) > 65535:
            raise ValueError(f"shape {tuple(t.shape)}: z and y must be <= 65535 (grid dims)")


def check_shapes(sol, rhs, coarse_shape=None):
    if tuple(rhs.shape) != tuple(sol.shape):
        raise ValueError("rhs must match sol")
    if coarse_shape is not None and len(coarse_shape) != 3:
        raise ValueError("coarse_shape must be 3D")


def star_coefs(offsets, coefs, ndim: int):
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


def star_array(A: BoundStencil):
    """(c0, the kernels' 7 star coefficients: centre, z-, z+, y-, y+, x-,
    x+) of a constant radius-1 star; raises for any other stencil."""
    cs = star_coefs(A.offsets, A.coefs, 3)
    if cs is None:
        raise ValueError(f"{A.name}: not a constant radius-1 star stencil")
    c0, ((czm, czp), (cym, cyp), (cxm, cxp)) = cs
    return c0, (ctypes.c_double * 7)(c0, czm, czp, cym, cyp, cxm, cxp)


# ----------------------------------------------------------------------
# the plain versions' masks and rounding
# ----------------------------------------------------------------------


def inner_mask(shape, excl, device) -> torch.Tensor:
    """Updatable nodes: not on the Dirichlet ring nor an excl plane."""
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    m[1:-1, 1:-1, 1:-1] = True
    for d in range(3):
        for p in excl[2 * d:2 * d + 2]:
            if p >= 0:
                m[tuple(p if i == d else slice(None) for i in range(3))] = False
    return m


# bfloat16 (csrc/star3d.cuh's contract): the plain versions upcast, run the
# float32 arithmetic and round where a kernel stores (each half-sweep's new
# values, each residual, each coarse value, each corrected fine value).


def compute(t: torch.Tensor) -> torch.Tensor:
    """A field in its compute type: float32 for bfloat16, else itself."""
    return t.float() if t.dtype == torch.bfloat16 else t


def stored(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A compute-type value rounded where a kernel stores it (to nearest
    even, kept in the compute type); a no-op unless `dtype` is bfloat16."""
    return t.to(dtype).float() if dtype == torch.bfloat16 else t
