"""ctypes bindings for the exa_native C++ runtime services.

Copied from exastencils_tpu/native/__init__.py so that the PyTorch port imports
nothing of the JAX package; imports point at exastencils_tpu_torch.

The shared library is built on first use with g++ into the git-ignored
build/exastencils_tpu_torch/ at the repository root, as the CUDA kernels
are (ops/cuda/stream3d.py), not next to the source; it is keyed by the
source's mtime.  Every entry point has a pure-Python
fallback mirror used when no compiler is available and by the
equivalence tests (tests/test_native.py).

Reference counterparts: the *generated* C++ runtime pieces listed in
native/exa_native.cpp's header comment.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "exa_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "exastencils_tpu_torch")
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _build() -> Optional[str]:
    so = os.path.join(_BUILD_DIR, "libexa_native.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(_SRC):
        return so
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}"  # concurrent builders each write their own
        subprocess.run(
            ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB is None and not _LIB_TRIED:
        _LIB_TRIED = True
        so = _build()
        if so:
            lib = ctypes.CDLL(so)
            lib.exa_check_results.restype = ctypes.c_int32
            lib.exa_check_results.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double]
            lib.exa_rank_fragments.restype = ctypes.c_int32
            _LIB = lib
    return _LIB


def _i32(vals: Sequence[int]):
    return (ctypes.c_int32 * len(vals))(*vals)


# ---------------------------------------------------------------- layout

def layout_bounds_1d(pad: int, ghost: int, dup_l: int, inner: int, dup_r: int,
                     force_py: bool = False) -> Tuple[int, ...]:
    """(PLB, GLB, DLB, IB, IE, DRE, GRE, PRE, total) — reference
    IR_FieldLayout.idxById segment bounds."""
    lib = None if force_py else get_lib()
    if lib is not None:
        out = (ctypes.c_int32 * 9)()
        lib.exa_layout_bounds_1d(pad, ghost, dup_l, inner, dup_r, out)
        return tuple(out)
    plb = 0
    glb = plb + pad
    dlb = glb + ghost
    ib = dlb + dup_l
    ie = ib + inner
    dre = ie + dup_r
    gre = dre + ghost
    pre = gre + pad
    return (plb, glb, dlb, ib, ie, dre, gre, pre, pre)


# ---------------------------------------------------------------- domain

def fragment_connectivity(frags_total: Sequence[int], fid: int,
                          force_py: bool = False):
    """(pos, neighbors[-x,+x,-y,+y,...], iterOffBegin, iterOffEnd) for a
    global fragment id (reference IR_ConnectFragments)."""
    nd = len(frags_total)
    lib = None if force_py else get_lib()
    if lib is not None:
        pos = (ctypes.c_int32 * nd)()
        nb = (ctypes.c_int32 * (2 * nd))()
        iob = (ctypes.c_int32 * nd)()
        ioe = (ctypes.c_int32 * nd)()
        lib.exa_fragment_connectivity(nd, _i32(frags_total), fid, pos, nb, iob, ioe)
        return tuple(pos), tuple(nb), tuple(iob), tuple(ioe)
    pos = []
    rem = fid
    for d in range(nd):
        pos.append(rem % frags_total[d])
        rem //= frags_total[d]
    nb, iob, ioe = [], [], []
    for d in range(nd):
        stride = 1
        for dd in range(d):
            stride *= frags_total[dd]
        nb.append(fid - stride if pos[d] > 0 else -1)
        nb.append(fid + stride if pos[d] < frags_total[d] - 1 else -1)
        iob.append(1 if pos[d] == 0 else 0)
        ioe.append(-1 if pos[d] == frags_total[d] - 1 else 0)
    return tuple(pos), tuple(nb), tuple(iob), tuple(ioe)


def rank_fragments(blocks: Sequence[int], frags_per_block: Sequence[int],
                   rank: int, force_py: bool = False) -> List[int]:
    """Global fragment ids owned by an MPI-rank-analog block
    (reference IR_InitGeneratedDomain.scala:40-48)."""
    nd = len(blocks)
    if not 1 <= nd <= 3:
        raise ValueError(f"rank_fragments supports 1-3 dims, got {nd}")
    lib = None if force_py else get_lib()
    count = 1
    for f in frags_per_block:
        count *= f
    if lib is not None:
        out = (ctypes.c_int32 * count)()
        n = lib.exa_rank_fragments(nd, _i32(blocks), _i32(frags_per_block),
                                   rank, out)
        if n < 0:
            raise ValueError(f"exa_rank_fragments rejected ndim={nd}")
        return list(out[:n])
    bpos = []
    rem = rank
    for d in range(nd):
        bpos.append(rem % blocks[d])
        rem //= blocks[d]
    frags_total = [blocks[d] * frags_per_block[d] for d in range(nd)]
    ids = []
    for i in range(count):
        lrem = i
        gpos = []
        for d in range(nd):
            lp = lrem % frags_per_block[d]
            lrem //= frags_per_block[d]
            gpos.append(bpos[d] * frags_per_block[d] + lp)
        gid = 0
        stride = 1
        for d in range(nd):
            gid += gpos[d] * stride
            stride *= frags_total[d]
        ids.append(gid)
    return ids


# ---------------------------------------------------------------- packing

def pack_interval(bounds: Sequence[Tuple[int, ...]], direction: Sequence[int],
                  kind: str, send: bool, force_py: bool = False):
    """Index box [begin, end) per dim for a ghost/dup exchange with the
    neighbor in `direction` (reference IR_PackInfo.scala:12-66)."""
    nd = len(direction)
    kind_i = 0 if kind == "ghost" else 1
    lib = None if force_py else get_lib()
    if lib is not None:
        flat = [v for b in bounds for v in b]
        beg = (ctypes.c_int32 * nd)()
        end = (ctypes.c_int32 * nd)()
        lib.exa_pack_interval(nd, _i32(flat), _i32(direction), kind_i,
                              1 if send else 0, beg, end)
        return tuple(beg), tuple(end)
    begin_out, end_out = [], []
    for d in range(nd):
        _, GLB, DLB, IB, IE, DRE, GRE, _, _ = bounds[d]
        ghost = DLB - GLB
        if direction[d] == 0:
            b, e = DLB, DRE
        elif kind == "ghost":
            if send:
                b, e = (DLB, DLB + ghost) if direction[d] < 0 else (DRE - ghost, DRE)
            else:
                b, e = (GLB, DLB) if direction[d] < 0 else (DRE, GRE)
        else:
            b, e = (DLB, IB) if direction[d] < 0 else (IE, DRE)
        begin_out.append(b)
        end_out.append(e)
    return tuple(begin_out), tuple(end_out)


# ---------------------------------------------------------------- testing

def check_results(got_path: str, expect_path: str, eps: float = 1e-6,
                  force_py: bool = False) -> int:
    """0 on match; first differing 1-based line otherwise
    (reference Testing/run_test.py:12-42)."""
    lib = None if force_py else get_lib()
    if lib is not None:
        return int(lib.exa_check_results(
            got_path.encode(), expect_path.encode(), eps))
    # trailing-whitespace-only strip, matching the C implementation
    # exactly (leading whitespace is significant in both)
    try:
        with open(got_path) as f:
            got = [l.rstrip() for l in f]
    except OSError:
        return -1
    try:
        with open(expect_path) as f:
            exp = [l.rstrip() for l in f]
    except OSError:
        return -2
    if len(got) != len(exp):
        return -3
    for i, (g, w) in enumerate(zip(got, exp)):
        if g == w:
            continue
        try:
            if abs(float(g) - float(w)) <= eps:
                continue
        except ValueError:
            pass
        return i + 1
    return 0
