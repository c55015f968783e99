#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (exastencils_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels K1-K8 from csrc/, holds each against its plain
PyTorch version on the card (K1/K2 also at odd shapes, excl planes and
K = 1..4, and bitwise against the K3/K4/K5 compositions they replace;
K3/K6 also at odd shapes and levels 7 and 9 with excl planes on tile,
cluster and z-chunk edges, K = 1..5; K7/K8 bitwise against K1/K2 at odd
shapes and K = 1..4), prints K7/K8's launch shape on the card, times
their cluster shapes (v1_launch_shape, cluster_variants), K6's cluster
shapes and K3's z-chunks (smoother_variants) and K3/K6 on every level
(smoother_level_times), holds K4/K5 against their plain versions at odd
shapes, 129^3 and 513^3 with node and cell taps (compare_transfers), times
their z-chunks (transfer_variants), their library yardsticks
(library_transfers: F.conv3d, F.interpolate), both beside their bound
(transfer_times) and on every level (transfer_level_times), drives five
Poisson3D V(3,3)-cycle paths at
513^3 float32 (the size `python bench.py` times), each with kernels and
plain, each cycle staged (captured as CUDA graphs and replayed, as
DenseBackend.wrap stages it) and held bit for bit to the eager cycle:
  main_path    RBGS, the whole-leg kernels K1/K2;
  jacobi_path  damped Jacobi, the fused transfers K4/K5;
  fas_path     RBGS under FAS, the fused smoother K3;
  v1_path      RBGS with EXA_STREAM_V1=1, the whole-leg cluster kernels K7/K8;
  v1_fas_path  RBGS under FAS with EXA_STREAM_V1=1, the cluster smoother K6;
solves small float64 problems (RBGS, Jacobi, FAS, RBGS V(0,2), and
RBGS and FAS under EXA_STREAM_V1=1) on the GPU and on the CPU, which must
print the same lines, solves main_path's problem to 1e-10 in float64
host-driven and device-resident (main_path_fused: solve_fused's one
recording must take the same cycles to the same residual and iterate),
and drives the DSL entry points on examples/poisson_3d_bench.exa4 (the
two DSL paths right after the build):
  dsl_path     the L4 executor at 513^3 float32, MGCycle@finest with the
               fast path (K1/K2 on levels 5-9) staged (the default: one
               recording of CUDA graphs, its kernels named in a profiler
               trace of a replay) and eager (dsl_path_eager, bit for bit the
               same U@finest), and without the fast path (dsl_path_plain);
  dsl_v1_path  the same with EXA_STREAM_V1=1 (K7/K8), staged and eager;
  loop_chunk   the staged cycle with 1, 4 and 16 device-loop iterations
               per host read;
  dsl_lines    maxLevel 6 float64 3D and the 2D example: GPU lines equal
               the CPU's;
  dsl_cli      `python -m exastencils_tpu_torch` in a subprocess on the GPU;
and compares the two schedules in one process (ab_schedule: K7/K1, K8/K2,
v1_path/main_path).  The `staging` line sums up the graphs, device loops,
capture seconds and graph-pool bytes of every staged path.  Every phase
prints one line; any failure raises and exits non-zero.  The third-to-last line
is the kernel table as JSON, then the card's name and power limit, the
last line `{"ok": true, "device": ...}`.  Exits non-zero without printing
a result when no CUDA device is present.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}  # max|got-ref| / max|ref|
# float32: the plain version restricts and prolongs with banded matmuls,
# which sum the taps in another order and with FMA (~1 ulp per tap);
# the RBGS and residual arithmetic itself is bitwise equal (--fmad=false).
MAIN_LEVEL = 9  # 513^3 nodes, bench.py's Poisson3D size
K_MAIN = 3  # V(3,3)
OMEGA = 0.8
# kernel -> (wrapper in ops/cuda/stream3d.py, the TPU kernel it replaces)
KERNELS = {
    "K1": ("smooth_res_restrict", "exastencils_tpu/ops/pallas/stream3d_pair.py:177"),
    "K2": ("prolong_correct_smooth", "exastencils_tpu/ops/pallas/stream3d_pair.py:328"),
    "K3": ("rbgs_fused", "exastencils_tpu/ops/pallas/stream3d_pair.py:94"),
    "K4": ("res_restrict", "exastencils_tpu/ops/pallas/stream3d.py:260"),
    "K5": ("prolong_correct", "exastencils_tpu/ops/pallas/stream3d.py:380"),
    "K6": ("rbgs_wavefront", "exastencils_tpu/ops/pallas/stream3d.py:84"),
    "K7": ("smooth_res_restrict_wavefront", "exastencils_tpu/ops/pallas/stream3d.py:475"),
    "K8": ("prolong_correct_smooth_wavefront", "exastencils_tpu/ops/pallas/stream3d.py:629"),
}
SOURCES = {kk: "exastencils_tpu_torch/csrc/" + ("legs3d.cu" if kk in ("K1", "K2", "K3") else
                                                "cluster_legs3d.cu" if kk in ("K6", "K7", "K8")
                                                else "stream3d.cu") for kk in KERNELS}
# Published H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM bytes/s, and
# FLOP/s outside the tensor cores (the kernels use none: TF32 would break
# the bitwise RBGS)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# per staged path: graphs, segments, device loops, capture seconds, pool bytes
STAGING = {}


def phase(tag, **fields):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() over `reps` runs, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def leg_inputs(level, dtype, seed):
    """Random fine/coarse fields on the card and the level's Laplacian."""
    from exastencils_tpu_torch import Knowledge
    from exastencils_tpu_torch.core.domain import unit_domain
    from exastencils_tpu_torch.core.grid import level_grids
    from exastencils_tpu_torch.models.poisson import laplace_stencil

    k = Knowledge(dimensionality=3, minLevel=level, maxLevel=level).update()
    grid = level_grids(unit_domain(3), k, "cuda", dtype=dtype)[level]
    n = 2 ** level + 1
    nc = 2 ** (level - 1) + 1
    rng = np.random.default_rng(seed)

    def field(m):
        return torch.as_tensor(rng.standard_normal((m, m, m)), device="cuda").to(dtype)

    return laplace_stencil(3).bind(grid), field(n), field(n), field(nc), (nc,) * 3


def rel_err(got, ref):
    d = (got - ref).abs().max().item()
    return d, d / max(ref.abs().max().item(), 1e-300)


def star_inputs(shape, cshape, dtype, seed):
    """Random fine/coarse fields of any shape on the card and a 7-point star
    with distinct coefficients, so a neighbour read from the wrong side
    shows."""
    from exastencils_tpu_torch.core.stencil import BoundStencil

    rng = np.random.default_rng(seed)
    offs = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))
    A = BoundStencil("A", offs, (6.5, -0.9, -1.1, -0.7, -1.3, -0.95, -1.05))
    sol, rhs, sol_c = (torch.as_tensor(rng.standard_normal(sh), device="cuda").to(dtype)
                       for sh in (shape, shape, cshape))
    return A, sol, rhs, sol_c, tuple(cshape)


def compare_legs(level, K, dtype, timed=False, shape=None, excl=None):
    """K1/K2 (legs3d.cu) against their plain versions and, without excl
    planes, against the compositions they replace (K1 = K3 then K4, K2 =
    K5 then K3) on the same inputs: one launch per call up to max_leg_k;
    K1's sol bitwise the plain version's; without excl planes K1's coarse
    rhs and K2 bitwise the compositions'.  `shape` = (fine, coarse) for an
    odd shape with a star of distinct coefficients, else the level's
    Laplacian."""
    from exastencils_tpu_torch.core.stencil import node_prolongation, node_restriction
    from exastencils_tpu_torch.ops.cuda import stream3d as s3
    from exastencils_tpu_torch.ops.transfer import separable_kernels

    seed = (level or 0) * 10 + K
    A, sol, rhs, sol_c, cshape = (leg_inputs(level, dtype, seed) if shape is None
                                  else star_inputs(*shape, dtype, seed))
    R, P = node_restriction(3), node_prolongation(3)
    rk, pk = separable_kernels(R), separable_kernels(P)
    omega = OMEGA
    excl = s3.NO_EXCL if excl is None else excl
    n0 = launch_counts()
    s_got, rc_got = s3.smooth_res_restrict(sol.clone(), rhs, A, omega, K, rk, R.lo, cshape, excl)
    u_got = s3.prolong_correct_smooth(sol.clone(), sol_c, rhs, A, omega, K, pk, P.lo, excl)
    torch.cuda.synchronize()
    n1 = launch_counts()
    launches = (n1["K1"] - n0["K1"], n1["K2"] - n0["K2"])
    want = tuple(len(s3.leg_chain(m, K, dtype, r))
                 for m, r in ((s3.LEG_RESTRICT, s3._restrict_reach(rk, R.lo)), (s3.LEG_PROLONG, 0)))
    s_ref, rc_ref = s3.smooth_res_restrict_plain(sol, rhs, A, omega, K, rk, R.lo, cshape, excl)
    u_ref = s3.prolong_correct_smooth_plain(sol, sol_c, rhs, A, omega, K, pk, P.lo, excl)
    e_s, e_rc, e_u = rel_err(s_got, s_ref), rel_err(rc_got, rc_ref), rel_err(u_got, u_ref)
    k1_abs, k1_rel = max(e_s[0], e_rc[0]), max(e_s[1], e_rc[1])
    tol = TOL[dtype]
    sol_bitwise = bool(torch.equal(s_got, s_ref))
    comp = {}
    if excl == s3.NO_EXCL:
        c_s = s3.rbgs_fused(sol.clone(), rhs, A, omega, K)
        c_rc = s3.res_restrict(c_s, rhs, A, rk, R.lo, cshape)
        c_u = s3.rbgs_fused(s3.prolong_correct(sol.clone(), sol_c, pk, P.lo), rhs, A, omega, K)
        comp = {"k1_coarse_bitwise": bool(torch.equal(rc_got, c_rc)),
                "k2_bitwise_vs_k5_k3": bool(torch.equal(u_got, c_u))}
    phase("compare", level=level, shape=tuple(sol.shape), K=K,
          dtype=str(dtype).split(".")[1], excl=excl, k1_rel=f"{k1_rel:.3e}",
          k2_rel=f"{e_u[1]:.3e}", tol=tol, k1_sol_bitwise=sol_bitwise, **comp, launches=launches)
    if not (sol_bitwise and k1_rel <= tol and e_u[1] <= tol and all(comp.values())):
        raise AssertionError(f"leg kernel mismatch at {tuple(sol.shape)} K {K} {dtype} excl {excl}")
    if launches != want:
        raise AssertionError(f"legs took {launches} launches, not {want}")
    out = {"K1": {"max_abs_err": k1_abs}, "K2": {"max_abs_err": e_u[0]}}
    if timed:
        s = sol.clone()
        out["K1"]["ms"] = cuda_ms(lambda: s3.smooth_res_restrict(s, rhs, A, omega, K, rk, R.lo, cshape), 5)
        out["K1"]["plain_ms"] = cuda_ms(lambda: s3.smooth_res_restrict_plain(s, rhs, A, omega, K, rk, R.lo, cshape), 3)
        out["K1"]["composition_ms"] = cuda_ms(lambda: s3.res_restrict(
            s3.rbgs_fused(s, rhs, A, omega, K), rhs, A, rk, R.lo, cshape), 5)
        out["K2"]["ms"] = cuda_ms(lambda: s3.prolong_correct_smooth(s, sol_c, rhs, A, omega, K, pk, P.lo), 5)
        out["K2"]["plain_ms"] = cuda_ms(lambda: s3.prolong_correct_smooth_plain(s, sol_c, rhs, A, omega, K, pk, P.lo), 3)
        out["K2"]["composition_ms"] = cuda_ms(lambda: s3.rbgs_fused(
            s3.prolong_correct(s, sol_c, pk, P.lo), rhs, A, omega, K), 5)
        phase("leg_times", level=level, K=K, **{f"{k}_{f}": f"{v[f]:.4f}" for k, v in out.items()
                                                 for f in ("ms", "plain_ms", "composition_ms")})
    return out


def leg_level_times(level, K):
    """K1/K2 (legs3d.cu) and the compositions they replace, float32, on one
    level's Laplacian: device ms of one call each."""
    from exastencils_tpu_torch.core.stencil import node_prolongation, node_restriction
    from exastencils_tpu_torch.ops.cuda import stream3d as s3
    from exastencils_tpu_torch.ops.transfer import separable_kernels

    A, sol, rhs, sol_c, cshape = leg_inputs(level, torch.float32, seed=level)
    R, P = node_restriction(3), node_prolongation(3)
    rk, pk = separable_kernels(R), separable_kernels(P)
    t = {"K1_ms": lambda: s3.smooth_res_restrict(sol, rhs, A, OMEGA, K, rk, R.lo, cshape),
         "K1_composition_ms": lambda: s3.res_restrict(s3.rbgs_fused(sol, rhs, A, OMEGA, K), rhs,
                                                      A, rk, R.lo, cshape),
         "K2_ms": lambda: s3.prolong_correct_smooth(sol, sol_c, rhs, A, OMEGA, K, pk, P.lo),
         "K2_composition_ms": lambda: s3.rbgs_fused(s3.prolong_correct(sol, sol_c, pk, P.lo),
                                                    rhs, A, OMEGA, K)}
    phase("leg_level_times", level=level, K=K, chunk=s3.leg_chunk(sol.shape, _sm_count()),
          **{k: f"{cuda_ms(fn, 10):.4f}" for k, fn in t.items()})


def _sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


def leg_launch_shape(level, K):
    """K1/K2's launch at one level in float32 and float64: per launch of
    its chain the grid's blocks, threads and shared memory of a block, and
    the blocks one SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    lib, n = s3.load_library(), 2 ** level + 1
    chunk, tiles = s3.leg_chunk((n,) * 3, _sm_count()), -(-n // s3.LEG_TILE)
    for kk, mode, reach in (("K1", s3.LEG_RESTRICT, 1), ("K2", s3.LEG_PROLONG, 0)):
        for dtype in (torch.float32, torch.float64):
            size, launches = torch.empty((), dtype=dtype).element_size(), []
            for m, k in s3.leg_chain(mode, K, dtype, reach):
                r = reach if m == s3.LEG_RESTRICT else 0
                launches.append({"mode": m, "K": k, "blocks": tiles * tiles * -(-n // chunk),
                                 "threads": s3._leg_threads(m, k, r),
                                 "smem": s3._leg_smem(m, k, r, size),
                                 "blocks_per_sm": lib.exa_leg_occupancy(m, k, r, int(size == 8))})
            phase("leg_launch_shape", kernel=kk, level=level, K=K,
                  dtype=str(dtype).split(".")[1], chunk=chunk, launches=launches)


# K1/K2 at odd shapes, the smallest level, excl planes (one at a z-chunk
# edge) and two z-chunks: (fine, coarse) shapes and excl planes
LEG_CASES = (
    (((5, 5, 5), (3, 3, 3)), None),
    (((17, 33, 9), (9, 17, 5)), None),
    (((17, 33, 9), (9, 17, 5)), (2, 14, -1, 20, 1, -1)),
    (((65, 65, 65), (33, 33, 33)), (31, 33, -1, 16, 15, -1)),
    (((139, 9, 17), (70, 5, 9)), None),
    (((139, 9, 17), (70, 5, 9)), (127, 129, -1, -1, 8, -1)),
)
# K3/K6: LEG_CASES and excl planes on both sides of tile edges (31 | 32, the
# inner edge of 1 x 2, 2 x 1 and 2 x 2 clusters; 63 | 64 an outer one) and
# of z-chunk edges (the wrapper's chunk: 4 planes at 65^3, 8 at 129^3, 128
# at 513^3), at levels 6, 7 and 9
SMOOTHER_CASES = LEG_CASES + (
    (((65, 65, 65), (33, 33, 33)), (3, 4, 31, 32, 32, 63)),
    (((129, 129, 129), (65, 65, 65)), (63, 64, 63, 96, 64, 127)),
    (((513, 513, 513), (257, 257, 257)), (127, 128, 31, 32, 63, 511)),
)

# K4/K5 at the odd shapes of LEG_CASES, a last tile of one more node
# (65, 129: 33 and 65 coarse nodes) and the main level, with node and cell
# transfers: fine shapes, and the float64 ones
TRANSFER_SHAPES = tuple(dict.fromkeys(shape for (shape, _), _ in LEG_CASES)) + (
    (66, 40, 37), (129, 129, 129), (513, 513, 513))
TRANSFER_F64 = TRANSFER_SHAPES[:-1]


def transfer_ops(cell):
    """(restriction, prolongation) of the node (3 taps, lo -1) or cell (2
    taps, lo 0) transfers, with their per-dim taps."""
    from exastencils_tpu_torch.core import stencil as st
    from exastencils_tpu_torch.ops.transfer import separable_kernels

    R, P = ((st.cell_restriction(3), st.cell_prolongation(3)) if cell
            else (st.node_restriction(3), st.node_prolongation(3)))
    return R, P, separable_kernels(R), separable_kernels(P)


def coarse_of(shape, cell):
    return tuple(m // 2 if cell else (m - 1) // 2 + 1 for m in shape)


def compare_transfers(shape, dtype, cell, seed):
    """K4 and K5 (stream3d.cu) on an odd shape with a star of distinct
    coefficients: within TOL of their plain versions, one launch per call;
    three runs bitwise alike (a race between blocks would show)."""
    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    cshape = coarse_of(shape, cell)
    A, sol, rhs, sol_c, _ = star_inputs(shape, cshape, dtype, seed)
    R, P, rk, pk = transfer_ops(cell)
    n0 = launch_counts()
    rc = s3.res_restrict(sol, rhs, A, rk, R.lo, cshape)
    u = s3.prolong_correct(sol.clone(), sol_c, pk, P.lo)
    torch.cuda.synchronize()
    n1 = launch_counts()
    launches = (n1["K4"] - n0["K4"], n1["K5"] - n0["K5"])
    e4 = rel_err(rc, s3.res_restrict_plain(sol, rhs, A, rk, R.lo, cshape))
    e5 = rel_err(u, s3.prolong_correct_plain(sol, sol_c, pk, P.lo))
    bitwise = all(torch.equal(s3.res_restrict(sol, rhs, A, rk, R.lo, cshape), rc) and
                  torch.equal(s3.prolong_correct(sol.clone(), sol_c, pk, P.lo), u) for _ in range(2))
    tol = TOL[dtype]
    phase("compare_transfers", shape=shape, coarse=cshape, taps="cell" if cell else "node",
          dtype=str(dtype).split(".")[1], k4_rel=f"{e4[1]:.3e}", k5_rel=f"{e5[1]:.3e}", tol=tol,
          runs_bitwise=bitwise, launches=launches)
    if not (e4[1] <= tol and e5[1] <= tol and bitwise):
        raise AssertionError(f"K4/K5 mismatch at {shape} {dtype} cell={cell}")
    if launches != (1, 1):
        raise AssertionError(f"K4/K5 took {launches} launches, not (1, 1)")


def library_transfers(level):
    """The library yardsticks of K4 and K5 (node transfers, float32, TF32
    off), which the port never calls: K4 as F.conv3d of the 7-point star
    (the residual on inner nodes) then F.conv3d with the outer product of
    [1/4, 1/2, 1/4] at stride 2; K5 as F.interpolate (trilinear,
    align_corners: fine node o is coarse o / 2) added to sol's inner nodes.
    Each within 1e-5 of the plain version.  Returns {kernel: ms}."""
    import torch.nn.functional as F

    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    A, sol, rhs, sol_c, cshape = leg_inputs(level, torch.float32, seed=level + 17)
    R, P, rk, pk = transfer_ops(False)
    c = s3._star_coefs(A.offsets, A.coefs, 3)
    star = torch.zeros((1, 1, 3, 3, 3), dtype=sol.dtype, device=sol.device)
    star[0, 0, 1, 1, 1] = c[0]
    for d, (lo_c, hi_c) in enumerate(c[1]):
        for k, v in ((0, lo_c), (2, hi_c)):
            idx = [1, 1, 1]
            idx[d] = k
            star[(0, 0, *idx)] = v
    w1 = torch.tensor(rk[0], dtype=sol.dtype, device=sol.device)
    w27 = (w1[:, None, None] * w1[None, :, None] * w1[None, None, :])[None, None]
    inner = (slice(1, -1),) * 3

    def k4():
        r = torch.zeros_like(sol)
        r[inner] = rhs[inner] - F.conv3d(sol[None, None], star)[0, 0]
        return F.conv3d(r[None, None], w27, stride=2, padding=1)[0, 0]

    def k5(s):
        s[inner] += F.interpolate(sol_c[None, None], size=tuple(s.shape), mode="trilinear",
                                  align_corners=True)[0, 0][inner]
        return s

    e4 = rel_err(k4(), s3.res_restrict_plain(sol, rhs, A, rk, R.lo, cshape))[1]
    e5 = rel_err(k5(sol.clone()), s3.prolong_correct_plain(sol, sol_c, pk, P.lo))[1]
    s = sol.clone()
    out = {"K4": cuda_ms(k4, 10), "K5": cuda_ms(lambda: k5(s), 10)}
    phase("library_transfers", level=level, k4_rel=f"{e4:.3e}", k5_rel=f"{e5:.3e}", tol=1e-5,
          K4_library_ms=f"{out['K4']:.4f}", K5_library_ms=f"{out['K5']:.4f}")
    if not (e4 <= 1e-5 and e5 <= 1e-5):
        raise AssertionError("a library yardstick of K4/K5 computes another function")
    return out


def transfer_variants(level):
    """K4 and K5 at one level, float32, in one process: the kernels at
    several z-chunks, each bitwise the default launch; device ms of one
    call.  Returns {kernel: {variant: ms}}."""
    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    A, sol, rhs, sol_c, cshape = leg_inputs(level, torch.float32, seed=level + 19)
    R, P, rk, pk = transfer_ops(False)
    rc = s3.res_restrict(sol, rhs, A, rk, R.lo, cshape)
    u = s3.prolong_correct(sol.clone(), sol_c, pk, P.lo)
    out = {"K4": {}, "K5": {}}
    s = sol.clone()

    def check(kk, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{kk} variant differs from the default launch at level {level}")

    for chunk in (8, 16, 32, 64):
        check("K4", s3.res_restrict(sol, rhs, A, rk, R.lo, cshape, chunk=chunk), rc)
        check("K5", s3.prolong_correct(sol.clone(), sol_c, pk, P.lo, chunk=chunk), u)
        out["K4"][f"chunk{chunk}"] = cuda_ms(lambda: s3.res_restrict(sol, rhs, A, rk, R.lo, cshape,
                                                                   chunk=chunk), 10)
        out["K5"][f"chunk{chunk}"] = cuda_ms(lambda: s3.prolong_correct(s, sol_c, pk, P.lo,
                                                                      chunk=chunk), 10)
    for kk in ("K4", "K5"):
        phase("transfer_variants", kernel=kk, level=level, dtype="float32",
              default_chunk=s3.transfer_chunk(s3.LEG_RESTRICT if kk == "K4" else s3.LEG_PROLONG,
                                              sol.shape, cshape, _sm_count()),
              bitwise=True, **{f"ms_{v}": f"{ms:.4f}" for v, ms in out[kk].items()})
    return out


def transfer_level_times(level):
    """K4 and K5 (default z-chunk), float32, on one level's Laplacian:
    device ms of one call each beside the bound (the Jacobi path calls them
    on every level 2..9)."""
    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    A, sol, rhs, sol_c, cshape = leg_inputs(level, torch.float32, seed=level + 23)
    R, P, rk, pk = transfer_ops(False)
    s, n = sol.clone(), 2 ** level + 1
    k4 = cuda_ms(lambda: s3.res_restrict(sol, rhs, A, rk, R.lo, cshape), 10)
    k5 = cuda_ms(lambda: s3.prolong_correct(s, sol_c, pk, P.lo), 10)
    b = bound("K4", n, cshape[0], K_MAIN, torch.float32)[0]
    phase("transfer_level_times", level=level,
          chunk_k4=s3.transfer_chunk(s3.LEG_RESTRICT, sol.shape, cshape, _sm_count()),
          chunk_k5=s3.transfer_chunk(s3.LEG_PROLONG, sol.shape, cshape, _sm_count()),
          K4_ms=f"{k4:.4f}", K5_ms=f"{k5:.4f}", bound_ms=f"{b:.5f}",
          K4_share=f"{b / k4:.3f}", K5_share=f"{b / k5:.3f}")


def bound(kk, n, nc, K, dtype):
    """(bound_ms, bound_by) of kernel kk on a 3D grid of n^3 fine and nc^3
    coarse nodes: the larger of the bytes it must move (each input read
    once, each output written once) over PEAK_BYTES_S and its floating
    point operations over PEAK_FLOPS.  Operations per inner node: 16 per
    RBGS update (7 mul, 6 add, sub, mul, add), 14 per residual, 2 per
    prolongation tap (27/8 taps per fine node on average); 2 per
    restriction tap, 27 per coarse node."""
    size = torch.empty((), dtype=dtype).element_size()
    N, Nc, inner = n ** 3, nc ** 3, (n - 2) ** 3
    leg, smooth, restrict, prolong = 3 * N + Nc, 3 * N, 2 * N + Nc, 2 * N + Nc
    values, ops = {
        "K1": (leg, (16 * K + 14) * inner + 54 * Nc),
        "K2": (leg, (16 * K + 6.75) * inner),
        "K3": (smooth, 16 * K * inner),
        "K4": (restrict, 14 * inner + 54 * Nc),
        "K5": (prolong, 6.75 * inner),
    }[{"K6": "K3", "K7": "K1", "K8": "K2"}.get(kk, kk)]
    t_bytes, t_ops = values * size / PEAK_BYTES_S * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k6_launches(K, dtype, cluster=None):
    """cluster_legs3d.cu launches of one K6 call of K iterations."""
    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    return -(-K // s3.max_wavefront_k(dtype, cluster))


def compare_fused(level, K, dtype, excl=None, timed=False, shape=None, transfers=True):
    """K3, K4 and K5 against their plain versions on the same inputs; K3
    bitwise (--fmad=false), one launch per max_leg_k iterations.  `shape`
    = (fine, coarse) for an odd shape with a star of distinct
    coefficients, else the level's Laplacian.  `transfers=False`: K3 only
    (K4/K5 do not depend on K; compare_transfers covers those shapes)."""
    from exastencils_tpu_torch.core.stencil import node_prolongation, node_restriction
    from exastencils_tpu_torch.ops.cuda import stream3d as s3
    from exastencils_tpu_torch.ops.transfer import separable_kernels

    seed = (level or 0) * 10 + K + 1
    A, sol, rhs, sol_c, cshape = (leg_inputs(level, dtype, seed) if shape is None
                                  else star_inputs(*shape, dtype, seed))
    R, P = node_restriction(3), node_prolongation(3)
    rk, pk = separable_kernels(R), separable_kernels(P)
    excl = s3.NO_EXCL if excl is None else excl
    s_ref = s3.rbgs_fused_plain(sol, rhs, A, OMEGA, K, excl)
    n0 = launch_counts()
    s_got = s3.rbgs_fused(sol.clone(), rhs, A, OMEGA, K, excl)
    torch.cuda.synchronize()
    launches = launch_counts()["K3"] - n0["K3"]
    errs = {"K3": rel_err(s_got, s_ref)}
    if transfers:
        rc_got = s3.res_restrict(sol, rhs, A, rk, R.lo, cshape)
        u_got = s3.prolong_correct(sol.clone(), sol_c, pk, P.lo)
        errs["K4"] = rel_err(rc_got, s3.res_restrict_plain(sol, rhs, A, rk, R.lo, cshape))
        errs["K5"] = rel_err(u_got, s3.prolong_correct_plain(sol, sol_c, pk, P.lo))
    tol = TOL[dtype]
    bitwise = bool(torch.equal(s_got, s_ref))
    want = len(s3.leg_chain(s3.LEG_SMOOTH, K, dtype))
    phase("compare_fused", level=level, shape=tuple(sol.shape), K=K,
          dtype=str(dtype).split(".")[1], excl=excl,
          **{f"{kk.lower()}_rel": f"{e[1]:.3e}" for kk, e in errs.items()}, tol=tol,
          k3_bitwise=bitwise, k3_launches=launches)
    if not (bitwise and all(e[1] <= tol for e in errs.values())):
        raise AssertionError(f"kernel/plain mismatch at {tuple(sol.shape)} K {K} {dtype} excl {excl}")
    if launches != want:
        raise AssertionError(f"K3 took {launches} launches, not {want}")
    out = {kk: {"max_abs_err": e[0]} for kk, e in errs.items()}
    if timed:
        s = sol.clone()
        out["K3"]["ms"] = cuda_ms(lambda: s3.rbgs_fused(s, rhs, A, OMEGA, K), 10)
        out["K3"]["plain_ms"] = cuda_ms(lambda: s3.rbgs_fused_plain(s, rhs, A, OMEGA, K), 3)
        out["K4"]["ms"] = cuda_ms(lambda: s3.res_restrict(s, rhs, A, rk, R.lo, cshape), 10)
        out["K4"]["plain_ms"] = cuda_ms(lambda: s3.res_restrict_plain(s, rhs, A, rk, R.lo, cshape), 5)
        out["K5"]["ms"] = cuda_ms(lambda: s3.prolong_correct(s, sol_c, pk, P.lo), 10)
        out["K5"]["plain_ms"] = cuda_ms(lambda: s3.prolong_correct_plain(s, sol_c, pk, P.lo), 5)
        phase("fused_times", level=level, K=K, **{f"{k}_{f}": f"{v[f]:.4f}" for k, v in out.items()
                                                   for f in ("ms", "plain_ms")})
    return out


def compare_wavefronts(level, K, dtype, excl=None, timed=False, shape=None):
    """K6, K7 and K8 against their plain versions on the same inputs: K7/K8
    one launch each, K6 one per max_wavefront_k iterations (and K6 launches
    for the iterations K7 or K8 does not hold); K6 and K7's sol bitwise
    (--fmad=false); with excl planes K6 also bitwise on every cluster shape
    (not counted).  `shape` as compare_fused's."""
    from exastencils_tpu_torch.core.stencil import node_prolongation, node_restriction
    from exastencils_tpu_torch.ops.cuda import stream3d as s3
    from exastencils_tpu_torch.ops.transfer import separable_kernels

    seed = (level or 0) * 10 + K + 2
    A, sol, rhs, sol_c, cshape = (leg_inputs(level, dtype, seed) if shape is None
                                  else star_inputs(*shape, dtype, seed))
    R, P = node_restriction(3), node_prolongation(3)
    rk, pk = separable_kernels(R), separable_kernels(P)
    excl = s3.NO_EXCL if excl is None else excl
    n0 = launch_counts()
    s6 = s3.rbgs_wavefront(sol, rhs, A, OMEGA, K, excl)
    s7, rc7 = s3.smooth_res_restrict_wavefront(sol, rhs, A, OMEGA, K, rk, R.lo, cshape)
    s8 = s3.prolong_correct_smooth_wavefront(sol, sol_c, rhs, A, OMEGA, K, pk, P.lo)
    torch.cuda.synchronize()
    n1 = launch_counts()
    launches = {kk: n1[kk] - n0[kk] for kk in ("K6", "K7", "K8")}
    r6 = s3.rbgs_wavefront_plain(sol, rhs, A, OMEGA, K, excl)
    r7, rrc7 = s3.smooth_res_restrict_wavefront_plain(sol, rhs, A, OMEGA, K, rk, R.lo, cshape)
    r8 = s3.prolong_correct_smooth_wavefront_plain(sol, sol_c, rhs, A, OMEGA, K, pk, P.lo)
    errs = {"K6": rel_err(s6, r6), "K7": max(rel_err(s7, r7), rel_err(rc7, rrc7)),
            "K8": rel_err(s8, r8)}
    tol = TOL[dtype]
    bitwise = bool(torch.equal(s6, r6) and torch.equal(s7, r7))
    shapes_bitwise = True
    if excl != s3.NO_EXCL:
        shapes_bitwise = all(torch.equal(s3.rbgs_wavefront(sol, rhs, A, OMEGA, K, excl, cluster=c), r6)
                             for c in s3.CLUSTER_SHAPES)
    phase("compare_wavefronts", level=level, shape=tuple(sol.shape), K=K,
          dtype=str(dtype).split(".")[1], excl=excl,
          **{f"{kk.lower()}_rel": f"{e[1]:.3e}" for kk, e in errs.items()}, tol=tol,
          k6_k7_sol_bitwise=bitwise, k6_every_cluster_bitwise=shapes_bitwise, launches=launches)
    if not (bitwise and shapes_bitwise and errs["K7"][1] <= tol and errs["K8"][1] <= tol):
        raise AssertionError(f"wavefront/plain mismatch at {tuple(sol.shape)} K {K} {dtype} excl {excl}")
    excess = sum(k6_launches(max(K - s3.max_cluster_k(dtype, m), 0), dtype)
                 for m in (s3.LEG_RESTRICT, s3.LEG_PROLONG))
    want = {"K6": k6_launches(K, dtype) + excess, "K7": 1, "K8": 1}
    if launches != want:
        raise AssertionError(f"wavefronts took {launches} launches, not {want}")
    out = {kk: {"max_abs_err": e[0]} for kk, e in errs.items()}
    if timed:
        out["K6"]["ms"] = cuda_ms(lambda: s3.rbgs_wavefront(sol, rhs, A, OMEGA, K), 10)
        out["K6"]["plain_ms"] = cuda_ms(lambda: s3.rbgs_wavefront_plain(sol, rhs, A, OMEGA, K), 3)
        out["K7"]["ms"] = cuda_ms(lambda: s3.smooth_res_restrict_wavefront(
            sol, rhs, A, OMEGA, K, rk, R.lo, cshape), 5)
        out["K7"]["plain_ms"] = cuda_ms(lambda: s3.smooth_res_restrict_wavefront_plain(
            sol, rhs, A, OMEGA, K, rk, R.lo, cshape), 3)
        out["K8"]["ms"] = cuda_ms(lambda: s3.prolong_correct_smooth_wavefront(
            sol, sol_c, rhs, A, OMEGA, K, pk, P.lo), 5)
        out["K8"]["plain_ms"] = cuda_ms(lambda: s3.prolong_correct_smooth_wavefront_plain(
            sol, sol_c, rhs, A, OMEGA, K, pk, P.lo), 3)
        phase("wavefront_times", level=level, K=K, **{f"{k}_{f}": f"{v[f]:.4f}" for k, v in out.items()
                                                      for f in ("ms", "plain_ms")})
    return out


def smoother_variants(level, K):
    """K6 on every cluster shape and K3 at several z-chunks, float32, on one
    level's Laplacian in one process: each bitwise the plain version,
    device ms of one call.  K3's copy-back (a copy of sol's size) is timed
    apart."""
    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    A, sol, rhs, _, _ = leg_inputs(level, torch.float32, seed=level + 11)
    ref = s3.rbgs_fused_plain(sol, rhs, A, OMEGA, K)
    k6 = {}
    for cluster in s3.CLUSTER_SHAPES:
        if not torch.equal(s3.rbgs_wavefront(sol, rhs, A, OMEGA, K, cluster=cluster), ref):
            raise AssertionError(f"K6 on {cluster} clusters differs from the plain version")
        k6[cluster] = cuda_ms(lambda: s3.rbgs_wavefront(sol, rhs, A, OMEGA, K, cluster=cluster), 10)
    k3, s, spare = {}, sol.clone(), torch.empty_like(sol)
    default_chunk = s3.leg_chunk(sol.shape, _sm_count())
    for chunk in sorted({32, 64, 128, 256, default_chunk}):
        if not torch.equal(s3.rbgs_fused(sol.clone(), rhs, A, OMEGA, K, chunk=chunk), ref):
            raise AssertionError(f"K3 at z-chunk {chunk} differs from the plain version")
        k3[chunk] = cuda_ms(lambda: s3.rbgs_fused(s, rhs, A, OMEGA, K, chunk=chunk), 10)
    copy_ms = cuda_ms(lambda: spare.copy_(s), 10)
    phase("smoother_variants", kernel="K6", level=level, K=K, dtype="float32",
          default=s3.CLUSTER[s3.LEG_SMOOTH], bitwise=True,
          **{f"ms_{cy}x{cx}": f"{ms:.4f}" for (cy, cx), ms in k6.items()})
    phase("smoother_variants", kernel="K3", level=level, K=K, dtype="float32",
          default_chunk=default_chunk, bitwise=True,
          **{f"ms_chunk{c}": f"{ms:.4f}" for c, ms in k3.items()}, copy_back_ms=f"{copy_ms:.4f}",
          kernel_ms_default_chunk=f"{k3[default_chunk] - copy_ms:.4f}")
    return k6, k3, copy_ms


def smoother_level_times(level, K):
    """K3 and K6 (default z-chunk and cluster), float32, on one level's
    Laplacian: device ms of one call each (the FAS paths call them on
    every level 2..9)."""
    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    A, sol, rhs, _, _ = leg_inputs(level, torch.float32, seed=level + 13)
    s = sol.clone()
    phase("smoother_level_times", level=level, K=K, chunk=s3.leg_chunk(sol.shape, _sm_count()),
          K3_ms=f"{cuda_ms(lambda: s3.rbgs_fused(s, rhs, A, OMEGA, K), 10):.4f}",
          K6_ms=f"{cuda_ms(lambda: s3.rbgs_wavefront(sol, rhs, A, OMEGA, K), 10):.4f}")


def compare_v1_legs(level, K, dtype, shape=None):
    """K7/K8 (cluster_legs3d.cu, default clusters) against K1/K2 (legs3d.cu)
    on the same inputs: K7's sol and coarse rhs and K8 bitwise; one K7/K8
    launch per call, K6 launches for the iterations one launch does not
    hold; the inputs left as they were.  `shape` = (fine, coarse) for an
    odd shape with a star of distinct coefficients, else the level's
    Laplacian."""
    from exastencils_tpu_torch.core.stencil import node_prolongation, node_restriction
    from exastencils_tpu_torch.ops.cuda import stream3d as s3
    from exastencils_tpu_torch.ops.transfer import separable_kernels

    seed = (level or 0) * 10 + K + 3
    A, sol, rhs, sol_c, cshape = (leg_inputs(level, dtype, seed) if shape is None
                                  else star_inputs(*shape, dtype, seed))
    R, P = node_restriction(3), node_prolongation(3)
    rk, pk = separable_kernels(R), separable_kernels(P)
    before = sol.clone()
    n0 = launch_counts()
    s7, c7 = s3.smooth_res_restrict_wavefront(sol, rhs, A, OMEGA, K, rk, R.lo, cshape)
    s8 = s3.prolong_correct_smooth_wavefront(sol, sol_c, rhs, A, OMEGA, K, pk, P.lo)
    torch.cuda.synchronize()
    n1 = launch_counts()
    launches = {kk: n1[kk] - n0[kk] for kk in ("K6", "K7", "K8")}
    want = {"K6": sum(k6_launches(max(K - s3.max_cluster_k(dtype, m), 0), dtype)
                      for m in (s3.LEG_RESTRICT, s3.LEG_PROLONG)), "K7": 1, "K8": 1}
    s1, c1 = s3.smooth_res_restrict(sol.clone(), rhs, A, OMEGA, K, rk, R.lo, cshape)
    s2 = s3.prolong_correct_smooth(sol.clone(), sol_c, rhs, A, OMEGA, K, pk, P.lo)
    bitwise = {"k7_sol": bool(torch.equal(s7, s1)), "k7_coarse": bool(torch.equal(c7, c1)),
               "k8": bool(torch.equal(s8, s2)), "input_kept": bool(torch.equal(sol, before))}
    phase("compare_v1_legs", level=level, shape=tuple(sol.shape), K=K,
          dtype=str(dtype).split(".")[1], **bitwise, launches=launches)
    if not all(bitwise.values()):
        raise AssertionError(f"K7/K8 differ from K1/K2 at {tuple(sol.shape)} K {K} {dtype}: {bitwise}")
    if launches != want:
        raise AssertionError(f"K7/K8 took {launches} launches, not {want}")


def v1_launch_shape(level, K):
    """K7/K8's launch at one level in float32 for every cluster shape: grid,
    cluster dims, threads, dynamic shared memory, blocks one SM holds and
    clusters the card holds at once (cudaOccupancyMaxActiveClusters)."""
    import ctypes

    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    lib, n, nc = s3.load_library(), 2 ** level + 1, 2 ** (level - 1) + 1
    chunk = s3.leg_chunk((n,) * 3, _sm_count())
    for kk, mode, reach in (("K7", s3.LEG_RESTRICT, 1), ("K8", s3.LEG_PROLONG, 0)):
        for cluster in s3.CLUSTER_SHAPES:
            grid = (ctypes.c_int * 3)()
            lib.exa_cluster_grid(n, n, n, nc, nc, nc, mode, chunk, *cluster, grid)
            per_sm = lib.exa_cluster_occupancy(mode, K, reach, *cluster, 0, 0)
            phase("v1_launch_shape", kernel=kk, level=level, K=K, dtype="float32",
                  cluster=cluster, default=cluster == s3.CLUSTER[mode], grid=tuple(grid),
                  blocks=grid[0] * grid[1] * grid[2], chunk=chunk,
                  threads=s3._cluster_threads(mode, K, reach, cluster),
                  smem=s3._cluster_smem(mode, K, reach, 4, cluster), blocks_per_sm=per_sm,
                  two_blocks_per_sm=per_sm >= 2,
                  max_active_clusters=lib.exa_cluster_occupancy(mode, K, reach, *cluster, 0, 1))


def cluster_variants(level, K):
    """K7/K8 at one level, float32, on every cluster shape in one process:
    each bitwise K1/K2, device ms of one call; returns {kernel: {shape: ms}}."""
    from exastencils_tpu_torch.core.stencil import node_prolongation, node_restriction
    from exastencils_tpu_torch.ops.cuda import stream3d as s3
    from exastencils_tpu_torch.ops.transfer import separable_kernels

    A, sol, rhs, sol_c, cshape = leg_inputs(level, torch.float32, seed=level + 7)
    R, P = node_restriction(3), node_prolongation(3)
    rk, pk = separable_kernels(R), separable_kernels(P)
    s1, c1 = s3.smooth_res_restrict(sol.clone(), rhs, A, OMEGA, K, rk, R.lo, cshape)
    s2 = s3.prolong_correct_smooth(sol.clone(), sol_c, rhs, A, OMEGA, K, pk, P.lo)
    out = {"K7": {}, "K8": {}}
    for cluster in s3.CLUSTER_SHAPES:
        s7, c7 = s3.smooth_res_restrict_wavefront(sol, rhs, A, OMEGA, K, rk, R.lo, cshape,
                                                  cluster=cluster)
        s8 = s3.prolong_correct_smooth_wavefront(sol, sol_c, rhs, A, OMEGA, K, pk, P.lo,
                                                 cluster=cluster)
        if not (torch.equal(s7, s1) and torch.equal(c7, c1) and torch.equal(s8, s2)):
            raise AssertionError(f"cluster {cluster}: K7/K8 differ from K1/K2 at level {level}")
        out["K7"][cluster] = cuda_ms(lambda: s3.smooth_res_restrict_wavefront(
            sol, rhs, A, OMEGA, K, rk, R.lo, cshape, cluster=cluster), 5)
        out["K8"][cluster] = cuda_ms(lambda: s3.prolong_correct_smooth_wavefront(
            sol, sol_c, rhs, A, OMEGA, K, pk, P.lo, cluster=cluster), 5)
    for kk, mode in (("K7", s3.LEG_RESTRICT), ("K8", s3.LEG_PROLONG)):
        phase("cluster_variants", kernel=kk, level=level, K=K, dtype="float32",
              default=s3.CLUSTER[mode], bitwise_k1_k2=True,
              **{f"ms_{cy}x{cx}": f"{ms:.4f}" for (cy, cx), ms in out[kk].items()})
    return out


@contextlib.contextmanager
def v1_schedule():
    """EXA_STREAM_V1=1 while the solver is built and run, as bench.py's
    schedule A/B sets it (bench.py:207-218)."""
    os.environ["EXA_STREAM_V1"] = "1"
    try:
        yield
    finally:
        os.environ.pop("EXA_STREAM_V1", None)


def ab_schedule(full, main_ms, v1_ms):
    """The schedule A/B (bench.py's ab_schedule) in this process: the v1
    legs K7/K8 against the v2 legs K1/K2 (513^3 f32, K=3, timed above), and
    one solver's V(3,3) cycle on each schedule, timed in the order v2, v1,
    v1, v2 (the host varies between blocks more than the legs do); the
    paths' own cycle times beside them."""
    from exastencils_tpu_torch import Knowledge
    from exastencils_tpu_torch.models.poisson import PoissonMGSolver
    from exastencils_tpu_torch.runtime.staging import Staged

    k = Knowledge(dimensionality=3, minLevel=0, maxLevel=MAIN_LEVEL, useDblPrecision=False,
                  tpu_compute_dtype="float32").update()
    solver = PoissonMGSolver(k, device="cuda", omega=OMEGA, n_pre=K_MAIN, n_post=K_MAIN)
    sol, rhs = solver.init_state()

    def cycle_ms(v1):
        # the schedule is chosen when the cycle is captured: one staged
        # cycle per schedule, captured under it
        with v1_schedule() if v1 else contextlib.nullcontext():
            staged, x = Staged(solver.mg.cycle, donate=(0,)), sol.clone()
            return cuda_ms(lambda: staged(x, rhs), 10)

    ms = [cycle_ms(v1) for v1 in (False, True, True, False)]
    v2_ms, v1_cycle_ms = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
    phase("ab_schedule", **{f"{a}_ms": f"{full[a]['ms']:.4f}" for a in ("K7", "K1", "K8", "K2")},
          K7_over_K1=f"{full['K7']['ms'] / full['K1']['ms']:.3f}",
          K8_over_K2=f"{full['K8']['ms'] / full['K2']['ms']:.3f}",
          cycle_ms_v2_v1_v1_v2=[f"{m:.3f}" for m in ms], v1_over_v2=f"{v1_cycle_ms / v2_ms:.3f}",
          v1_path_ms=f"{v1_ms:.3f}", main_path_ms=f"{main_ms:.3f}")


def launch_counts(reset=False):
    """The wrappers' launch counters by kernel, optionally set to 0."""
    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    if reset:
        for fn, _ in KERNELS.values():
            getattr(s3, fn).launches = 0
    return {kk: getattr(s3, fn).launches for kk, (fn, _) in KERNELS.items()}


def drive_path(tag, use_kernels, drop_bound, model_kw=None, **knowledge_kw):
    """One PoissonMGSolver V(3,3) path at 513^3 float32 on the card, as
    bench.py builds it.  The solver's cycle is staged (DenseBackend.wrap):
    its first call warms up and captures the CUDA graphs, then one checked
    cycle replays them with the launch counters set to 0 just before it and
    read just after; it must equal the eager cycle (`mg.cycle`) bit for
    bit.  Then the staged and the eager cycles are timed."""
    from exastencils_tpu_torch import Knowledge
    from exastencils_tpu_torch.models.poisson import PoissonMGSolver

    k = Knowledge(dimensionality=3, minLevel=0, maxLevel=MAIN_LEVEL, useDblPrecision=False,
                  tpu_compute_dtype="float32", tpu_use_pallas=use_kernels,
                  **knowledge_kw).update()
    solver = PoissonMGSolver(k, device="cuda", omega=OMEGA, n_pre=K_MAIN, n_post=K_MAIN,
                             **(model_kw or {}))
    sol, rhs = solver.init_state()
    r0 = float(solver._res_norm(sol, rhs))
    eager = solver.mg.cycle(sol.clone(), rhs)  # the cycle updates its iterate in place
    staged, x = solver._cycle, sol.clone()
    staged(x, rhs)  # warm-up and capture, bound to x
    first_equal = torch.equal(x, eager)
    x.copy_(sol)
    reads0 = staged.stats.host_reads
    launch_counts(reset=True)
    s1 = staged(x, rhs)  # a replay
    torch.cuda.synchronize()
    launches = launch_counts()
    reads = staged.stats.host_reads - reads0
    if not (s1 is x and first_equal and torch.equal(s1, eager)):
        raise AssertionError(f"{tag}: the staged cycle differs from the eager one")
    r1 = float(solver._res_norm(s1, rhs))
    if not (np.isfinite(r1) and tuple(s1.shape) == (2 ** MAIN_LEVEL + 1,) * 3):
        raise AssertionError(f"{tag}: bad cycle output: shape {tuple(s1.shape)}, residual {r1}")
    if not r1 < drop_bound * r0:
        raise AssertionError(f"{tag}: residual drop {r1 / r0} not below {drop_bound}")
    reps = 10 if use_kernels else 3
    ms = cuda_ms(lambda: staged(x, rhs), reps)
    state = {"s": sol.clone()}

    def step():
        state["s"] = solver.mg.cycle(state["s"], rhs)

    eager_ms = cuda_ms(step, reps)
    idle = {}
    if use_kernels:  # device idle share in a profiler trace of two cycles
        from exastencils_tpu_torch.runtime.dsl_profile import busy_ms

        idle = {"idle_share": f"{busy_ms(lambda: staged(x, rhs), 2)[3]:.4f}",
                "eager_idle_share": f"{busy_ms(step, 2)[3]:.4f}"}
    glups = (2 ** MAIN_LEVEL + 1) ** 3 / (ms * 1e-3) / 1e9
    st = staged.stats
    STAGING[tag if use_kernels else f"{tag}_plain"] = {
        "graphs": st.graphs, "segments": st.segments, "loops": st.loops,
        "capture_s": round(st.capture_s, 3), "pool_bytes": st.pool_bytes}
    phase(tag, kernels=use_kernels, residual_drop=f"{r1 / r0:.4e}", bound=drop_bound,
          cycle_ms=f"{ms:.3f}", eager_ms=f"{eager_ms:.3f}", glups=f"{glups:.4f}", **idle,
          launches_per_cycle=launches, staged_equals_eager=True, host_reads_per_cycle=reads,
          graphs=st.graphs, segments=st.segments, loops=st.loops,
          capture_s=f"{st.capture_s:.3f}", pool_bytes=st.pool_bytes)
    return ms, launches, eager


def path_with_and_without_kernels(tag, expected, drop_bound, model_kw=None, **knowledge_kw):
    """drive_path with kernels (launch counts must equal `expected`), then
    plain; the two cycles' outputs must agree to the float32 tolerance.
    Returns the launch counts and the cycle ms with kernels."""
    ms_k, launches, s_k = drive_path(tag, True, drop_bound, model_kw, **knowledge_kw)
    if launches != expected:
        raise AssertionError(f"{tag}: launches per cycle {launches}, expected {expected}")
    ms_p, _, s_p = drive_path(tag, False, drop_bound, model_kw, **knowledge_kw)
    d = rel_err(s_k, s_p)
    tol = TOL[torch.float32]
    phase(f"{tag}_kernel_vs_plain", max_abs=f"{d[0]:.3e}", rel=f"{d[1]:.3e}", tol=tol,
          speedup=f"{ms_p / ms_k:.2f}")
    if not d[1] <= tol:
        raise AssertionError(f"{tag}: kernel and plain cycles differ by {d[1]:.3e} (relative)")
    return launches, ms_k


def solve_both(tag, model_kw=None, **knowledge_kw):
    """maxLevel 5 float64 solve on CUDA (kernels) and CPU (plain path)."""
    from exastencils_tpu_torch import Knowledge
    from exastencils_tpu_torch.models.poisson import PoissonMGSolver

    out = {}
    for dev in ("cuda", "cpu"):
        k = Knowledge(dimensionality=3, minLevel=0, maxLevel=5, **knowledge_kw).update()
        _, lines, r0, r1, it = PoissonMGSolver(k, device=dev, **(model_kw or {})).solve(
            max_its=100, target_res_reduction=1e-10)
        if not r1 <= 1e-10 * r0:
            raise AssertionError(f"{tag} {dev}: not converged to 1e-10 ({r0} -> {r1})")
        out[dev] = (lines, it)
    if out["cuda"] != out["cpu"]:
        raise AssertionError(f"{tag}: residual lines differ:\n{out['cuda']}\n{out['cpu']}")
    phase(f"solve_l5_f64_{tag}", cycles=out["cuda"][1], lines_identical=True,
          last=out["cuda"][0][-1])


BENCH_EXA4 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                          "poisson_3d_bench.exa4")
EX2D_EXA4 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "poisson_2d.exa4")


def dsl_executable(path, device, fastpath=True, dims=3, min_level=1, max_level=None,
                   f64=False, lines=None, jit_functions=None):
    """The port's L4Executable for an example program, as bench.py's
    bench_dsl builds it (float32 unless f64); staged by default on the
    card, eager with jit_functions=False."""
    from exastencils_tpu_torch.dsl.parser import parse_l4

    from exastencils_tpu_torch import Knowledge
    from exastencils_tpu_torch.dsl.interpreter import L4Executable

    k = Knowledge(dimensionality=dims, minLevel=min_level,
                  maxLevel=MAIN_LEVEL if max_level is None else max_level,
                  useDblPrecision=f64, tpu_compute_dtype="" if f64 else "float32",
                  tpu_shard_dsl=False, tpu_dsl_fastpath=fastpath).update()
    return L4Executable(parse_l4(path), k, device=device,
                        out=(lambda s: None) if lines is None else lines.append,
                        jit_functions=jit_functions)


DSL_DROP_BOUND = 0.2
# The DSL program's first cycle from zero reduces the residual by ~0.16
# (0.155 in the reference's own lines at maxLevel 4; 0.163 at maxLevels 6
# and 7 on the CPU, 0.164 at 513^3 on the card), hence 0.2.


def kernel_of(name):
    """K1-K8 by a device event's kernel name (template arguments <T, K,
    MODE, ...>: MODE 0 smooth, 1 prolong, 2 restrict), else None."""
    import re

    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    if "restrict_kernel<" in name:
        return "K4"
    if "prolong_kernel<" in name:
        return "K5"
    m = re.search(r"(cluster_leg|leg_kernel)<\w+, \d+, (\d+)", name)
    if m is None:
        return None
    mode = int(m.group(2))
    order = {s3.LEG_RESTRICT: 0, s3.LEG_PROLONG: 1, s3.LEG_SMOOTH: 2}[mode]
    return (("K7", "K8", "K6") if m.group(1) == "cluster_leg" else ("K1", "K2", "K3"))[order]


def replay_kernels(fn):
    """The kernels K1-K8 that a torch.profiler trace of one fn() shows on
    the device, counted by name, the device events in all and the first
    three event names (`dsl_profile.device_events`: the trace's own first
    milliseconds, which can lose their events, hold another fn() and a
    marker kernel)."""
    from exastencils_tpu_torch.runtime.dsl_profile import device_events

    seen, names = {}, []
    for e in device_events(fn, 1):
        names.append(e.name[:48])
        kk = kernel_of(e.name)
        if kk is not None:
            seen[kk] = seen.get(kk, 0) + 1
    return seen, len(names), names[:3]


def drive_dsl(tag, fastpath, expected, jit_functions=None):
    """The DSL benchmark program at 513^3 float32 on the card: InitF, the
    residual (CalcRes + ResNorm), one MGCycle@finest (staged: its warm-up,
    capture and first replay), the residual, then the checked cycle with
    the launch counters set to 0 just before it and read just after (staged:
    a replay; its kernels also counted by name in a torch.profiler trace of
    the next replay), then MGCycle@finest timed with CUDA events over
    chained calls, as bench_dsl times it.  Returns the cycle ms, U@finest
    after cycles 1 and 2, and the residual after cycle 1."""
    ex = dsl_executable(BENCH_EXA4, "cuda", fastpath, jit_functions=jit_functions)
    fin = ex.hi
    fn = {name: ex.functions[(name, fin)] for name in ("InitF", "CalcRes", "ResNorm", "MGCycle")}

    def res_norm():
        ex.call_function(fn["CalcRes"], fin, [])
        return float(ex.call_function(fn["ResNorm"], fin, []))

    def cycle():
        ex.call_function(fn["MGCycle"], fin, [])

    ex.call_function(fn["InitF"], fin, [])
    r0 = res_norm()
    cycle()
    u1 = ex.get_field("U", fin).clone()
    r1 = res_norm()
    reads0 = ex.stage_stats.host_reads
    launch_counts(reset=True)
    cycle()
    torch.cuda.synchronize()
    launches = launch_counts()
    reads = ex.stage_stats.host_reads - reads0
    u2 = ex.get_field("U", fin).clone()
    if not (np.isfinite(r1) and tuple(u1.shape) == (2 ** MAIN_LEVEL + 1,) * 3
            and u1.dtype == torch.float32):
        raise AssertionError(f"{tag}: bad cycle output {tuple(u1.shape)} {u1.dtype}, residual {r1}")
    if not r1 < DSL_DROP_BOUND * r0:
        raise AssertionError(f"{tag}: residual drop {r1 / r0} not below {DSL_DROP_BOUND}")
    if launches != expected:
        raise AssertionError(f"{tag}: launches per cycle {launches}, expected {expected}")
    extra = {}
    if ex.jit_functions:
        st = ex.staging_stats()
        want_seen = {kk: n for kk, n in expected.items() if n}
        seen, events, first = replay_kernels(cycle)
        if st["unstaged"] or seen != want_seen:
            raise AssertionError(f"{tag}: unstaged runs {st['unstaged_runs']}, kernels in a "
                                 f"replay {seen}, expected {want_seen}, {events} device "
                                 f"events, the first {first}")
        STAGING[tag] = {kk: st[kk] for kk in ("graphs", "segments", "loops", "captures")}
        STAGING[tag].update(capture_s=round(st["capture_s"], 3), pool_bytes=st["pool_bytes"])
        extra = dict(unstaged=0, replay_kernels=seen, device_events=events,
                     host_reads_per_cycle=reads, graphs=st["graphs"], segments=st["segments"],
                     loops=st["loops"], capture_s=f"{st['capture_s']:.3f}",
                     pool_bytes=st["pool_bytes"])
    ms = cuda_ms(cycle, 10 if fastpath else 3)
    glups = (2 ** MAIN_LEVEL + 1) ** 3 / (ms * 1e-3) / 1e9
    phase(tag, fastpath=fastpath, staged=ex.jit_functions, residual_drop=f"{r1 / r0:.4e}",
          bound=DSL_DROP_BOUND, cycle_ms=f"{ms:.3f}", glups=f"{glups:.4f}",
          launches_per_cycle=launches, **extra)
    return ms, u1, r1, u2


def dsl_staged_vs_eager(tag, staged, eager):
    """U@finest after cycles 1 and 2, staged against eager: bit for bit."""
    same = (torch.equal(staged[1], eager[1]), torch.equal(staged[3], eager[3]))
    phase(f"{tag}_staged_vs_eager", u_cycle1_bitwise=same[0], u_cycle2_bitwise=same[1],
          staged_ms=f"{staged[0]:.3f}", eager_ms=f"{eager[0]:.3f}",
          speedup=f"{eager[0] / staged[0]:.2f}")
    if not all(same):
        raise AssertionError(f"{tag}: staged and eager U@finest differ {same}")


def loop_chunk_times(chunks=(1, 4, 16)):
    """The staged DSL cycle (513^3 float32) with each chunk of device-loop
    iterations per host read (runtime/staging.LOOP_CHUNK): cycle ms and
    host reads per cycle, U@finest bitwise alike for every chunk."""
    from exastencils_tpu_torch.runtime import staging

    out, ref, keep = {}, None, staging.LOOP_CHUNK
    try:
        for chunk in chunks:
            staging.LOOP_CHUNK = chunk
            ex = dsl_executable(BENCH_EXA4, "cuda")
            fin = ex.hi
            ex.call_function(ex.functions[("InitF", fin)], fin, [])

            def cycle():
                ex.call_function(ex.functions[("MGCycle", fin)], fin, [])

            cycle()
            u = ex.get_field("U", fin).clone()
            if ref is not None and not torch.equal(u, ref):
                raise AssertionError(f"loop_chunk: chunk {chunk} changes U@finest")
            ref = u if ref is None else ref
            r0 = ex.stage_stats.host_reads
            ms = cuda_ms(cycle, 10)
            out[chunk] = (ms, (ex.stage_stats.host_reads - r0) / 11)
            del ex, u
    finally:
        staging.LOOP_CHUNK = keep
    phase("loop_chunk", default=keep, **{f"chunk{c}_ms": f"{v[0]:.3f}" for c, v in out.items()},
          **{f"chunk{c}_reads_per_cycle": v[1] for c, v in out.items()})


def fused_path():
    """main_path's solver to 1e-10 at 513^3, in float64 (float32 stalls far
    above 1e-10): the host-driven solve replaying the staged cycle and
    residual norm, the device-resident solve_fused (one recording, a device
    loop over cycles with one host read of its done flag per cycle) and
    the eager solve.  solve_fused must take the same cycles to the same
    final residual and iterate, bit for bit; ms per cycle of each, the
    recordings captured before the timed solves."""
    from exastencils_tpu_torch import Knowledge
    from exastencils_tpu_torch.models.poisson import PoissonMGSolver

    def solver():
        k = Knowledge(dimensionality=3, minLevel=0, maxLevel=MAIN_LEVEL).update()
        return PoissonMGSolver(k, device="cuda", omega=OMEGA, n_pre=K_MAIN, n_post=K_MAIN)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    a = solver()
    sol0, rhs = a.init_state()
    x = sol0.clone()
    a.solve(max_its=100, target_res_reduction=1e-10, print_error=False, state=(x, rhs))
    x.copy_(sol0)
    (_, _, init, cur, it), solve_s = timed(lambda: a.solve(
        max_its=100, target_res_reduction=1e-10, print_error=False, state=(x, rhs)))
    b = solver()
    y = sol0.clone()
    b.solve_fused(max_its=100, target_res_reduction=1e-10, state=(y, rhs))
    fused = b.gen._fused[(1e-10, 100)]
    y.copy_(sol0)
    reads0 = fused.stats.host_reads
    (f_sol, f_init, f_cur, f_it), fused_s = timed(lambda: b.solve_fused(
        max_its=100, target_res_reduction=1e-10, state=(y, rhs)))
    reads = fused.stats.host_reads - reads0
    z = sol0.clone()
    (_, _, _, e_it), eager_s = timed(lambda: a.mg.solve(z, rhs, 1e-10, 100, jit=False))
    same = (int(f_it) == it == e_it, float(f_cur) == cur, float(f_init) == init,
            f_sol is y and torch.equal(y, x))
    if not (all(same) and cur <= 1e-10 * init):
        raise AssertionError(f"main_path_fused: solve_fused against solve {same}, "
                             f"{init} -> {cur} in {it}")
    st = fused.stats
    STAGING["main_path_fused"] = {"graphs": st.graphs, "segments": st.segments,
                                  "loops": st.loops, "capture_s": round(st.capture_s, 3),
                                  "pool_bytes": st.pool_bytes}
    phase("main_path_fused", dtype="float64", cycles=it, residual=f"{cur:.6e}",
          same_cycles_residual_iterate=True, fused_ms_per_cycle=f"{fused_s * 1e3 / it:.3f}",
          solve_ms_per_cycle=f"{solve_s * 1e3 / it:.3f}",
          eager_ms_per_cycle=f"{eager_s * 1e3 / it:.3f}", host_reads=reads,
          host_reads_per_cycle=f"{reads / it:.2f}", graphs=st.graphs, loops=st.loops,
          capture_s=f"{st.capture_s:.3f}", pool_bytes=st.pool_bytes)


def dsl_fast_vs_plain(fast, plain):
    """U@finest and the residual after the first cycle with the fast path
    against the plain executor's, both from InitF: float32 tolerance."""
    d = rel_err(fast[1], plain[1])
    dr = abs(fast[2] - plain[2]) / plain[2]
    tol = TOL[torch.float32]
    phase("dsl_path_fast_vs_plain", u_max_abs=f"{d[0]:.3e}", u_rel=f"{d[1]:.3e}",
          residual_rel=f"{dr:.3e}", tol=tol)
    if not (d[1] <= tol and dr <= tol):
        raise AssertionError(f"dsl_path: fast path and plain differ: U {d[1]:.3e}, residual {dr:.3e}")


def dsl_lines(tag, path, dims, min_level, max_level):
    """A float64 run of an example on the card and on the CPU (fast path
    off there): the printed lines must be identical."""
    out = {}
    for dev in ("cuda", "cpu"):
        lines = []
        dsl_executable(path, dev, dev == "cuda", dims, min_level, max_level, True, lines).run()
        out[dev] = lines
    if out["cuda"] != out["cpu"] or len(out["cpu"]) < 3:
        raise AssertionError(f"{tag}: lines differ:\n{out['cuda']}\n{out['cpu']}")
    phase(tag, lines_identical=True, n_lines=len(out["cpu"]), first=out["cpu"][0],
          last_residual=out["cpu"][-2], cycles=out["cpu"][-1])
    return out["cpu"]


def dsl_cli(want):
    """`python -m exastencils_tpu_torch --f64` on the card from temporary
    settings and knowledge files (the maxLevel 6 bench program): it must
    print the lines of the in-process CPU run."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        settings, knowledge = os.path.join(d, "b.settings"), os.path.join(d, "b.knowledge")
        with open(settings, "w") as f:
            f.write(f'l4file = "{BENCH_EXA4}"\n')
        with open(knowledge, "w") as f:
            f.write("dimensionality = 3\nminLevel = 1\nmaxLevel = 6\ntpu_shard_dsl = false\n")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "exastencils_tpu_torch", "--f64", settings,
                              knowledge], capture_output=True, text=True, timeout=300,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
    if run.returncode != 0 or run.stdout.splitlines() != want:
        raise AssertionError(f"dsl_cli: rc {run.returncode}\n{run.stdout}\n{run.stderr[-2000:]}")
    phase("dsl_cli", rc=run.returncode, lines_identical=True,
          seconds=f"{time.perf_counter() - t0:.2f}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1
    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    phase("device", nvidia_smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda, name=repr(name))

    t0 = time.perf_counter()
    s3.load_library()
    log = s3.library_path().with_suffix(".log")
    regs = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln] if log.exists() else []
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}", ptxas=regs)

    none = dict.fromkeys(KERNELS, 0)
    # legs3d.cu launches per leg and level: one (K=3 fits one launch in float32)
    per_level = {kk: len(s3.leg_chain(m, K_MAIN, torch.float32, r))
                 for kk, m, r in (("K1", s3.LEG_RESTRICT, 1), ("K2", s3.LEG_PROLONG, 0))}
    dsl_levels = MAIN_LEVEL - 4  # levels 5..9: >= 33 nodes per dim (dsl/fastpath.py)
    dsl_want = {**none, **{kk: dsl_levels * v for kk, v in per_level.items()}}
    fast = drive_dsl("dsl_path", True, dsl_want)
    fast_eager = drive_dsl("dsl_path_eager", True, dsl_want, jit_functions=False)
    dsl_staged_vs_eager("dsl_path", fast, fast_eager)
    plain = drive_dsl("dsl_path_plain", False, none, jit_functions=False)
    dsl_fast_vs_plain(fast, plain)
    dsl_ms, dsl_eager_ms, dsl_plain_ms = fast[0], fast_eager[0], plain[0]
    del fast, fast_eager, plain
    with v1_schedule():
        v1_want = {**none, "K7": dsl_levels, "K8": dsl_levels}
        v1_staged = drive_dsl("dsl_v1_path", True, v1_want)
        v1_eager = drive_dsl("dsl_v1_path_eager", True, v1_want, jit_functions=False)
        dsl_staged_vs_eager("dsl_v1_path", v1_staged, v1_eager)
    dsl_v1_ms = v1_staged[0]
    del v1_staged, v1_eager

    for level, K in ((4, 1), (5, 3)):
        for dtype in (torch.float64, torch.float32):
            compare_legs(level, K, dtype)
    for shape, excl in LEG_CASES:
        for K in (1, 2, 3, 4):
            for dtype in (torch.float64, torch.float32):
                compare_legs(None, K, dtype, shape=shape, excl=excl)
    for level in (4, 5):
        for K in (1, 3):
            for dtype in (torch.float64, torch.float32):
                compare_fused(level, K, dtype)
                compare_wavefronts(level, K, dtype)
    for dtype in (torch.float64, torch.float32):
        compare_fused(5, 3, dtype, excl=(2, 30, -1, 5, 1, -1))
        compare_wavefronts(5, 3, dtype, excl=(2, 30, -1, 5, 1, -1))
    for shape, excl in SMOOTHER_CASES:
        for K in (1, 2, 3, 4, 5):
            for dtype in (torch.float64, torch.float32):
                compare_fused(None, K, dtype, excl=excl, shape=shape, transfers=False)
                compare_wavefronts(None, K, dtype, excl=excl, shape=shape)
    for i, shape in enumerate(TRANSFER_SHAPES):
        for cell in (False, True):
            for dtype in (torch.float64, torch.float32):
                if dtype == torch.float32 or shape in TRANSFER_F64:
                    compare_transfers(shape, dtype, cell, seed=i)
    for K in (1, 2, 3, 4):
        for dtype in (torch.float64, torch.float32):
            for level in (4, 5):
                compare_v1_legs(level, K, dtype)
            for shape in dict.fromkeys(shape for shape, _ in LEG_CASES):  # K7/K8: no excl
                compare_v1_legs(None, K, dtype, shape=shape)
    n, nc = 2 ** MAIN_LEVEL + 1, 2 ** (MAIN_LEVEL - 1) + 1
    full = compare_legs(MAIN_LEVEL, K_MAIN, torch.float32, timed=True)
    leg_launch_shape(MAIN_LEVEL, K_MAIN)
    for level in range(2, MAIN_LEVEL):
        leg_level_times(level, K_MAIN)
    full.update(compare_fused(MAIN_LEVEL, K_MAIN, torch.float32, timed=True))
    variants = transfer_variants(MAIN_LEVEL)
    library = library_transfers(MAIN_LEVEL)
    for kk in ("K4", "K5"):
        b_ms = bound(kk, n, nc, K_MAIN, torch.float32)[0]
        full[kk]["library_ms"] = library[kk]
        phase("transfer_times", kernel=kk, level=MAIN_LEVEL, ms=f"{full[kk]['ms']:.4f}",
              bound_ms=f"{b_ms:.4f}", share_of_bound=f"{b_ms / full[kk]['ms']:.3f}",
              library_ms=f"{library[kk]:.4f}",
              **{f"ms_{v}": f"{ms:.4f}" for v, ms in variants[kk].items()})
    for level in range(2, MAIN_LEVEL + 1):
        transfer_level_times(level)
    full.update(compare_wavefronts(MAIN_LEVEL, K_MAIN, torch.float32, timed=True))
    v1_launch_shape(MAIN_LEVEL, K_MAIN)
    cluster_variants(MAIN_LEVEL, K_MAIN)
    _, _, copy_ms = smoother_variants(MAIN_LEVEL, K_MAIN)
    for kk in ("K3", "K6", "K1", "K2", "K7", "K8"):
        b_ms = bound(kk, n, nc, K_MAIN, torch.float32)[0]
        phase("smoother_times" if kk in ("K3", "K6") else "leg_times_same_call", kernel=kk,
              level=MAIN_LEVEL, K=K_MAIN, ms=f"{full[kk]['ms']:.4f}", bound_ms=f"{b_ms:.4f}",
              share_of_bound=f"{b_ms / full[kk]['ms']:.3f}",
              **({"copy_back_ms": f"{copy_ms:.4f}"} if kk in ("K1", "K2", "K3") else {}))
    for level in range(2, MAIN_LEVEL + 1):
        smoother_level_times(level, K_MAIN)

    launches = {}
    main, main_ms = path_with_and_without_kernels(
        "main_path", {**none, **{kk: (MAIN_LEVEL - 1) * v for kk, v in per_level.items()}}, 0.1)
    launches.update(K1=main["K1"], K2=main["K2"])
    transfers = MAIN_LEVEL - 1  # one K4 and one K5 per level 2..9
    jac, _ = path_with_and_without_kernels("jacobi_path", {**none, "K4": transfers, "K5": transfers},
                                        0.4, model_kw={"smoother": "Jac"})
    launches.update(K4=jac["K4"], K5=jac["K5"])
    k3_calls = 2 * (MAIN_LEVEL - 1)  # pre- and post-smoothing on levels 2..9
    k3_per_call = len(s3.leg_chain(s3.LEG_SMOOTH, K_MAIN, torch.float32))  # one at K=3 in float32
    fas, _ = path_with_and_without_kernels("fas_path", {**none, "K3": k3_calls * k3_per_call}, 0.1,
                                        solver_useFAS=True)
    phase("fas_path_k3", calls_per_cycle=k3_calls, launches_per_call=k3_per_call,
          launches=fas["K3"])
    launches.update(K3=fas["K3"])
    with v1_schedule():
        v1, v1_ms = path_with_and_without_kernels("v1_path",
                                                  {**none, "K7": transfers, "K8": transfers}, 0.1)
        launches.update(K7=v1["K7"], K8=v1["K8"])
        v1_fas, _ = path_with_and_without_kernels(
            "v1_fas_path", {**none, "K6": k3_calls * k6_launches(K_MAIN, torch.float32)}, 0.1,
            solver_useFAS=True)
        launches.update(K6=v1_fas["K6"])

    solve_both("rbgs")
    solve_both("jacobi", model_kw={"smoother": "Jac"})
    solve_both("fas", solver_useFAS=True)
    solve_both("rbgs_v02", model_kw={"n_pre": 0, "n_post": 2})
    with v1_schedule():
        solve_both("rbgs_v1")
        solve_both("fas_v1", solver_useFAS=True)
    fused_path()
    phase("dsl_path_summary", staged_ms=f"{dsl_ms:.3f}", eager_ms=f"{dsl_eager_ms:.3f}",
          plain_ms=f"{dsl_plain_ms:.3f}", speedup_over_eager=f"{dsl_eager_ms / dsl_ms:.2f}",
          main_path_ms=f"{main_ms:.3f}", dsl_vs_main_path=f"{dsl_ms / main_ms:.3f}")
    phase("dsl_v1_path_summary", cycle_ms=f"{dsl_v1_ms:.3f}",
          dsl_v1_vs_v1_path=f"{dsl_v1_ms / v1_ms:.3f}")
    loop_chunk_times()
    ab_schedule(full, main_ms, v1_ms)
    want = dsl_lines("dsl_lines_3d_l6_f64", BENCH_EXA4, 3, 1, 6)
    dsl_lines("dsl_lines_2d_l5_f64", EX2D_EXA4, 2, 0, 5)
    dsl_cli(want)
    phase("staging", **{tag: v for tag, v in STAGING.items()})
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    kernels = []
    for kk, (fn, rep) in KERNELS.items():
        b_ms, b_by = bound(kk, n, nc, K_MAIN, torch.float32)
        kernels.append({"name": f"{kk} {fn}", "route": "cuda", "source": SOURCES[kk],
                        "replaces": rep, "launches": launches[kk],
                        "max_abs_err": full[kk]["max_abs_err"], "ms": full[kk]["ms"],
                        "plain_ms": full[kk]["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
                        # K4/K5: compositions of library calls (library_transfers); no
                        # PyTorch call computes any of the others
                        "library_ms": full[kk].get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
