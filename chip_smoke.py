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
holds the variable-coefficient legs K11/K12 to their plain sweeps at 513^3
float64 and times them beside K1/K2 and the solver's staged cycle
(varcoeff_path), and drives the DSL entry points on
examples/poisson_3d_bench.exa4 (the two DSL paths right after the build):
  dsl_path     the L4 executor at 513^3 float32, MGCycle@finest with the
               fast path (K1/K2 on levels 5-9) staged (the default: one
               recording of CUDA graphs, its kernels named in a profiler
               trace of a replay) and eager (dsl_path_eager, bit for bit the
               same U@finest), and without the fast path (dsl_path_plain);
               the finest-level check (CalcRes + ResNorm) before it
               launches the check kernels K9/K10 once each (none plain);
  check_times  K9 (residual) and K10 (sum of squares) alone at 513^3
               float32 against their plain versions and their bounds, the
               whole check through the staged executor with and without
               them;
  dsl_solve_checks  the program's Solve at 513^3 float32 solved twice as
               the benchmark solves: K9/K10 launches a solve (one before
               the loop and one a cycle), and none in a solve of the
               solver API at 513^3 float64 (solve_fused);
  res_norm_times  K13 (the solver API's residual norm in one pass) at
               513^3 float64 on each API cell's finest level (the
               Laplacian; the variable-coefficient star's face arrays)
               against its plain version, its bound and the plain ms, at
               the wrapper's chunk and at NORM_CHUNKS; then the cells'
               four right-hand sides: r_9/r_0 and r_10/r_0 of the cells'
               cycles with the plain norm and with K13;
  dsl_v1_path  the same with EXA_STREAM_V1=1 (K7/K8), staged and eager;
  loop_chunk   the staged cycle with 1, 4 and 16 device-loop iterations
               per host read;
  dsl_lines    maxLevel 6 float64 3D and the 2D example: GPU lines equal
               the CPU's;
  dsl_cli      `python -m exastencils_tpu_torch` in a subprocess on the GPU;
runs the single-device breadth of the solver API, every cycle staged and
bit for bit the eager one:
  cgs_paths    main_path's problem with minLevel 4 (17^3 coarsest) once
               per Krylov coarse solver (CG, BiCGStab with restarts,
               MinRes, ConjugateResidual), K1/K2 on levels 5-9;
  cell_path    a cell-centred Poisson on 512^3 cells from generate_solver
               with the kernels requested: none launches;
  nonuniform_path  a 513^3 linearFct grid with the stretched Laplacian;
  export_path  ExportedSolver numpy to numpy at 513^3, the caller's arrays
               unchanged, `step` under the donation contract;
  io_phase     every field IO backend the machine has, round trip from the
               card at 129^3, printField/printVtk against the CPU's bytes,
               the DSL IO builtins through the CLI;
  perf_estimate  performance_printEstimation's lines at detect_chip()'s
               bandwidth;
compares the two schedules in one process (ab_schedule: K7/K1, K8/K2,
v1_path/main_path), and runs the sharded backend (parallel/), its ranks
spawned on the one card:
  sharded_kernels  the ghosted K1/K2/K3 of one rank's halo-extended
               fragment against their plain versions, for the excl planes
               of each rank of a 2x2x2 mesh, at the fragment of 513^3
               (273^3, ghost 8; timed) and at small fragments (unequal
               cells, an unsharded dim, an odd ghost width);
  sharded_path main_path's solver on 2x2x2 ranks over gloo (the halo
               slabs through pinned host buffers, fields and kernels on
               the card): K1/K2/K3 launches per rank and cycle, cycle ms
               on rank 0 (CUDA events between barriers) and the share of
               a cycle spent in the exchange, the first cycle's residual
               against the dense one, and a float64 level-6 solve whose
               lines must be the dense port's;
  sharded_world1_nccl  one rank over NCCL on a 1x1x1 mesh (excl planes on
               all six sides): main_path's problem prints the dense lines;
  sharded_dryrun  parallel/dryrun.py at 4 ranks: the DSL half (the 2D
               example over a 2x2 rank mesh, digit-equal to the dense
               run), then the Python-API half;
and the sharded DSL (dsl/interp_fragments), its ranks spawned on the one
card over gloo:
  sharded_dsl_path  examples/poisson_3d_bench.exa4 at 513^3 float32 on
               2x2x2 ranks (no kernel: the DSL fast path is dense only):
               the program's Solve, whose lines must agree with the dense
               plain executor's on the card (the same cycle count, each
               residual within max(1e-5 rel, 2 F), F the largest
               difference of the dense fast path's lines to the plain
               executor's), the first drop < 0.2; then 2 more cycles:
               ms per MGCycle@finest on rank 0 (CUDA events between
               barriers), exchanges per rank and cycle (`communicate` and
               implicit apart), MB sent, the exchange share of a cycle in
               a synchronised run, the sharded and replicated levels and
               the runs left eager; and the program's Solve at maxLevel 6
               in float64, whose lines must be the dense run's by the dry
               run's rule;
  sharded_dsl_forms  the bench program in two more forms (forms_program),
               at 513^3 float32 on 2x2x2 ranks, each Solve cut to 4
               cycles: "blocks" smooths with 2-point x-block `solve
               locally relax 0.8` (blocks anchored in the ghost layers
               write owned points), "stretched" runs on a linearFct grid
               (windows of the stretched positions); each Solve's lines
               against the dense plain executor's on the card by
               sharded_dsl_path's rule (its F), the first drop below
               FORM_DROP_BOUND, ms per MGCycle@finest on rank 0 and
               exchanges per rank and cycle, then at maxLevel 6 in
               float64 by the dry run's rule.
In bfloat16 (csrc/star3d.cuh's rounding contract) it holds every kernel
to its plain version (bf16_kernel_phases: the sweeps bitwise, the
transfers within BF16_ULPS bfloat16 ulps; the odd shape with and without
excl planes, levels 4/5, K7/K8 bitwise K1/K2, K4/K5 with node and cell
taps, the ghosted K1/K2/K3 on the 273^3 fragment, and 513^3 timed beside
the bound at itemsize 2) and drives five 513^3 bfloat16 V(3,3) paths
(bf16_paths), staged bit for bit the eager cycle, launches counted in one
replay against leg_chain(..., bfloat16), cycle ms and GLUP/s printed:
  main_path_bf16 (K1/K2), jacobi_path_bf16 (K4/K5), fas_path_bf16 (K3),
  v1_path_bf16 (K7/K8) and v1_fas_path_bf16 (K6), each first-cycle drop
  below BF16_DROP_FACTOR times the plain bfloat16 cycle's of its kind
  (RBGS, Jacobi, FAS: run plain first), and main_path_bf16's cycle within
  BF16_CYCLE_ULPS of its plain run's.
The `staging` line sums up the graphs, device loops,
capture seconds and graph-pool bytes of every staged path.  Every phase
prints one line; any failure raises and exits non-zero.  The third-to-last line
is the kernel table as JSON (with each kernel's bfloat16 ms, bound,
error and launches), then the card's name and power limit, the
last line `{"ok": true, "device": ...}`.  Exits non-zero without printing
a result when no CUDA device is present.
"""

import contextlib
import json
import math
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
# bfloat16 (csrc/star3d.cuh's rounding contract: float32 inside a node update
# or tap sum, one rounding where the kernel stores): the sweeps are bitwise
# the plain versions'; a transfer's output within BF16_ULPS[kernel] bfloat16
# ulps at the largest |value| (the plain version sums the taps as banded
# float32 matmuls, in another order, so a rounding tie can flip; K2/K8
# smooth after such a flip, which can reach a neighbour)
BF16 = torch.bfloat16
BF16_ULPS = {"K1": 1, "K2": 2, "K3": 0, "K4": 1, "K5": 1, "K6": 0, "K7": 1, "K8": 2}
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
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12,
              BF16: 67e12}  # bfloat16 fields: the arithmetic is float32
# per staged path: graphs, segments, device loops, capture seconds, pool bytes
STAGING = {}


T_IMPORT = time.perf_counter()


def phase(tag, **fields):
    fields["t"] = f"{time.perf_counter() - T_IMPORT:.1f}"  # seconds since the import
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


def bf16_ulp(ref):
    """The spacing of bfloat16 numbers at ref's largest |value|."""
    m = ref.abs().max().float().item()
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def rel_err(got, ref):
    """(max abs error, relative to max|ref|, bfloat16 ulp at max|ref|);
    bfloat16 compared in float32."""
    if ref.dtype == BF16:
        got, ref = got.float(), ref.float()
    d = (got - ref).abs().max().item()
    return d, d / max(ref.abs().max().item(), 1e-300), bf16_ulp(ref)


def tol_ok(kk, e, dtype):
    """e = rel_err(got, ref) within kernel kk's tolerance: TOL[dtype]
    relative, or in bfloat16 BF16_ULPS[kk] ulps."""
    return e[0] <= BF16_ULPS[kk] * e[2] if dtype == BF16 else e[1] <= TOL[dtype]


def tol_of(dtype):
    return "bf16_ulps" if dtype == BF16 else TOL[dtype]


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
                 for m, r in ((s3.LEG_RESTRICT, s3.restrict_reach(rk, R.lo)), (s3.LEG_PROLONG, 0)))
    s_ref, rc_ref = s3.smooth_res_restrict_plain(sol, rhs, A, omega, K, rk, R.lo, cshape, excl)
    u_ref = s3.prolong_correct_smooth_plain(sol, sol_c, rhs, A, omega, K, pk, P.lo, excl)
    e_s, e_rc, e_u = rel_err(s_got, s_ref), rel_err(rc_got, rc_ref), rel_err(u_got, u_ref)
    k1_abs, k1_rel = max(e_s[0], e_rc[0]), max(e_s[1], e_rc[1])
    tol = tol_of(dtype)
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
    ok = tol_ok("K1", e_s, dtype) and tol_ok("K1", e_rc, dtype) and tol_ok("K2", e_u, dtype)
    if not (sol_bitwise and ok and all(comp.values())):
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


# The ghosted K1/K2/K3 of the sharded path (ops/cuda make_sharded_fused_*,
# the fragment of one rank, halo-extended): (local cells, mesh shape,
# ghost width, K).  A 2x2x2 fragment of 513^3 at V(3,3); the smallest
# fragment the legs admit at K = 1; unequal cells; x unsharded (a 2x2x1
# mesh: ghost 0 in x, the array edge its boundary); an odd ghost width
# (comm_ghostWidth 9: the aligned restriction taps' lo shifted by one).
SHARDED_KERNEL_CASES = (
    ((256, 256, 256), (2, 2, 2), 8, 3),
    ((2, 2, 2), (2, 2, 2), 4, 1),
    ((6, 10, 14), (2, 2, 2), 8, 3),
    ((10, 6, 32), (2, 2, 1), 8, 3),
    ((6, 6, 6), (2, 2, 2), 9, 3),
)


def rank_topologies(dims, ghost):
    """The ShardTopology of every rank of a mesh of shape `dims`
    (host-side: no process group)."""
    from exastencils_tpu_torch.parallel.mesh import AXIS_NAMES, DomainMesh
    from exastencils_tpu_torch.parallel.topology import ShardTopology

    return [ShardTopology(DomainMesh(dims, rank=r), dims, AXIS_NAMES, ghost)
            for r in range(int(np.prod(dims)))]


def compare_sharded_kernels(cells, dims, g, K, dtype, timed=False):
    """K1, K2 and K3 on one rank's halo-extended fragment against their
    plain versions, for the excl planes (ops/cuda._excl_planes) of each
    rank of a mesh of shape `dims` with ghost width `g`: K1's coarse
    geometry shifted by the ghost width, its y/x coarse ghost rows zero;
    K2's prolongation over the whole fragment.  The RBGS (K3, K1's sol)
    bitwise; K1's coarse rhs and K2 within TOL of the largest value.
    Returns {kernel: max abs error} (and with `timed`, the first rank's
    ms)."""
    from exastencils_tpu_torch.core.stencil import node_prolongation, node_restriction
    from exastencils_tpu_torch.ops.cuda import _excl_planes
    from exastencils_tpu_torch.ops.cuda import stream3d as s3
    from exastencils_tpu_torch.ops.transfer import separable_kernels

    topos = rank_topologies(dims, g)
    ghost = topos[0].ghosts
    shape, cshape = topos[0].local_shape(cells), topos[0].local_shape(tuple(n // 2 for n in cells))
    A, sol, rhs, sol_c, _ = star_inputs(shape, cshape, dtype, seed=sum(cells) + K)
    R, P = node_restriction(3), node_prolongation(3)
    rk, pk = separable_kernels(R), separable_kernels(P)
    tol, worst, out = tol_of(dtype), {"K1": 0.0, "K2": 0.0, "K3": 0.0}, {}
    for topo in topos:
        coords, excl = topo.mesh.coords, _excl_planes(topo, cells)
        n0 = launch_counts()
        s_got, rc_got = s3.smooth_res_restrict(sol.clone(), rhs, A, OMEGA, K, rk, R.lo, cshape,
                                               excl, ghost=ghost)
        u_got = s3.prolong_correct_smooth(sol.clone(), sol_c, rhs, A, OMEGA, K, pk, P.lo, excl,
                                          ghost=ghost)
        m_got = s3.rbgs_fused(sol.clone(), rhs, A, OMEGA, K, excl)
        torch.cuda.synchronize()
        n1 = launch_counts()
        s_ref, rc_ref = s3.smooth_res_restrict_plain(sol, rhs, A, OMEGA, K, rk, R.lo, cshape, excl,
                                                     ghost=ghost)
        u_ref = s3.prolong_correct_smooth_plain(sol, sol_c, rhs, A, OMEGA, K, pk, P.lo, excl,
                                                ghost=ghost)
        m_ref = s3.rbgs_fused_plain(sol, rhs, A, OMEGA, K, excl)
        e_rc, e_u = rel_err(rc_got, rc_ref), rel_err(u_got, u_ref)
        bitwise = bool(torch.equal(s_got, s_ref)) and bool(torch.equal(m_got, m_ref))
        # the y/x coarse ghost layers, which the reference leaves zero
        ghosts_zero = all(not rc_got.narrow(d, start, ghost[d]).any()
                          for d in (1, 2) for start in (0, cshape[d] - ghost[d]))
        launched = all(n1[kk] > n0[kk] for kk in ("K1", "K2", "K3"))
        worst["K1"] = max(worst["K1"], e_rc[0], rel_err(s_got, s_ref)[0])
        worst["K2"] = max(worst["K2"], e_u[0])
        worst["K3"] = max(worst["K3"], rel_err(m_got, m_ref)[0])
        if not (bitwise and tol_ok("K1", e_rc, dtype) and tol_ok("K2", e_u, dtype) and ghosts_zero
                and launched):
            raise AssertionError(
                f"sharded kernels: cells {cells} ghost {ghost} K {K} {dtype} rank {coords}: "
                f"rbgs bitwise {bitwise}, K1 coarse {e_rc[1]:.3e}, K2 {e_u[1]:.3e}, "
                f"ghost rows zero {ghosts_zero}, launched {launched}")
        if timed and topo is topos[0]:
            s = sol.clone()
            out["K1_ms"] = cuda_ms(lambda: s3.smooth_res_restrict(
                s, rhs, A, OMEGA, K, rk, R.lo, cshape, excl, ghost=ghost), 5)
            out["K2_ms"] = cuda_ms(lambda: s3.prolong_correct_smooth(
                s, sol_c, rhs, A, OMEGA, K, pk, P.lo, excl, ghost=ghost), 5)
            out["K3_ms"] = cuda_ms(lambda: s3.rbgs_fused(s, rhs, A, OMEGA, K, excl), 5)
    phase("sharded_kernels", cells=cells, mesh="x".join(map(str, dims)), ghost=ghost,
          shape=shape, coarse=cshape, K=K, dtype=str(dtype).split(".")[1], ranks=len(topos),
          rbgs_bitwise=True,
          **{f"{kk}_max_abs": f"{v:.3e}" for kk, v in worst.items()}, tol=tol,
          **{kk: f"{v:.4f}" for kk, v in out.items()})
    return {**worst, **out}


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
    from exastencils_tpu_torch.ops.cuda import library
    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    lib, n = library.load_library(), 2 ** level + 1
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
    tol = tol_of(dtype)
    phase("compare_transfers", shape=shape, coarse=cshape, taps="cell" if cell else "node",
          dtype=str(dtype).split(".")[1], k4_rel=f"{e4[1]:.3e}", k5_rel=f"{e5[1]:.3e}", tol=tol,
          **({"k4_ulps": e4[0] / e4[2], "k5_ulps": e5[0] / e5[2]} if dtype == BF16 else {}),
          runs_bitwise=bitwise, launches=launches)
    if not (tol_ok("K4", e4, dtype) and tol_ok("K5", e5, dtype) and bitwise):
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
    from exastencils_tpu_torch.ops.cuda.library import star_coefs

    A, sol, rhs, sol_c, cshape = leg_inputs(level, torch.float32, seed=level + 17)
    R, P, rk, pk = transfer_ops(False)
    c = star_coefs(A.offsets, A.coefs, 3)
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
    tol = tol_of(dtype)
    bitwise = bool(torch.equal(s_got, s_ref))
    want = len(s3.leg_chain(s3.LEG_SMOOTH, K, dtype))
    phase("compare_fused", level=level, shape=tuple(sol.shape), K=K,
          dtype=str(dtype).split(".")[1], excl=excl,
          **{f"{kk.lower()}_rel": f"{e[1]:.3e}" for kk, e in errs.items()}, tol=tol,
          k3_bitwise=bitwise, k3_launches=launches)
    if not (bitwise and all(tol_ok(kk, e, dtype) for kk, e in errs.items())):
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
    e_rc7 = rel_err(rc7, rrc7)
    errs = {"K6": rel_err(s6, r6), "K7": max(rel_err(s7, r7), e_rc7), "K8": rel_err(s8, r8)}
    tol = tol_of(dtype)
    bitwise = bool(torch.equal(s6, r6) and torch.equal(s7, r7))
    shapes_bitwise = True
    if excl != s3.NO_EXCL:
        shapes_bitwise = all(torch.equal(s3.rbgs_wavefront(sol, rhs, A, OMEGA, K, excl, cluster=c), r6)
                             for c in s3.CLUSTER_SHAPES)
    phase("compare_wavefronts", level=level, shape=tuple(sol.shape), K=K,
          dtype=str(dtype).split(".")[1], excl=excl,
          **{f"{kk.lower()}_rel": f"{e[1]:.3e}" for kk, e in errs.items()}, tol=tol,
          k6_k7_sol_bitwise=bitwise, k6_every_cluster_bitwise=shapes_bitwise, launches=launches)
    if not (bitwise and shapes_bitwise and tol_ok("K7", e_rc7, dtype) and tol_ok("K8", errs["K8"], dtype)):
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

    from exastencils_tpu_torch.ops.cuda import library
    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    lib, n, nc = library.load_library(), 2 ** level + 1, 2 ** (level - 1) + 1
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


# the residual check kernels (ops/cuda/check3d.py), which replace no TPU
# kernel: kernel -> wrapper
CHECKS = {"K9": "residual", "K10": "inner_sum_squares"}


def check_launches():
    """The check wrappers' launch counters by kernel."""
    from exastencils_tpu_torch.ops.cuda import check3d as c3

    return {kk: getattr(c3, fn).launches for kk, fn in CHECKS.items()}


def launch_counts(reset=False):
    """The wrappers' launch counters by kernel, optionally set to 0."""
    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    if reset:
        for fn, _ in KERNELS.values():
            getattr(s3, fn).launches = 0
    return {kk: getattr(s3, fn).launches for kk, (fn, _) in KERNELS.items()}


def drive_gen(tag, gen, drop_bound, reps, idle=True):
    """One cycle of a GeneratedSolver on the card, staged against eager.
    The solver's cycle is staged (DenseBackend.wrap): its first call warms
    up and captures the CUDA graphs, then one checked cycle replays them
    with the launch counters set to 0 just before it and read just after;
    it must equal the eager cycle (`mg.cycle`) bit for bit, and the
    residual must drop below `drop_bound` (None: not checked here).  Then
    the staged and the eager cycles are timed over `reps` cycles, and with
    `idle` the device idle share read from a profiler trace of two
    cycles.  Returns a dict of what it measured."""
    sol, rhs = gen.init_state()
    r0 = float(gen._res_norm(sol, rhs))
    eager = gen.mg.cycle(sol.clone(), rhs)  # the cycle updates its iterate in place
    staged, x = gen._cycle, sol.clone()
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
    r1 = float(gen._res_norm(s1, rhs))
    shape = gen.backend.handle(gen.knowledge.maxLevel).work_shape
    if not (np.isfinite(r1) and tuple(s1.shape) == tuple(shape)):
        raise AssertionError(f"{tag}: bad cycle output: shape {tuple(s1.shape)}, residual {r1}")
    if drop_bound is not None and not r1 < drop_bound * r0:
        raise AssertionError(f"{tag}: residual drop {r1 / r0} not below {drop_bound}")
    out = {"r0": r0, "r1": r1, "eager": eager, "launches": launches, "reads": reads,
           "staged": staged, "x": x, "rhs": rhs}
    out["ms"] = cuda_ms(lambda: staged(x, rhs), reps)
    state = {"s": sol.clone()}

    def step():
        state["s"] = gen.mg.cycle(state["s"], rhs)

    out["eager_ms"] = cuda_ms(step, reps)
    if idle:  # device idle share in a profiler trace of two cycles, as the benchmark's
        from portbench import devtrace

        def idle_share(fn):
            tr = devtrace.profile(fn, 2)
            return 1 - devtrace.busy_s(tr) / tr["wall_s"]

        out["idle"] = {"idle_share": f"{idle_share(lambda: staged(x, rhs)):.4f}",
                       "eager_idle_share": f"{idle_share(step):.4f}"}
    st = staged.stats
    STAGING[tag] = {"graphs": st.graphs, "segments": st.segments, "loops": st.loops,
                    "capture_s": round(st.capture_s, 3), "pool_bytes": st.pool_bytes}
    out["stats"] = {"graphs": st.graphs, "segments": st.segments, "loops": st.loops,
                    "capture_s": f"{st.capture_s:.3f}", "pool_bytes": st.pool_bytes}
    return out


def drive_path(tag, use_kernels, drop_bound, model_kw=None, **knowledge_kw):
    """One PoissonMGSolver V(3,3) path at 513^3 float32 on the card, as
    bench.py builds it, through drive_gen (staged against eager, launches
    counted in one replay, timed)."""
    from exastencils_tpu_torch.models.poisson import PoissonMGSolver

    k = poisson_knowledge(tpu_use_pallas=use_kernels, **knowledge_kw)
    solver = PoissonMGSolver(k, device="cuda", omega=OMEGA, n_pre=K_MAIN, n_post=K_MAIN,
                             **(model_kw or {}))
    d = drive_gen(tag if use_kernels else f"{tag}_plain", solver.gen, drop_bound,
                  10 if use_kernels else 3, idle=use_kernels)
    ms = d["ms"]
    glups = (2 ** MAIN_LEVEL + 1) ** 3 / (ms * 1e-3) / 1e9
    phase(tag, kernels=use_kernels, residual_drop=f"{d['r1'] / d['r0']:.4e}", bound=drop_bound,
          cycle_ms=f"{ms:.3f}", eager_ms=f"{d['eager_ms']:.3f}", glups=f"{glups:.4f}",
          **d.get("idle", {}), launches_per_cycle=d["launches"], staged_equals_eager=True,
          host_reads_per_cycle=d["reads"], **d["stats"])
    return ms, d["launches"], d["eager"]


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
    three event names (portbench/devtrace.profile: the trace's own first
    milliseconds, which can lose their events, hold another fn() and a
    marker kernel)."""
    from portbench import devtrace

    seen, names = {}, []
    for name, _, _ in devtrace.profile(fn, 1)["device"]:
        names.append(name[:48])
        kk = kernel_of(name)
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
    c0 = check_launches()
    r1 = res_norm()  # staged: replays of the check's graphs
    checks = {kk: n - c0[kk] for kk, n in check_launches().items()}
    if checks != dict.fromkeys(CHECKS, 1 if fastpath else 0):
        raise AssertionError(f"{tag}: check launches {checks}")
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
          launches_per_cycle=launches, check_launches=checks, **extra)
    return ms, u1, r1, u2


def check_times():
    """K9 and K10 alone at 513^3 float32 on random fields: K9 bitwise its
    plain version, K10 within 1e-5 of its plain version (it sums in double)
    and bitwise alike twice; each timed beside its bound (bytes: u, f read
    and res written; res read) and its plain version; then the whole
    finest-level check (CalcRes + ResNorm) of the bench program through the
    staged executor with the fast path (K9 + K10) and without it (the
    plain ops).  Returns {kernel: ms}."""
    from exastencils_tpu_torch.ops.cuda import check3d as c3

    A, sol, rhs, _, _ = leg_inputs(MAIN_LEVEL, torch.float32, seed=19)
    res = torch.empty_like(sol)
    nbytes = sol.numel() * sol.element_size()
    k9_ms = cuda_ms(lambda: c3.residual(sol, rhs, A, res), 20)
    bitwise = torch.equal(res, c3.residual_plain(sol, rhs, A))
    k9_plain_ms = cuda_ms(lambda: c3.residual_plain(sol, rhs, A), 3)
    k10_ms = cuda_ms(lambda: c3.inner_sum_squares(res), 20)
    s1, s2 = c3.inner_sum_squares(res), c3.inner_sum_squares(res)
    want = c3.inner_sum_squares_plain(res)
    rel = abs(float(s1) - float(want)) / float(want)
    k10_plain_ms = cuda_ms(lambda: c3.inner_sum_squares_plain(res), 3)
    if not (bitwise and torch.equal(s1, s2) and rel <= TOL[torch.float32]):
        raise AssertionError(f"check_times: K9 bitwise {bitwise}, K10 deterministic "
                             f"{torch.equal(s1, s2)}, K10 relative error {rel:.3e}")
    del sol, rhs, res
    whole = {}
    for fastpath in (True, False):
        ex = dsl_executable(BENCH_EXA4, "cuda", fastpath)
        fin = ex.hi
        calcres, resnorm = (ex.functions[(nm, fin)] for nm in ("CalcRes", "ResNorm"))
        ex.call_function(ex.functions[("InitF", fin)], fin, [])

        def check():
            ex.call_function(calcres, fin, [])
            ex.call_function(resnorm, fin, [])

        check()  # captures
        whole[fastpath] = cuda_ms(check, 10 if fastpath else 3)
        del ex
    out = {"K9": k9_ms, "K10": k10_ms}
    for kk, ms, plain_ms, by in (("K9", k9_ms, k9_plain_ms, 3 * nbytes),
                                 ("K10", k10_ms, k10_plain_ms, nbytes)):
        b_ms = by / PEAK_BYTES_S * 1e3
        phase("check_times", kernel=kk, wrapper=CHECKS[kk], level=MAIN_LEVEL, ms=f"{ms:.4f}",
              bound_ms=f"{b_ms:.4f}", bound_gb=f"{by / 1e9:.3f}",
              share_of_bound=f"{b_ms / ms:.3f}", plain_ms=f"{plain_ms:.4f}",
              **({"bitwise": bitwise} if kk == "K9" else
                 {"rel_err": f"{rel:.3e}", "deterministic": True}))
    phase("check_times_whole", level=MAIN_LEVEL, fastpath_ms=f"{whole[True]:.4f}",
          plain_ms=f"{whole[False]:.4f}", speedup=f"{whole[False] / whole[True]:.1f}")
    return out


def dsl_solve_checks():
    """The bench program at 513^3 float32, staged: Application (its
    Solve captures the graphs), then a second Solve from a zero guess, as
    the benchmark solves: the check kernels' launches in that solve must
    be one before the loop and one a cycle each, with no capture.  Then
    the solver API's float64 solve_fused at 513^3 to 1e-10 (the api
    cell's solve, twice): no check kernel launches."""
    from exastencils_tpu_torch import Knowledge
    from exastencils_tpu_torch.models.poisson import PoissonMGSolver

    lines = []
    ex = dsl_executable(BENCH_EXA4, "cuda", lines=lines)
    ex.run()
    captures = ex.stage_stats.captures
    ex.get_field("U", ex.hi).zero_()
    lines.clear()
    c0 = check_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.call_function(ex.functions[("Solve", None)], None, [])
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    got = {kk: n - c0[kk] for kk, n in check_launches().items()}
    cycles = int(lines[-1])
    if got != dict.fromkeys(CHECKS, cycles + 1) or ex.stage_stats.captures != captures:
        raise AssertionError(f"dsl_solve_checks: launches {got} in {cycles} cycles, captures "
                             f"{ex.stage_stats.captures - captures}")
    del ex
    k = Knowledge(dimensionality=3, minLevel=0, maxLevel=MAIN_LEVEL).update()
    api = PoissonMGSolver(k, device="cuda", omega=OMEGA, n_pre=K_MAIN, n_post=K_MAIN)
    c1 = check_launches()
    for _ in range(2):
        _, _, _, api_it = api.solve_fused(max_its=100, target_res_reduction=1e-10)
    torch.cuda.synchronize()
    api_got = {kk: n - c1[kk] for kk, n in check_launches().items()}
    if any(api_got.values()):
        raise AssertionError(f"dsl_solve_checks: the solver API launched {api_got}")
    phase("dsl_solve_checks", level=MAIN_LEVEL, cycles=cycles, launches_per_solve=got,
          solve_ms=f"{solve_s * 1e3:.2f}", api_f64_cycles=int(api_it),
          api_f64_launches_per_2_solves=api_got)
    return got


NORM_CHUNKS = (4, 8, 16, 32, 64)  # K13's z-chunks (planes) timed at 513^3 float64
NORM_CELLS = (("K13", "api.l9_f64"), ("K13_faces", "api_vc.l9_f64"))


def res_norm_times(chunks=NORM_CHUNKS, cycles=10, level=None):
    """K13 at 513^3 float64 on the finest level of each API cell's system
    (portbench/systems, built from the cell's configuration and traffic):
    the constant Laplacian of `api.l9_f64` and the face arrays of
    `api_vc.l9_f64`.  On seeded fields: within 1e-13 of its plain version
    (Multigrid.res_norm's plain ops), the same bits twice, timed beside its
    bound (u and f read once; the face arrays once more) and the plain
    version, at the wrapper's chunk and at each of `chunks`.  Then each of
    the cell's four right-hand sides from the cell's guess: `cycles` staged
    cycles, the norm of every iterate by the plain ops and by K13, and the
    ratios r_9/r_0 and r_10/r_0 of each (the margin from the cells' 1e-10
    that keeps their cycle count); then the cell's solve_fused, whose K13
    launches must be its cycles + 1 (on the card).  `level` replaces the
    traffic's (a rehearsal).  Returns {row: {ms, bound_ms, ...}}."""
    from pathlib import Path

    from portbench.harness import Bench
    from portbench import traffic as traffic_gen
    from exastencils_tpu_torch.ops.cuda import check3d as c3
    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    bench = Bench(Path(__file__).resolve().parent)
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    rows = {}
    for kk, cell_name in NORM_CELLS:
        cell = bench.cell(cell_name)
        cfg, cfg_dir = bench.config(cell["config"])
        tr = bench.traffic(cell["traffic"])
        tr["level"] = tr["level"] if level is None else level
        system = bench.system(cfg).System(cfg, tr["level"], DEVICE, cfg_dir)
        solver = system.solver
        mg, top = solver.mg, solver.mg.max_level
        lv = mg.levels[top]
        A = solver.stencil.bind(solver.grids[top])
        faces = s3.face_arrays(lv.shape, A) if kk == "K13_faces" else None
        if lv.res_norm_fn is None or (kk == "K13_faces") != (faces is not None):
            raise AssertionError(f"res_norm_times: {cell_name}'s finest level has no K13")
        rng = np.random.default_rng(25)
        sol, rhs = (torch.as_tensor(rng.standard_normal(lv.shape), device=DEVICE)
                    for _ in range(2))

        def plain(s, r):
            return lv.norm_fn(mg.residual(top, s, r))

        got = [c3.res_norm(sol, rhs, A, faces) for _ in range(2)]
        want = plain(sol, rhs)
        rel = abs(float(got[0]) - float(want)) / float(want)
        same = torch.equal(got[0], got[1]) and torch.equal(got[0], lv.res_norm_fn(sol, rhs))
        if not (same and rel <= 1e-13):
            raise AssertionError(f"res_norm_times: {kk} deterministic {same}, rel {rel:.3e}")
        ms = cuda_ms(lambda: c3.res_norm(sol, rhs, A, faces), 20)
        by_chunk = {ch: cuda_ms(lambda: c3.res_norm(sol, rhs, A, faces, chunk=ch), 20)
                    for ch in chunks}
        plain_ms = cuda_ms(lambda: plain(sol, rhs), 3)
        by = (sol.numel() * 2 + (sum(f.numel() for f in faces) if faces else 0)) * 8
        b_ms = by / PEAK_BYTES_S * 1e3
        chunk = c3.res_chunk(lv.shape, 8, _sm_count(), c3.NORM_CHUNK_BYTES)
        rows[kk] = {"ms": ms, "bound_ms": b_ms, "plain_ms": plain_ms}
        phase("res_norm_times", kernel=kk, cell=cell_name, level=top, dtype="float64",
              ms=f"{ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_gb=f"{by / 1e9:.3f}",
              share_of_bound=f"{b_ms / ms:.3f}", plain_ms=f"{plain_ms:.4f}",
              rel_err=f"{rel:.3e}", deterministic=same, chunk=chunk,
              blocks=c3.norm_blocks(lv.shape, chunk),
              **{f"ms_chunk{ch}": f"{t:.4f}" for ch, t in by_chunk.items()})
        del sol, rhs, got
        ratios = []
        for b in traffic_gen.bank(tr, 25, torch.float64, DEVICE):
            system.load(b)
            x, f = system.x, system.rhs
            r = [(float(plain(x, f)), float(lv.res_norm_fn(x, f)))]
            for _ in range(cycles):
                x = solver._cycle(x, f)
                r.append((float(plain(x, f)), float(lv.res_norm_fn(x, f))))
            ratios.append({"r9_plain": r[9][0] / r[0][0], "r9_k13": r[9][1] / r[0][1],
                           "r10_plain": r[10][0] / r[0][0], "r10_k13": r[10][1] / r[0][1]})
        system.solve()  # captures the cell's solve_fused
        system.load(b)
        n0 = c3.res_norm.launches
        sync()
        t0 = time.perf_counter()
        it = system.solve()
        sync()
        solve_ms = (time.perf_counter() - t0) * 1e3
        if DEVICE == "cuda" and c3.res_norm.launches - n0 != it + 1:
            raise AssertionError(f"res_norm_times: {c3.res_norm.launches - n0} K13 launches "
                                 f"in a solve of {it} cycles")
        phase("res_norm_ratios", kernel=kk, cell=cell_name, cycles=cycles, solve_cycles=it,
              solve_ms=f"{solve_ms:.3f}", launches_per_solve=it + 1,
              **{f"rhs{i}": ",".join(f"{k}:{v:.6e}" for k, v in q.items())
                 for i, q in enumerate(ratios)})
        rows[kk]["ratios"] = ratios
        del system, solver, mg, lv, A, faces
        torch.cuda.empty_cache()
    return rows


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


def varcoeff_kappa(x, y, z):
    """The variable-coefficient benchmark cell's kappa (portbench
    configs/poisson3d_varcoeff_api_f64.json: kappa0 = 10)."""
    return torch.exp(10.0 * (x - x * x) * (y - y * y) * (z - z * z))


def varcoeff_path():
    """K11/K12 (legs3d.cu leg_kernel's face-array build) on the finest level
    of the variable-coefficient Poisson3D (PoissonMGSolver(kappa_fn=...) at 513^3
    float64, V(3,3), as the benchmark's api_vc cell solves it): each leg
    at K=3 on seeded fields, its smoothed sol bitwise the plain sweeps',
    K11's coarse rhs bitwise K4's restriction of the plain residual, K12
    bitwise K5 then the plain sweeps, both within the K1/K2 tolerance of
    the plain legs, timed beside its bound (the leg's bytes plus its three face arrays,
    each read once) and its plain version; K1/K2 on the constant
    Laplacian timed alike.  Then the solver itself, staged: a cycle's and a
    residual norm's device ms, and a solve_fused's cycles, ms and
    K11/K12 launches per cycle.  Returns the K11/K12 rows of the kernel
    table."""
    from exastencils_tpu_torch import Knowledge
    from exastencils_tpu_torch.core.grid import NODE
    from exastencils_tpu_torch.core.stencil import (BoundStencil, node_prolongation,
                                                    node_restriction)
    from exastencils_tpu_torch.models.poisson import PoissonMGSolver, laplace_stencil
    from exastencils_tpu_torch.ops.cuda import stream3d as s3
    from exastencils_tpu_torch.ops.stencil_apply import apply_stencil
    from exastencils_tpu_torch.ops.transfer import separable_kernels

    dt = torch.float64
    k = Knowledge(dimensionality=3, minLevel=0, maxLevel=MAIN_LEVEL, useDblPrecision=True).update()
    solver = PoissonMGSolver(k, device="cuda", omega=OMEGA, n_pre=K_MAIN, n_post=K_MAIN,
                             kappa_fn=varcoeff_kappa)
    grid = solver.grids[MAIN_LEVEL]
    A, L = solver.stencil.bind(grid), laplace_stencil(3).bind(grid)
    shape = tuple(grid.shape_of(NODE))
    cshape = tuple(solver.grids[MAIN_LEVEL - 1].shape_of(NODE))
    faces = s3.face_arrays(shape, A)
    if faces is None:
        raise AssertionError("varcoeff_path: the level's stencil is outside K11/K12's contract")
    R, P = node_restriction(3), node_prolongation(3)
    rk, pk = separable_kernels(R), separable_kernels(P)
    rng = np.random.default_rng(23)
    sol, rhs = (torch.as_tensor(rng.standard_normal(shape), device="cuda") for _ in range(2))
    sol_c = torch.as_tensor(rng.standard_normal(cshape), device="cuda")
    s_got, rc_got = s3.smooth_res_restrict_faces(sol.clone(), rhs, A, faces, OMEGA, K_MAIN, rk,
                                                 R.lo, cshape)
    u_got = s3.prolong_correct_smooth_faces(sol.clone(), sol_c, rhs, A, faces, OMEGA, K_MAIN, pk,
                                            P.lo)
    s_ref = s3.rbgs_fused_plain(sol, rhs, A, OMEGA, K_MAIN)
    # K11's coarse rhs is K4's restriction of the plain residual: with a zero
    # sol, K4 on any constant star restricts its rhs as given
    res = torch.zeros_like(sol)
    res[1:-1, 1:-1, 1:-1] = (rhs - apply_stencil(A, s_ref))[1:-1, 1:-1, 1:-1]
    rc_k4 = s3.res_restrict(torch.zeros_like(sol), res, BoundStencil("A", s3.STAR_OFFSETS, (
        6.5, -0.9, -1.1, -0.7, -1.3, -0.95, -1.05)), rk, R.lo, cshape)
    del res
    same = {"K11_sol": torch.equal(s_got, s_ref), "K11_coarse_rhs": torch.equal(rc_got, rc_k4),
            "K12_sol": torch.equal(u_got, s3.rbgs_fused_plain(
                s3.prolong_correct(sol.clone(), sol_c, pk, P.lo), rhs, A, OMEGA, K_MAIN))}
    del s_ref, rc_k4
    _, rc_ref = s3.smooth_res_restrict_plain(sol, rhs, A, OMEGA, K_MAIN, rk, R.lo, cshape)
    u_ref = s3.prolong_correct_smooth_plain(sol, sol_c, rhs, A, OMEGA, K_MAIN, pk, P.lo)
    e_rc, e_u = rel_err(rc_got, rc_ref), rel_err(u_got, u_ref)
    same["K11_coarse_rhs_vs_plain"] = tol_ok("K1", e_rc, dt)
    same["K12_vs_plain"] = tol_ok("K2", e_u, dt)
    phase("varcoeff_compare", level=MAIN_LEVEL, dtype="float64", K=K_MAIN,
          k11_coarse_rel=f"{e_rc[1]:.3e}", k12_rel=f"{e_u[1]:.3e}", tol=tol_of(dt), **same)
    if not all(same.values()):
        raise AssertionError(f"varcoeff_path: K11/K12 against the plain legs {same}")
    del s_got, rc_got, u_got, rc_ref, u_ref
    w = sol.clone()
    ms = {"K11": cuda_ms(lambda: s3.smooth_res_restrict_faces(w, rhs, A, faces, OMEGA, K_MAIN,
                                                              rk, R.lo, cshape), 5),
          "K12": cuda_ms(lambda: s3.prolong_correct_smooth_faces(w, sol_c, rhs, A, faces, OMEGA,
                                                                 K_MAIN, pk, P.lo), 5),
          "K1": cuda_ms(lambda: s3.smooth_res_restrict(w, rhs, L, OMEGA, K_MAIN, rk, R.lo,
                                                       cshape), 5),
          "K2": cuda_ms(lambda: s3.prolong_correct_smooth(w, sol_c, rhs, L, OMEGA, K_MAIN, pk,
                                                          P.lo), 5)}
    plain = {"K11": cuda_ms(lambda: s3.smooth_res_restrict_plain(w, rhs, A, OMEGA, K_MAIN, rk,
                                                                 R.lo, cshape), 1),
             "K12": cuda_ms(lambda: s3.prolong_correct_smooth_plain(w, sol_c, rhs, A, OMEGA,
                                                                    K_MAIN, pk, P.lo), 1)}
    del w
    chain = {kk: len(s3.leg_chain(m, K_MAIN, dt, r)) for kk, m, r in (
        ("K11", s3.LEG_RESTRICT, 1), ("K1", s3.LEG_RESTRICT, 1), ("K12", s3.LEG_PROLONG, 0),
        ("K2", s3.LEG_PROLONG, 0))}
    n, nc = shape[0], cshape[0]
    leg_bytes = (3 * n ** 3 + nc ** 3) * 8
    face_bytes = sum(f.numel() for f in faces) * 8
    rows = {}
    for kk in ("K11", "K12", "K1", "K2"):
        by = leg_bytes + (face_bytes if kk in ("K11", "K12") else 0)
        b_ms = by / PEAK_BYTES_S * 1e3
        rows[kk] = {"ms": ms[kk], "bound_ms": b_ms, "plain_ms": plain.get(kk)}
        phase("varcoeff_leg_times", kernel=kk, level=MAIN_LEVEL, dtype="float64", K=K_MAIN,
              ms=f"{ms[kk]:.4f}", bound_ms=f"{b_ms:.4f}", share_of_bound=f"{b_ms / ms[kk]:.4f}",
              launches_per_call=chain[kk],
              **({"plain_ms": f"{plain[kk]:.4f}"} if kk in plain else {}))
    del sol, rhs, sol_c
    x, f = solver.init_state()
    x0 = x.clone()
    cycle, res_norm = solver.mg.staged("cycle"), solver.mg.staged("res_norm")
    cycle_ms = cuda_ms(lambda: cycle(x, f), 5)
    check_ms = cuda_ms(lambda: res_norm(x, f), 5)
    x.copy_(x0)
    solver.solve_fused(max_its=100, target_res_reduction=1e-10, state=(x, f))  # captures
    x.copy_(x0)
    n0 = (s3.smooth_res_restrict_faces.launches, s3.prolong_correct_smooth_faces.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, init, cur, it = solver.solve_fused(max_its=100, target_res_reduction=1e-10, state=(x, f))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    it = int(it)
    per_cycle = ((s3.smooth_res_restrict_faces.launches - n0[0]) / it,
                 (s3.prolong_correct_smooth_faces.launches - n0[1]) / it)
    legs = sum(lv.down_leg_fn is not None for lv in solver.levels.values())
    if not (float(cur) <= 1e-10 * float(init) and per_cycle == (legs * chain["K11"],
                                                                  legs * chain["K12"])):
        raise AssertionError(f"varcoeff_path: {init} -> {cur} in {it}, launches {per_cycle}")
    phase("varcoeff_path", level=MAIN_LEVEL, dtype="float64", levels_with_legs=legs, cycles=it,
          residual=f"{float(cur):.6e}", solve_ms=f"{solve_s * 1e3:.3f}",
          cycle_ms=f"{cycle_ms:.3f}", res_norm_ms=f"{check_ms:.3f}",
          K11_launches_per_cycle=per_cycle[0], K12_launches_per_cycle=per_cycle[1])
    rows["K11"]["launches"], rows["K12"]["launches"] = per_cycle
    return {kk: rows[kk] for kk in ("K11", "K12")}


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


# ----------------------------------------------------------------------
# the single-device breadth of the solver API: coarse Krylov solvers, a
# cell field, a stretched grid, the numpy embedding API, field IO and the
# performance estimate (all float32, staged cycles bit for bit the eager)
# ----------------------------------------------------------------------

DEVICE = "cuda"  # the new phases' device (a CPU rehearsal points it at "cpu")
CGS_MIN_LEVEL = 4  # 17^3 coarsest nodes: the coarse Krylov loop iterates
CGS_RESTART = 8  # BiCGStab: solver_cgs_restartAfter
CGS_SOLVERS = ("CG", "BiCGStab", "MinRes", "ConjugateResidual")
# cell_path: the JAX package's cell hierarchy (cell transfers on the dense
# backend's node-shaped arrays) converges only when shallow; with one
# coarse level (CG on 257^3) its per-cycle rate, float64 on the CPU with
# tpu_use_pallas=False, after the first cycle, reads 0.34 / 0.42 / 0.50 /
# 0.55 at levels 4-7 (cycle 6), the first cycle raising the residual from
# level 6 on (0.92, 1.67): bound the sixth cycle's rate at 0.75 (~0.62
# extrapolated to level 9, plus 0.13) and the six cycles' drop below 1
CELL_CYCLES = 6
CELL_RATE_BOUND = 0.75
# nonuniform_path: the first cycle's drop, float64 CPU JAX plain, with the
# stretched Laplacian: 0.076 / 0.124 / 0.192 / 0.260 at levels 4-7 (+0.07 a
# level, ~0.40 at level 9); bound 0.6, and three cycles below 0.1 (level 7:
# 0.0055)
NONUNI_DROP_BOUND = 0.6
NONUNI_CYCLES = 3
NONUNI_TOTAL_BOUND = 0.1
# export_path: max error of the 513^3 float32 solution against the exact
# one (h^2-small, ~4e-5 at h = 1/512, plus float32 rounding)
EXPORT_ERR_BOUND = 1e-2
IO_LEVEL = 7  # 129^3 round trips
IO_PRINT_LEVEL = 5  # 33^3 printField / printVtk


def poisson_knowledge(**kw):
    """bench.py's Poisson3D Knowledge (levels 0-9, float32), with `kw` over it."""
    from exastencils_tpu_torch import Knowledge

    base = dict(dimensionality=3, minLevel=0, maxLevel=MAIN_LEVEL, useDblPrecision=False,
                tpu_compute_dtype="float32")
    return Knowledge(**{**base, **kw}).update()


def path_phase(tag, d, drop_bound, **extra):
    phase(tag, residual_drop=f"{d['r1'] / d['r0']:.4e}", bound=drop_bound,
          cycle_ms=f"{d['ms']:.3f}", eager_ms=f"{d['eager_ms']:.3f}", **d.get("idle", {}),
          launches_per_cycle=d["launches"], staged_equals_eager=True,
          host_reads_per_cycle=d["reads"], **d["stats"], **extra)


def cgs_paths(per_level):
    """main_path's problem (513^3, RBGS V(3,3)) with minLevel 4, once per
    coarse Krylov solver (BiCGStab with restarts), through drive_gen: K1/K2
    on levels 5-9, drop < 0.1.  With LOOP_CHUNK 1 the staged cycle reads
    the coarse loop's done flag once per iteration, so its host reads are
    the coarse iterations of the checked cycle.  Returns ms by solver."""
    from exastencils_tpu_torch.models.poisson import PoissonMGSolver
    from exastencils_tpu_torch.runtime import staging

    want = {**dict.fromkeys(KERNELS, 0),
            **{kk: (MAIN_LEVEL - CGS_MIN_LEVEL) * v for kk, v in per_level.items()}}
    out = {}
    for cgs in CGS_SOLVERS:
        k = poisson_knowledge(minLevel=CGS_MIN_LEVEL, solver_cgs_restart=cgs == "BiCGStab",
                              solver_cgs_restartAfter=CGS_RESTART)
        solver = PoissonMGSolver(k, device=DEVICE, omega=OMEGA, n_pre=K_MAIN, n_post=K_MAIN,
                                 cgs=cgs)
        tag = f"cgs_{cgs}"
        d = drive_gen(tag, solver.gen, 0.1, 10)
        if d["launches"] != want:
            raise AssertionError(f"{tag}: launches per cycle {d['launches']}, expected {want}")
        if staging.LOOP_CHUNK != 1 or not d["reads"] > 1:
            raise AssertionError(f"{tag}: {d['reads']} coarse iterations: the loop does not iterate")
        path_phase(tag, d, 0.1, restart=k.solver_cgs_restart, coarse_iterations=d["reads"])
        out[cgs] = d["ms"]
        del solver, d
    phase("cgs_paths", **{f"{c}_ms": f"{v:.3f}" for c, v in out.items()})
    return out


def residuals_over(gen, d, cycles):
    """The residual norms from the initial state through `cycles` staged
    cycles, replayed on drive_gen's bound iterate."""
    x, rhs, staged = d["x"], d["rhs"], d["staged"]
    x.copy_(gen.init_state()[0])
    res = [float(gen._res_norm(x, rhs))]
    for _ in range(cycles):
        staged(x, rhs)
        res.append(float(gen._res_norm(x, rhs)))
    return res


def cell_path():
    """A cell-centred Dirichlet Poisson on 512^3 cells (the dense backend's
    513^3 arrays) from generate_solver with the kernels requested (the
    default Knowledge): the makers decline a cell field, so no kernel
    launches; staged cycle bit for bit the eager one; then CELL_CYCLES
    cycles from the start, bounded as CELL_RATE_BOUND says."""
    from exastencils_tpu_torch.core.domain import unit_domain
    from exastencils_tpu_torch.core.field import DirichletBC, Field
    from exastencils_tpu_torch.core.grid import CELL, level_grids
    from exastencils_tpu_torch.models.poisson import default_rhs_3d, laplace_stencil
    from exastencils_tpu_torch.parallel.backend import DenseBackend
    from exastencils_tpu_torch.solver.synthesis import Equation, generate_solver

    k = poisson_knowledge(minLevel=MAIN_LEVEL - 1)
    if not k.tpu_use_pallas:
        raise AssertionError("cell_path: the default Knowledge requests the kernels")
    dom = unit_domain(3)
    grids = level_grids(dom, k, DEVICE)
    u = Field("u", dom, CELL, bc=DirichletBC(0.0))
    gen = generate_solver(Equation(u, laplace_stencil(3), rhs_fn=default_rhs_3d), k,
                          DenseBackend(grids), grids,
                          options={"smoother": "RBGS", "smoother_damping": OMEGA,
                                   "smoother_numPre": K_MAIN, "smoother_numPost": K_MAIN})
    d = drive_gen("cell_path", gen, None, 3)
    if any(d["launches"].values()):
        raise AssertionError(f"cell_path: a kernel ran for a cell field: {d['launches']}")
    res = residuals_over(gen, d, CELL_CYCLES)
    rates = [res[i + 1] / res[i] for i in range(CELL_CYCLES)]
    if not (np.all(np.isfinite(res)) and rates[-1] < CELL_RATE_BOUND and res[-1] < res[0]):
        raise AssertionError(f"cell_path: residuals {res}")
    path_phase("cell_path", d, None, cells=f"{2 ** MAIN_LEVEL}^3", rate_bound=CELL_RATE_BOUND,
               rates=[f"{r:.4f}" for r in rates], drop_over_cycles=f"{res[-1] / res[0]:.4e}")


def nonuniform_path():
    """A 3D linearFct (stretched) grid at 513^3 with the stretched
    Laplacian (variable coefficients, so the plain ops; the kernels are
    requested and decline), staged against eager, then NONUNI_CYCLES
    cycles from the start."""
    from exastencils_tpu_torch.core.domain import unit_domain
    from exastencils_tpu_torch.core.field import DirichletBC, Field
    from exastencils_tpu_torch.core.grid import NODE, level_grids
    from exastencils_tpu_torch.models.poisson import default_rhs_3d, stretched_laplace_stencil
    from exastencils_tpu_torch.parallel.backend import DenseBackend
    from exastencils_tpu_torch.solver.synthesis import Equation, generate_solver

    k = poisson_knowledge(grid_spacingModel="linearFct", grid_isUniform=False)
    dom = unit_domain(3)
    grids = level_grids(dom, k, DEVICE)
    u = Field("u", dom, NODE, bc=DirichletBC(0.0))
    gen = generate_solver(Equation(u, stretched_laplace_stencil(3), rhs_fn=default_rhs_3d), k,
                          DenseBackend(grids), grids,
                          options={"smoother": "RBGS", "smoother_damping": OMEGA,
                                   "smoother_numPre": K_MAIN, "smoother_numPost": K_MAIN})
    d = drive_gen("nonuniform_path", gen, NONUNI_DROP_BOUND, 3)
    if any(d["launches"].values()):
        raise AssertionError(f"nonuniform_path: a kernel ran: {d['launches']}")
    res = residuals_over(gen, d, NONUNI_CYCLES)
    if not res[-1] < NONUNI_TOTAL_BOUND * res[0]:
        raise AssertionError(f"nonuniform_path: residuals {res}")
    w = grids[MAIN_LEVEL].cell_widths_1d(0)
    path_phase("nonuniform_path", d, NONUNI_DROP_BOUND,
               drop_over_cycles=f"{res[-1] / res[0]:.4e}", total_bound=NONUNI_TOTAL_BOUND,
               width_ratio=f"{float(w.max() / w.min()):.3f}")


def export_path():
    """ExportedSolver at 513^3 float32, numpy in and out: a cold solve (its
    first call captures), the same solve again (replays), a warm start
    from a partly converged solution; the caller's arrays unchanged; then `step`
    under the donation contract (it writes into the iterate it is given
    and returns it).  Prints the copy-in, solve and copy-out ms."""
    from exastencils_tpu_torch.models.poisson import PoissonMGSolver

    solver = PoissonMGSolver(poisson_knowledge(), device=DEVICE, omega=OMEGA, n_pre=K_MAIN,
                             n_post=K_MAIN)
    ex = solver.gen.export()
    n = ex.shape[0]
    c = np.linspace(0.0, 1.0, n)
    x, y, z = c[:, None, None], c[None, :, None], c[None, None, :]
    pi2 = np.pi ** 2
    rhs = np.broadcast_to(pi2 * np.cos(np.pi * x) - 4.0 * pi2 * np.sin(2.0 * np.pi * y)
                          + 9.0 * pi2 * np.cos(3.0 * np.pi * z), ex.shape).copy()
    exact = np.cos(np.pi * x) - np.sin(2.0 * np.pi * y) + np.cos(3.0 * np.pi * z)
    keep = rhs.copy()
    times = {}
    for run in ("cold", "replayed"):
        sol, it, rel = ex.solve(rhs, target_res_reduction=1e-5, max_its=20)
        times[run] = dict(ex.last_seconds)
    err = float(np.abs(sol.astype(np.float64) - exact).max())
    # a warm start from a partly converged iterate (a converged float32 one
    # sits at the rounding floor): one more cycle reduces its residual ~12x
    u0, _, _ = ex.solve(rhs, target_res_reduction=1e-2, max_its=20)
    keep_u0 = u0.copy()
    warm, it_warm, rel_warm = ex.solve(rhs, u0=u0, target_res_reduction=1e-1, max_its=3)
    if not (np.array_equal(rhs, keep) and np.array_equal(u0, keep_u0)):
        raise AssertionError("export_path: the caller's arrays changed")
    if not (sol.shape == ex.shape and sol.dtype == np.float32 and rel <= 1e-5 and it <= 20
            and err < EXPORT_ERR_BOUND and rel_warm <= 1e-1):
        raise AssertionError(f"export_path: {sol.shape} {sol.dtype} it {it} rel {rel} "
                             f"err {err} warm {rel_warm}")
    s0, rhs_t = solver.init_state()
    r0 = float(ex.residual_norm(s0.clone(), rhs_t))
    s = s0.clone()
    s1 = ex.step(s, rhs_t)
    r1 = float(ex.residual_norm(s1.clone(), rhs_t))
    if not (s1 is s and r1 < 0.1 * r0):
        raise AssertionError(f"export_path: step returned its iterate {s1 is s}, drop {r1 / r0}")
    ms = {f"{run}_{k}_ms": f"{v * 1e3:.3f}" for run, t in times.items() for k, v in t.items()}
    phase("export_path", cycles=it, rel_residual=f"{rel:.3e}", max_error=f"{err:.3e}",
          warm_cycles=it_warm, warm_rel_residual=f"{rel_warm:.3e}",
          callers_arrays_unchanged=True, step_returns_its_iterate=True,
          step_drop=f"{r1 / r0:.4e}", **ms)


IO_L4 = """
Domain global< [0.0, 0.0] to [1.0, 1.0] >
Layout NodeNoComm< Real, Node >@all {
  duplicateLayers = [1, 1]
  ghostLayers     = [0, 0]
}
Field u< global, NodeNoComm, 0.0 >@all
Field w< global, NodeNoComm, 0.0 >@all

Function Application ( ) : Unit {
  loop over u@finest {
    u@finest = vf_nodePos_x + 2.0 * vf_nodePos_y
  }
  writeField ( "DIR/a.npy", u@finest )
  writeField_lock ( "DIR/b.csv", u@finest )
  writeField_mpiio ( "DIR/c.bin", u@finest )
  writeField_nc ( "DIR/d.nc", "u", u@finest )
  writeField_sion ( "DIR/e.sion", u@finest )
  printField ( "DIR/f.txt", u@finest )
  printVtk ( "DIR/g.vtk", u@finest )
  readField_mpiio ( "DIR/c.bin", w@finest )
  Var s : Real = 0.0
  loop over w@finest with reduction ( + : s ) {
    s += ( w@finest - u@finest ) * ( w@finest - u@finest )
  }
  print ( s )
}
"""
IO_L4_FILES = ("a.npy", "b.csv", "c.bin", "d.nc", "e.sion", "f.txt", "g.vtk")


def io_cli(d):
    """IO_L4 through `python -m exastencils_tpu_torch` on the card and with
    --cpu: each prints 0 (the read-back equals the field) and the two
    write the same bytes (the positions are exact binary fractions, so
    both devices compute the same values)."""
    out = {}
    for dev in ("cuda", "cpu"):
        sub = os.path.join(d, dev)
        os.makedirs(sub)
        prog, settings, knowledge = (os.path.join(sub, f) for f in ("io.exa4", "io.settings",
                                                                    "io.knowledge"))
        with open(prog, "w") as f:
            f.write(IO_L4.replace("DIR", sub))
        with open(settings, "w") as f:
            f.write(f'l4file = "{prog}"\n')
        with open(knowledge, "w") as f:
            f.write("dimensionality = 2\nminLevel = 0\nmaxLevel = 5\n")
        run = subprocess.run([sys.executable, "-m", "exastencils_tpu_torch", settings, knowledge]
                             + (["--cpu"] if dev == "cpu" else []), capture_output=True,
                             text=True, timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
        if run.returncode != 0 or run.stdout.split() != ["0"]:
            raise AssertionError(f"io_cli {dev}: rc {run.returncode}\n{run.stdout}\n"
                                 f"{run.stderr[-2000:]}")
        out[dev] = {name: open(os.path.join(sub, name), "rb").read() for name in IO_L4_FILES}
    if out["cuda"] != out["cpu"]:
        raise AssertionError("io_cli: the card's files differ from the CPU's")
    return len(IO_L4_FILES)


def io_phase():
    """Every field IO backend the machine can run, round trip at 129^3
    float32 from a tensor on the card (the read-back bitwise on the card);
    hdf5 where h5py is installed; printField and printVtk at 33^3, each
    file byte for byte the CPU copy's; the IO builtins through the CLI."""
    import tempfile

    from exastencils_tpu_torch.core.domain import unit_domain
    from exastencils_tpu_torch.core.grid import NODE, level_grids
    from exastencils_tpu_torch.runtime import fieldio as fio
    from exastencils_tpu_torch.runtime.vtk import print_vtk

    n = 2 ** IO_LEVEL + 1
    t = torch.from_numpy(np.random.default_rng(7).standard_normal((n,) * 3).astype(np.float32))
    t = t.to(DEVICE)
    like = torch.zeros_like(t)
    ms, not_run = {}, []
    with tempfile.TemporaryDirectory() as d:
        def p(name):
            return os.path.join(d, name)

        backends = {
            "npy": (lambda: fio.write_field(p("f"), t), lambda: fio.read_field(p("f.npy"), like)),
            "bin": (lambda: fio.write_field(p("f.bin"), t, fmt="bin"),
                    lambda: fio.read_field(p("f.bin"), like, fmt="bin")),
            "txt": (lambda: fio.write_field(p("f.txt"), t, fmt="txt"),
                    lambda: fio.read_field(p("f.txt"), like, fmt="txt")),
            "lock": (lambda: fio.write_field_lock(p("f.csv"), t),
                     lambda: fio.read_field_lock(p("f.csv"), like)),
            "lock_binary": (lambda: fio.write_field_lock(p("f.lock"), t, binary=True),
                            lambda: fio.read_field_lock(p("f.lock"), like, binary=True)),
            "fpp": (lambda: fio.write_field_fpp(p("f_$blockId"), t),
                    lambda: fio.read_field_fpp(p("f_$blockId"), like)),
            "mpiio": (lambda: fio.write_field_mpiio(p("f.mpiio"), t),
                      lambda: fio.read_field_mpiio(p("f.mpiio"), like)),
            "nc": (lambda: fio.write_field_nc(p("f.nc"), "u", t),
                   lambda: fio.read_field_nc(p("f.nc"), "u", like)),
            "sion": (lambda: fio.write_field_sion(p("f.sion"), t),
                     lambda: fio.read_field_sion(p("f.sion"), like)),
        }
        try:
            import h5py  # noqa: F401

            backends["hdf5"] = (lambda: fio.write_field_hdf5(p("f.h5"), "/u", t),
                                lambda: fio.read_field_hdf5(p("f.h5"), "/u", like))
        except ImportError:
            not_run.append("hdf5 (h5py not installed)")
        for name, (write, read) in backends.items():
            t0 = time.perf_counter()
            write()
            t1 = time.perf_counter()
            back = read()
            if back.is_cuda:
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            if not (back.device == t.device and back.dtype == t.dtype and torch.equal(back, t)):
                raise AssertionError(f"io_phase {name}: the read-back differs")
            ms[name] = f"{(t1 - t0) * 1e3:.1f}/{(t2 - t1) * 1e3:.1f}"
        k = poisson_knowledge(minLevel=IO_PRINT_LEVEL, maxLevel=IO_PRINT_LEVEL)
        m = 2 ** IO_PRINT_LEVEL + 1
        small = t[:m, :m, :m].contiguous()
        grid = {dev: level_grids(unit_domain(3), k, dev)[IO_PRINT_LEVEL] for dev in (DEVICE, "cpu")}
        for dev, arr in ((DEVICE, small), ("cpu", small.cpu())):
            fio.print_field(p(f"pf_{dev}.txt"), arr)
            print_vtk(p(f"vtk_{dev}.vtk"), {"u": arr}, grid[dev], NODE)
        same = all(open(p(f"{kind}_{DEVICE}.{ext}"), "rb").read()
                   == open(p(f"{kind}_cpu.{ext}"), "rb").read()
                   for kind, ext in (("pf", "txt"), ("vtk", "vtk")))
        if not same:
            raise AssertionError("io_phase: printField/printVtk from the card differ from the CPU's")
        t0 = time.perf_counter()
        files = io_cli(d)
        cli_s = time.perf_counter() - t0
    phase("io_phase", level=IO_LEVEL, ran=sorted(ms), not_run=not_run,
          write_read_ms=ms, print_field_vtk_equal_cpu=True, print_level=IO_PRINT_LEVEL,
          dsl_cli_files_equal_cpu=files, dsl_cli_seconds=f"{cli_s:.2f}")


def perf_estimate():
    """performance_printEstimation on the card: one logged line per level
    of a 513^3 solver, at detect_chip()'s bandwidth (h100: the measured
    triad)."""
    import logging

    from exastencils_tpu_torch.models.poisson import PoissonMGSolver
    from exastencils_tpu_torch.runtime.performance import HBM_BANDWIDTH, detect_chip

    chip = detect_chip()
    lines = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: lines.append(record.getMessage())
    log = logging.getLogger("exastencils_tpu_torch")
    level = log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        PoissonMGSolver(poisson_knowledge(performance_printEstimation=True), device=DEVICE)
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    if chip != "h100" or len(lines) != MAIN_LEVEL + 1:
        raise AssertionError(f"perf_estimate: chip {chip!r}, {len(lines)} lines")
    for line in lines:
        print(f"[perf_estimate] {line}", flush=True)
    phase("perf_estimate", chip=chip, bandwidth_B_s=HBM_BANDWIDTH[chip], lines=len(lines))


# The sharded path (parallel/): ranks spawned on the one card
SHARD_DIMS = (2, 2, 2)
SHARDED_CYCLES = 5  # timed cycles of sharded_path
SHARDED_LINES_LEVEL, SHARDED_LINES_CYCLES = 6, 10  # the f64 solve whose lines are compared
WORLD1_CYCLES = 5  # cycles of the one-rank NCCL solve whose lines are compared
# sharded_path at 513^3 over 2x2x2, per rank and cycle: K1/K2 on levels
# 9-7 (their coarse levels sharded), K3 pre- and post-smoothing on level 6
# (level 5 is replicated below tpu_coarse_replicate_threshold's 32 cells
# per shard), one launch each at K = 3 in float32
SHARDED_LAUNCHES = {"K1": 3, "K2": 3, "K3": 2}


def sharded_solver(device, dims, **knowledge_kw):
    """This rank's PoissonMGSolver V(3,3) on a mesh of `dims` ranks, with
    the kernels."""
    from exastencils_tpu_torch.models.poisson import PoissonMGSolver
    from exastencils_tpu_torch.parallel.mesh import make_domain_mesh

    k = poisson_knowledge(tpu_use_pallas=True, **knowledge_kw)
    return PoissonMGSolver(k, device, omega=OMEGA, n_pre=K_MAIN, n_post=K_MAIN,
                           mesh=make_domain_mesh(dims), shard_dims=dims)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sharded_path_rank(device, level, lines_level):
    """One rank of sharded_path: the 513^3 float32 V(3,3) solver on its
    2x2x2 fragment.  One cycle with the launch counters set to 0 just
    before and read just after; SHARDED_CYCLES cycles timed on rank 0 with
    CUDA events between barriers, then again with the exchange timed (the
    card synchronised around every exchange); then the float64 level-6
    solve's lines."""
    import torch.distributed as dist

    solver = sharded_solver(device, SHARD_DIMS, maxLevel=level)
    topo, gen = solver.backend.topo, solver.gen
    sol, rhs = gen.init_state()
    r0 = float(gen._res_norm(sol, rhs))
    launch_counts(reset=True)
    sol = gen._cycle(sol, rhs)
    _sync(device)
    launches = {kk: v for kk, v in launch_counts().items() if v}
    r1 = float(gen._res_norm(sol, rhs))
    shape_ok = tuple(sol.shape) == tuple(solver.backend.handle(level).work_shape)
    finite = bool(torch.isfinite(sol).all())

    def timed_cycles():
        """(device ms per cycle from CUDA events, or host ms on the CPU;
        host seconds of all cycles)."""
        nonlocal sol
        dist.barrier()
        _sync(device)
        cuda = device.type == "cuda"
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(SHARDED_CYCLES):
            sol = gen._cycle(sol, rhs)
        if cuda:
            end.record()
        _sync(device)
        wall = time.perf_counter() - t0
        dist.barrier()
        ms = start.elapsed_time(end) if cuda else wall * 1e3
        return ms / SHARDED_CYCLES, wall

    cycle_ms, _ = timed_cycles()
    calls0, bytes0 = topo.stats.calls, topo.stats.bytes_sent
    topo.stats.timed, topo.stats.seconds = True, 0.0
    timed_ms, wall = timed_cycles()
    topo.stats.timed = False
    exchange = {"share": topo.stats.seconds / wall, "timed_cycle_ms": timed_ms,
                "per_cycle": (topo.stats.calls - calls0) / SHARDED_CYCLES,
                "bytes_per_cycle": (topo.stats.bytes_sent - bytes0) / SHARDED_CYCLES}
    del sol, rhs, solver, gen
    if device.type == "cuda":
        torch.cuda.empty_cache()
    small = sharded_solver(device, SHARD_DIMS, maxLevel=lines_level,
                           useDblPrecision=True, tpu_compute_dtype="float64")
    lines = small.solve(max_its=SHARDED_LINES_CYCLES, target_res_reduction=1e-10)[1]
    return {"rank": dist.get_rank(), "coords": topo.mesh.coords, "transport": topo.mesh.backend,
            "r0": r0, "r1": r1, "launches": launches, "cycle_ms": cycle_ms,
            "exchange": exchange, "lines": lines, "shape_ok": shape_ok, "finite": finite,
            "replicated": sorted(small.backend.replicated),
            "jax": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "exastencils_tpu"))}


def world1_rank(device, level):
    """The one rank of sharded_world1_nccl: the 513^3 float32 solver on a
    1x1x1 mesh (no ghosts; excl planes on all six sides; NCCL all-reduces)
    solving WORLD1_CYCLES cycles, its launches per cycle and its lines."""
    import torch.distributed as dist

    solver = sharded_solver(device, (1, 1, 1), maxLevel=level)
    sol, rhs = solver.gen.init_state()
    launch_counts(reset=True)
    solver.gen._cycle(sol.clone(), rhs)
    _sync(device)
    launches = launch_counts()
    lines = solver.solve(max_its=WORLD1_CYCLES, target_res_reduction=1e-10)[1]
    return {"transport": dist.get_backend(), "launches": launches, "lines": lines}


# sharded_dsl_path: timed cycles, the float64 Solve's level
SHARDED_DSL_TIMED, SHARDED_DSL_LINES_LEVEL = 2, 6


def sharded_dsl_knowledge(level, f64=False, **kw):
    from exastencils_tpu_torch import Knowledge

    return Knowledge(dimensionality=3, minLevel=1, maxLevel=level, useDblPrecision=f64,
                     tpu_compute_dtype="" if f64 else "float32", tpu_mesh_shape=SHARD_DIMS,
                     tpu_shard_dsl=True, tpu_dsl_fastpath=False, **kw).update()


def timed_cycles(ex, device, n=SHARDED_DSL_TIMED):
    """ms per MGCycle@finest of a sharded executable over n cycles (CUDA
    events between barriers on the card, the host clock on the CPU) and
    the wall seconds of the n cycles."""
    import torch.distributed as dist

    dist.barrier()
    _sync(device)
    cuda = device.type == "cuda"
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        ex.call_function(ex.functions[("MGCycle", ex.hi)], ex.hi, [])
    if cuda:
        end.record()
    _sync(device)
    wall = time.perf_counter() - t0
    dist.barrier()
    return (start.elapsed_time(end) if cuda else wall * 1e3) / n, wall


def sharded_dsl_rank(device, level, lines_level):
    """One rank of sharded_dsl_path: the bench program at `level` float32
    on its 2x2x2 fragment (its Solve's lines, then SHARDED_DSL_TIMED
    cycles timed on rank 0 with CUDA events between barriers, then again
    with the exchanges timed), then the float64 Solve at `lines_level`."""
    import torch.distributed as dist

    from exastencils_tpu_torch.dsl.interpreter import L4Executable
    from exastencils_tpu_torch.dsl.parser import parse_l4

    # staged by request (the card's default too): a sharded run stays eager
    # and counts the runs it leaves so
    res = []
    ex = L4Executable(parse_l4(BENCH_EXA4), sharded_dsl_knowledge(level), device=device,
                      out=res.append, jit_functions=True)
    ex.run()
    u = ex.get_field("U", ex.hi)
    finite = bool(torch.isfinite(u).all()) and u.dtype == torch.float32
    stats = ex.frag.stats
    before = (stats.communicate, stats.implicit, stats.bytes_sent, stats.gathers)
    cycle_ms, _ = timed_cycles(ex, device)
    per_cycle = [(a - b) / SHARDED_DSL_TIMED for a, b in zip(
        (stats.communicate, stats.implicit, stats.bytes_sent, stats.gathers), before)]
    stats.timed, stats.seconds = True, 0.0
    timed_ms, wall = timed_cycles(ex, device)
    stats.timed = False
    levels = {lvl: ex._window(lvl, "Node").sharded for lvl in range(ex.lo, ex.hi + 1)}
    staging = ex.staging_stats()
    del ex, u
    if device.type == "cuda":
        torch.cuda.empty_cache()
    lines = []
    small = L4Executable(parse_l4(BENCH_EXA4), sharded_dsl_knowledge(lines_level, f64=True),
                         device=device, out=lines.append)
    small.run()
    return {"rank": dist.get_rank(), "res": res, "finite": finite, "cycle_ms": cycle_ms,
            "timed_cycle_ms": timed_ms, "exchange_share": stats.seconds / wall,
            "communicate": per_cycle[0], "implicit": per_cycle[1],
            "mb_sent": per_cycle[2] / 1e6, "gathers": per_cycle[3],
            "sharded": [lvl for lvl, sh in levels.items() if all(sh)],
            "replicated": [lvl for lvl, sh in levels.items() if not any(sh)],
            "unstaged": staging["unstaged"], "unstaged_why": sorted(set(
                staging["unstaged_runs"].values())),
            "lines": lines, "lines_sharded": small.frag is not None,
            "jax": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "exastencils_tpu"))}


def sharded_dsl_path(device="cuda", level=None, lines_level=SHARDED_DSL_LINES_LEVEL):
    """sharded_dsl_path (see the module docstring): the dense references
    on `device` first, then the ranks."""
    import gc

    from exastencils_tpu_torch.parallel.dryrun import _line_ok
    from exastencils_tpu_torch.parallel.mesh import run_ranks

    level = MAIN_LEVEL if level is None else level
    t0 = time.perf_counter()
    ref = {}
    for tag, fastpath in (("plain", False), ("fast", True)):
        lines = []
        dsl_executable(BENCH_EXA4, device, fastpath, max_level=level, lines=lines,
                       jit_functions=False).run()
        ref[tag] = lines
        gc.collect()
    if ref["fast"][-1] != ref["plain"][-1]:
        raise AssertionError(f"sharded_dsl_path: the dense fast path's Solve {ref['fast']} "
                             f"and the plain one's {ref['plain']} differ in cycles")
    floor = max(abs(float(a) - float(b)) for a, b in zip(ref["plain"][:-1], ref["fast"][:-1]))
    dense_lines = []
    dsl_executable(BENCH_EXA4, device, False, max_level=lines_level, f64=True,
                   lines=dense_lines, jit_functions=False).run()
    if device == "cuda":
        torch.cuda.empty_cache()
    n_ranks = int(np.prod(SHARD_DIMS))
    t1 = time.perf_counter()
    ranks = run_ranks(sharded_dsl_rank, n_ranks, level, lines_level, device=device)
    first = ranks[0]
    got, want = first["res"], ref["plain"]
    pairs = [(float(a), float(b)) for a, b in zip(got[:-1], want[:-1])]
    errs = [abs(a - b) / abs(b) for a, b in pairs]
    ok = len(got) == len(want) and got[-1] == want[-1] and all(
        abs(a - b) <= max(1e-5 * abs(b), 2 * floor) for a, b in pairs)
    drop = float(got[1]) / float(got[0])
    phase("sharded_dsl_path", ranks=n_ranks, mesh="x".join(map(str, SHARD_DIMS)), level=level,
          dtype="float32", transport="gloo", solve_cycles=got[-1], lines=got,
          dense_plain=want, dense_fast=ref["fast"],
          max_rel_to_dense=f"{max(errs):.3e}", floor_F=f"{floor:.3e}",
          first_drop=f"{drop:.4e}", drop_bound=DSL_DROP_BOUND,
          cycle_ms_rank0=f"{first['cycle_ms']:.3f}",
          exchange_share=f"{first['exchange_share']:.4f}",
          exchange_timed_cycle_ms=f"{first['timed_cycle_ms']:.3f}",
          communicate_per_cycle=first["communicate"], implicit_per_cycle=first["implicit"],
          mb_sent_per_cycle=f"{first['mb_sent']:.3f}", gathers_per_cycle=first["gathers"],
          sharded_levels=first["sharded"], replicated_levels=first["replicated"],
          runs_left_eager=first["unstaged"], why=first["unstaged_why"],
          spawn_and_run_s=f"{time.perf_counter() - t1:.1f}")
    for r in ranks:
        if (r["res"] == []) == (r["rank"] == 0) or not r["finite"] or r["jax"]:
            raise AssertionError(f"sharded_dsl_path rank {r['rank']}: lines {r['res']} (rank 0 "
                                 f"prints), finite {r['finite']}, imported {r['jax']}")
    if not ok or not drop < DSL_DROP_BOUND:
        raise AssertionError(f"sharded_dsl_path: lines {got} against the dense plain {want} "
                             f"(F {floor}), first drop {drop}")
    if not first["unstaged"] or first["implicit"] or not first["communicate"]:
        raise AssertionError(f"sharded_dsl_path: {first['unstaged']} runs left eager, "
                             f"exchanges {first['communicate']} + {first['implicit']}")
    lines = first["lines"]
    if not (first["lines_sharded"] and len(lines) == len(dense_lines)
            and all(map(_line_ok, lines, dense_lines))):
        raise AssertionError(f"sharded_dsl_path: level-{lines_level} f64 lines differ:\n"
                             f"{lines}\n{dense_lines}")
    phase("sharded_dsl_path_lines", level=lines_level, dtype="float64", lines=len(lines),
          rule="abs 1e-6 or rel 1e-9", identical=lines == dense_lines, last=lines[-2],
          cycles=lines[-1], seconds=f"{time.perf_counter() - t0:.1f}")
    return {**first, "floor": floor}


# sharded_dsl_forms: the bench program in two more forms the sharded DSL
# takes, each Solve cut to FORMS_CYCLES cycles (the program's cap is
# 20); "blocks": its smoother 2-point x-block local solves, the offset
# unknown U@[1,0,0] written by blocks anchored in the ghost layers;
# "stretched": its own RBGS on a linearFct grid, the stencil constant (the
# JAX package refuses vf_gridWidth in a stencil coefficient there: the
# 7-point stencil in index space, so the restricted residual is scaled by
# 4 for the coarse rhs), the rhs from vf_nodePos_* as in the bench program
FORMS = ("blocks", "stretched")
FORMS_CYCLES = 4
# first-cycle residual drops (on the CPU at level 6: blocks 0.1921,
# stretched 0.1610)
FORM_DROP_BOUND = {"blocks": 0.3, "stretched": DSL_DROP_BOUND}
BLOCK_RELAX = """Function Relax@all {
	repeat 3 times {
		communicate U@current
		loop over U@current stepping [2, 1, 1] {
			solve locally relax 0.8 {
				U@current@[0, 0, 0] => A@current * U@current@[0, 0, 0] == F@current@[0, 0, 0]
				U@current@[1, 0, 0] => A@current * U@current@[1, 0, 0] == F@current@[1, 0, 0]
			}
		}
		apply bc to U@current
	}
}

"""
LINEAR_FCT = {"grid_spacingModel": "linearFct", "grid_isUniform": False}


def forms_program(form, cycles=FORMS_CYCLES):
    """The bench program in one of FORMS, its Solve cut to `cycles`."""
    with open(BENCH_EXA4) as f:
        src = f.read()
    if form == "blocks":
        src = (src[:src.index("Function Relax@all {")] + BLOCK_RELAX
               + src[src.index("Function CalcRes@all {"):])
    else:
        head, rest = src.split("Stencil A@all {", 1)
        body, tail = rest.split("}", 1)
        coefs = ["6.0" if i == 0 else "-1.0" for i in range(len(body.strip().splitlines()))]
        body = "".join(f"\n\t{ln.split('=>')[0].strip()} => {c}"
                       for ln, c in zip(body.strip().splitlines(), coefs))
        src = head + "Stencil A@all {" + body + "\n}" + tail
        # the stencil in index space: a coarse level's rhs is (2h)^2 f
        src = src.replace("F@coarser = Down@current * Res@current",
                          "F@coarser = 4.0 * ( Down@current * Res@current )")
    return src.replace("( it >= 20 )", f"( it >= {cycles} )")


def forms_knowledge(form, level, f64=False):
    return sharded_dsl_knowledge(level, f64, **(LINEAR_FCT if form == "stretched" else {}))


def sharded_dsl_forms_rank(device, level, lines_level):
    """One rank of sharded_dsl_forms: each form at `level` float32 on its
    2x2x2 fragment (its Solve's lines, then SHARDED_DSL_TIMED cycles timed
    on rank 0 with CUDA events between barriers), then at `lines_level`
    in float64."""
    import torch.distributed as dist

    from exastencils_tpu_torch.dsl.interpreter import L4Executable
    from exastencils_tpu_torch.dsl.parser import parse_l4

    out = {"rank": dist.get_rank()}
    for form in FORMS:
        res = []
        ex = L4Executable(parse_l4(forms_program(form)), forms_knowledge(form, level),
                          device=device, out=res.append)
        ex.run()
        stats = ex.frag.stats
        u = ex.get_field("U", ex.hi)
        finite = bool(torch.isfinite(u).all()) and u.dtype == torch.float32
        before = (stats.communicate, stats.implicit, stats.bytes_sent, stats.gathers)
        cycle_ms, _ = timed_cycles(ex, device)
        per_cycle = [(a - b) / SHARDED_DSL_TIMED for a, b in zip(
            (stats.communicate, stats.implicit, stats.bytes_sent, stats.gathers), before)]
        levels = {lvl: ex._window(lvl, "Node").sharded for lvl in range(ex.lo, ex.hi + 1)}
        ghost = ex.frag.ghost
        del ex, u
        if device.type == "cuda":
            torch.cuda.empty_cache()
        lines = []
        small = L4Executable(parse_l4(forms_program(form)),
                             forms_knowledge(form, lines_level, f64=True), device=device,
                             out=lines.append)
        small.run()
        out[form] = {"res": res, "finite": finite, "ghost": ghost,
                     "cycle_ms": cycle_ms,
                     "communicate": per_cycle[0], "implicit": per_cycle[1],
                     "mb_sent": per_cycle[2] / 1e6, "gathers": per_cycle[3],
                     "sharded": [lvl for lvl, sh in levels.items() if all(sh)],
                     "lines": lines, "lines_sharded": small.frag is not None}
        del small
    out["jax"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "exastencils_tpu"))
    return out


def sharded_dsl_forms(device="cuda", level=None, lines_level=SHARDED_DSL_LINES_LEVEL, floor=0.0):
    """sharded_dsl_forms (see the module docstring): the dense plain
    references on `device` first, then the ranks.  `floor` is
    sharded_dsl_path's F (its dense fast and plain Solves apart)."""
    import gc

    from exastencils_tpu_torch.dsl.interpreter import L4Executable
    from exastencils_tpu_torch.dsl.parser import parse_l4
    from exastencils_tpu_torch.parallel.dryrun import _line_ok
    from exastencils_tpu_torch.parallel.mesh import run_ranks

    level = MAIN_LEVEL if level is None else level
    t0 = time.perf_counter()
    dense = {}
    for form in FORMS:
        for tag, lvl, f64 in (("f32", level, False), ("f64", lines_level, True)):
            k = forms_knowledge(form, lvl, f64)
            k.tpu_shard_dsl = False
            lines = []
            L4Executable(parse_l4(forms_program(form)), k, device=device,
                         out=lines.append, jit_functions=False).run()
            dense[form, tag] = lines
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    t1 = time.perf_counter()
    n_ranks = int(np.prod(SHARD_DIMS))
    ranks = run_ranks(sharded_dsl_forms_rank, n_ranks, level, lines_level, device=device)
    spawn_s = time.perf_counter() - t1
    for r in ranks:
        bad = [f for f in FORMS if (r[f]["res"] == []) == (r["rank"] == 0) or not r[f]["finite"]]
        if bad or r["jax"]:
            raise AssertionError(f"sharded_dsl_forms rank {r['rank']}: forms {bad} (rank 0 "
                                 f"prints, finite fields), imported {r['jax']}")
    for form in FORMS:
        first = ranks[0][form]
        got, want = first["res"], dense[form, "f32"]
        pairs = [(float(a), float(b)) for a, b in zip(got[:-1], want[:-1])]
        errs = [abs(a - b) / abs(b) for a, b in pairs]
        ok = len(got) == len(want) and got[-1] == want[-1] and all(
            abs(a - b) <= max(1e-5 * abs(b), 2 * floor) for a, b in pairs)
        drop = float(got[1]) / float(got[0])
        phase(f"sharded_dsl_forms_{form}", ranks=n_ranks, mesh="x".join(map(str, SHARD_DIMS)),
              level=level, dtype="float32", transport="gloo", grid=(
                  "linearFct" if form == "stretched" else "uniform"), ghost=first["ghost"],
              solve_cycles=got[-1], lines=got, dense_plain=want,
              max_rel_to_dense=f"{max(errs):.3e}", floor_F=f"{floor:.3e}",
              first_drop=f"{drop:.4e}", drop_bound=FORM_DROP_BOUND[form],
              cycle_ms_rank0=f"{first['cycle_ms']:.3f}",
              communicate_per_cycle=first["communicate"], implicit_per_cycle=first["implicit"],
              mb_sent_per_cycle=f"{first['mb_sent']:.3f}", gathers_per_cycle=first["gathers"],
              sharded_levels=first["sharded"])
        if not ok or not drop < FORM_DROP_BOUND[form]:
            raise AssertionError(f"sharded_dsl_forms {form}: lines {got} against the dense "
                                 f"plain {want} (F {floor}), first drop {drop}")
        if not first["sharded"] or not first["communicate"] + first["implicit"]:
            raise AssertionError(f"sharded_dsl_forms {form}: sharded levels {first['sharded']}, "
                                 f"exchanges {first['communicate']} + {first['implicit']}")
        lines, dense_lines = first["lines"], dense[form, "f64"]
        if not (first["lines_sharded"] and len(lines) == len(dense_lines)
                and all(map(_line_ok, lines, dense_lines))):
            raise AssertionError(f"sharded_dsl_forms {form}: level-{lines_level} f64 lines "
                                 f"differ:\n{lines}\n{dense_lines}")
        phase(f"sharded_dsl_forms_{form}_lines", level=lines_level, dtype="float64",
              lines=len(lines), rule="abs 1e-6 or rel 1e-9", identical=lines == dense_lines,
              last=lines[-2], cycles=lines[-1])
    phase("sharded_dsl_forms", spawn_and_run_s=f"{spawn_s:.1f}",
          seconds=f"{time.perf_counter() - t0:.1f}")


def sharded_phases(device="cuda", kernel_cases=SHARDED_KERNEL_CASES):
    """sharded_kernels, sharded_path, sharded_world1_nccl and
    sharded_dryrun (see the module docstring), the ranks on `device`.
    Returns the ghosted kernels' times at the 2x2x2 fragment of 513^3 and
    rank 0's sharded_path results."""
    import gc

    from exastencils_tpu_torch.models.poisson import PoissonMGSolver
    from exastencils_tpu_torch.parallel.dryrun import run_dryrun
    from exastencils_tpu_torch.parallel.mesh import run_ranks, transport

    t0 = time.perf_counter()
    frag = {}
    for i, (cells, dims, g, K) in enumerate(kernel_cases):
        for dtype in (torch.float32, torch.float64):
            out = compare_sharded_kernels(cells, dims, g, K, dtype,
                                          timed=i == 0 and dtype == torch.float32)
            if i == 0 and dtype == torch.float32:
                frag = out
    phase("sharded_kernels_done", cases=len(kernel_cases), dtypes=2,
          seconds=f"{time.perf_counter() - t0:.1f}")

    # the dense references on the card: main_path's cycle (eager; the
    # staged one is bitwise it) and the level-6 float64 solve's lines
    dense = PoissonMGSolver(poisson_knowledge(tpu_use_pallas=True), device, omega=OMEGA,
                            n_pre=K_MAIN, n_post=K_MAIN)
    sol, rhs = dense.gen.init_state()
    dense_r1 = float(dense.gen._res_norm(dense.mg.cycle(sol, rhs), rhs))
    dense_lines = {}
    for tag, kw, cycles in (("l6_f64", dict(maxLevel=SHARDED_LINES_LEVEL, useDblPrecision=True,
                                            tpu_compute_dtype="float64"), SHARDED_LINES_CYCLES),
                            ("main", {}, WORLD1_CYCLES)):
        dense_lines[tag] = PoissonMGSolver(poisson_knowledge(tpu_use_pallas=True, **kw), device,
                                           omega=OMEGA, n_pre=K_MAIN, n_post=K_MAIN).solve(
            max_its=cycles, target_res_reduction=1e-10)[1]
    del dense, sol, rhs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    n_ranks = int(np.prod(SHARD_DIMS))
    t1 = time.perf_counter()
    ranks = run_ranks(sharded_path_rank, n_ranks, MAIN_LEVEL, SHARDED_LINES_LEVEL, device=device)
    seconds = time.perf_counter() - t1
    first = ranks[0]
    r1s = {r["r1"] for r in ranks}
    rel = abs(first["r1"] - dense_r1) / dense_r1
    phase("sharded_path", ranks=n_ranks, mesh="x".join(map(str, SHARD_DIMS)), level=MAIN_LEVEL,
          transport=first["transport"],
          halo_route="pinned host buffers" if first["transport"] == "gloo" else "device",
          per_rank_launches_per_cycle=first["launches"], expected=SHARDED_LAUNCHES,
          cycle_ms_rank0=f"{first['cycle_ms']:.3f}",
          exchange_share=f"{first['exchange']['share']:.4f}",
          exchange_timed_cycle_ms=f"{first['exchange']['timed_cycle_ms']:.3f}",
          exchanges_per_cycle=first["exchange"]["per_cycle"],
          exchange_bytes_per_cycle=int(first["exchange"]["bytes_per_cycle"]),
          residual_drop=f"{first['r1'] / first['r0']:.4e}", dense_r1=f"{dense_r1:.6e}",
          r1=f"{first['r1']:.6e}", rel_to_dense=f"{rel:.3e}", spawn_and_run_s=f"{seconds:.1f}")
    want = SHARDED_LAUNCHES if device == "cuda" else {}  # the plain versions count none
    for r in ranks:
        if r["launches"] != want:
            raise AssertionError(f"sharded_path rank {r['rank']}: launches {r['launches']}, "
                                 f"expected {want}")
        if not (r["shape_ok"] and r["finite"]) or r["jax"]:
            raise AssertionError(f"sharded_path rank {r['rank']}: shape ok {r['shape_ok']}, "
                                 f"finite {r['finite']}, imported {r['jax']}")
        if r["lines"] != dense_lines["l6_f64"]:
            raise AssertionError(f"sharded_path rank {r['rank']}: level-6 f64 lines differ:\n"
                                 f"{r['lines']}\n{dense_lines['l6_f64']}")
    if len(r1s) != 1 or not first["r1"] < 0.1 * first["r0"] or not rel <= 1e-5:
        raise AssertionError(f"sharded_path: residuals {sorted(r1s)} from {first['r0']}, "
                             f"dense {dense_r1} (rel {rel:.3e})")
    phase("sharded_path_lines", level=SHARDED_LINES_LEVEL, dtype="float64",
          cycles=SHARDED_LINES_CYCLES, replicated=first["replicated"],
          lines_identical_to_dense=True, ranks=n_ranks, last=first["lines"][-1])

    if device == "cuda" and transport("cuda", 1) != "nccl":
        raise AssertionError("one rank on one card must take NCCL")
    (w1,) = run_ranks(world1_rank, 1, MAIN_LEVEL, device=device)
    main_launches = {kk: v for kk, v in w1["launches"].items() if v}
    if w1["lines"] != dense_lines["main"] or w1["transport"] != transport(device, 1):
        raise AssertionError(f"sharded_world1_nccl ({w1['transport']}): lines differ:\n"
                             f"{w1['lines']}\n{dense_lines['main']}")
    if main_launches != ({"K1": MAIN_LEVEL - 1, "K2": MAIN_LEVEL - 1} if device == "cuda" else {}):
        raise AssertionError(f"sharded_world1_nccl: launches {main_launches}")
    phase("sharded_world1_nccl", transport=w1["transport"], mesh="1x1x1", level=MAIN_LEVEL,
          cycles=WORLD1_CYCLES, launches_per_cycle=main_launches,
          lines_identical_to_dense=True, last=w1["lines"][-1])

    out = run_dryrun(4, device)
    dsl = out["dsl"]
    phase("sharded_dryrun", ranks=out["ranks"], mesh="x".join(map(str, out["mesh"])),
          residual=f"{out['residual']:.6e}", dense=f"{out['dense_residual']:.6e}",
          rel=f"{out['rel']:.2e}", bound=1e-5, dsl_mesh="x".join(map(str, dsl["mesh"])),
          dsl_sharded_instances=dsl["sharded_instances"], dsl_lines=len(dsl["lines"]),
          dsl_residual=f"{dsl['res_first']:.3e}->{dsl['res_last']:.3e}",
          dsl_digit_equal_to_dense=True)
    dsl = sharded_dsl_path(device)
    sharded_dsl_forms(device, floor=dsl["floor"])
    phase("sharded_phases", seconds=f"{time.perf_counter() - t0:.1f}")
    return frag, first


# ----------------------------------------------------------------------
# bfloat16: every kernel in bfloat16 against its plain version, and the
# five V(3,3) paths at 513^3 with tpu_compute_dtype="bfloat16"
# ----------------------------------------------------------------------

# The first cycle's residual drop of a bfloat16 kernel path, at most this
# many times the plain bfloat16 path's of the same cycle kind in the same
# call: rounding once (the kernels) stalls above the per-operation rounding
# of the plain ops (`python tests/test_torch_bf16.py`, on the CPU, the
# kernels' plain versions against the plain ops: RBGS 1.02, 1.04, 1.12
# times at levels 5, 6, 7, FAS 1.02-1.09, Jacobi 1.0; the DSL fast path's
# first cycle at maxLevel 4 1.8 times)
BF16_DROP_FACTOR = 2.0
# main_path_bf16's one-cycle output against its plain run's, in bfloat16
# ulps at the largest |value|: the plain ops round every operation, the
# kernels once per stored value, so the iterates part by the smoother's
# rounding noise (the same script: 2-4 ulps at levels 5-7)
BF16_CYCLE_ULPS = 16


def bf16_kernel_phases():
    """K1-K8 in bfloat16 against their plain versions (the sweeps bitwise,
    the transfers within BF16_ULPS): at the odd shape with excl planes and
    without, K = 1, 3, 4; on levels 4 and 5; K7/K8 bitwise K1/K2; K4/K5
    with node and cell taps at odd shapes; the ghosted K1/K2/K3 on the
    273^3 fragment of 513^3 for the excl planes of each rank of a 2x2x2
    mesh; and at 513^3, K = 3 (K7/K8 bitwise K1/K2 there too), timed
    beside the bound at itemsize 2.
    Returns {kernel: {max_abs_err, ms, plain_ms}} at 513^3."""
    t0 = time.perf_counter()
    (odd, excl), n, nc = LEG_CASES[2], 2 ** MAIN_LEVEL + 1, 2 ** (MAIN_LEVEL - 1) + 1
    for K in (1, 3, 4):
        compare_legs(None, K, BF16, shape=odd)
        compare_legs(None, K, BF16, shape=odd, excl=excl)
        compare_fused(None, K, BF16, excl=excl, shape=odd, transfers=False)
        compare_wavefronts(None, K, BF16, excl=excl, shape=odd)
        compare_v1_legs(None, K, BF16, shape=odd)
    for level, K in ((4, 1), (5, 3)):
        compare_legs(level, K, BF16)
        compare_fused(level, K, BF16)
        compare_wavefronts(level, K, BF16)
        compare_v1_legs(level, K, BF16)
    for i, shape in enumerate(((17, 33, 9), (66, 40, 37), (129, 129, 129))):
        for cell in (False, True):
            compare_transfers(shape, BF16, cell, seed=i)
    ghosted = compare_sharded_kernels((256, 256, 256), (2, 2, 2), 8, K_MAIN, BF16, timed=True)
    full = compare_legs(MAIN_LEVEL, K_MAIN, BF16, timed=True)
    full.update(compare_fused(MAIN_LEVEL, K_MAIN, BF16, timed=True))
    full.update(compare_wavefronts(MAIN_LEVEL, K_MAIN, BF16, timed=True))
    compare_v1_legs(MAIN_LEVEL, K_MAIN, BF16)
    compare_transfers((n,) * 3, BF16, False, seed=7)
    for kk in KERNELS:
        b_ms = bound(kk, n, nc, K_MAIN, BF16)[0]
        f32_b = bound(kk, n, nc, K_MAIN, torch.float32)[0]
        phase("bf16_times", kernel=kk, level=MAIN_LEVEL, K=K_MAIN, ms=f"{full[kk]['ms']:.4f}",
              plain_ms=f"{full[kk]['plain_ms']:.4f}", bound_ms=f"{b_ms:.4f}",
              share_of_bound=f"{b_ms / full[kk]['ms']:.3f}", f32_bound_ms=f"{f32_b:.4f}",
              max_abs_err=f"{full[kk]['max_abs_err']:.3e}",
              **({"ghosted_ms": f"{ghosted[kk + '_ms']:.4f}"} if kk in ("K1", "K2", "K3") else {}))
    phase("bf16_kernels", seconds=f"{time.perf_counter() - t0:.1f}")
    return full


def drive_bf16_path(tag, use_kernels, drop_bound, expected=None, model_kw=None, **knowledge_kw):
    """One PoissonMGSolver V(3,3) path at 513^3 in bfloat16 through
    drive_gen (staged bit for bit the eager cycle, launches counted in one
    replay against `expected`, the first cycle's drop below `drop_bound`),
    with its cycle ms and GLUP/s."""
    from exastencils_tpu_torch.models.poisson import PoissonMGSolver

    k = poisson_knowledge(tpu_use_pallas=use_kernels, tpu_compute_dtype="bfloat16",
                          **knowledge_kw)
    solver = PoissonMGSolver(k, device="cuda", omega=OMEGA, n_pre=K_MAIN, n_post=K_MAIN,
                             **(model_kw or {}))
    name = tag if use_kernels else f"{tag}_plain"
    d = drive_gen(name, solver.gen, drop_bound, 10 if use_kernels else 3, idle=use_kernels)
    if d["eager"].dtype != BF16:
        raise AssertionError(f"{name}: the cycle ran in {d['eager'].dtype}")
    d["drop"] = d["r1"] / d["r0"]
    glups = (2 ** MAIN_LEVEL + 1) ** 3 / (d["ms"] * 1e-3) / 1e9
    phase(name, kernels=use_kernels, dtype="bfloat16", residual_drop=f"{d['drop']:.4e}",
          bound=drop_bound if drop_bound is None else f"{drop_bound:.4f}",
          cycle_ms=f"{d['ms']:.3f}", eager_ms=f"{d['eager_ms']:.3f}", glups=f"{glups:.4f}",
          **d.get("idle", {}), launches_per_cycle=d["launches"], expected=expected,
          staged_equals_eager=True, host_reads_per_cycle=d["reads"], **d["stats"])
    if expected is not None and d["launches"] != expected:
        raise AssertionError(f"{name}: launches per cycle {d['launches']}, expected {expected}")
    return d


def bf16_paths(none):
    """The five bfloat16 paths with kernels (main_path_bf16 K1/K2,
    jacobi_path_bf16 K4/K5, fas_path_bf16 K3, v1_path_bf16 K7/K8,
    v1_fas_path_bf16 K6), launches as leg_chain(..., bfloat16) gives them;
    the plain bfloat16 RBGS, Jacobi and FAS cycles first, whose drops bound
    the kernel paths' (BF16_DROP_FACTOR); main_path_bf16's cycle held to
    its plain run's within BF16_CYCLE_ULPS.  Returns {kernel: launches}
    and the paths' cycle ms."""
    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    t0 = time.perf_counter()
    levels = MAIN_LEVEL - 1  # levels 2..9
    chain = {kk: len(s3.leg_chain(m, K_MAIN, BF16, r)) for kk, m, r in (
        ("K1", s3.LEG_RESTRICT, 1), ("K2", s3.LEG_PROLONG, 0), ("K3", s3.LEG_SMOOTH, 0))}
    k6 = -(-K_MAIN // s3.max_wavefront_k(BF16))
    kinds = {"rbgs": ({}, {}), "jacobi": ({"smoother": "Jac"}, {}),
             "fas": ({}, {"solver_useFAS": True})}
    drops, plain_out = {}, None
    for kind, (mk, kk) in kinds.items():
        d = drive_bf16_path(f"{kind}_bf16", False, None, None, mk, **kk)
        drops[kind] = d["drop"]
        if kind == "rbgs":
            plain_out = d["eager"]
        del d
    bounds = {kind: min(BF16_DROP_FACTOR * drop, 0.9) for kind, drop in drops.items()}
    paths = (("main_path_bf16", "rbgs", False, {"K1": levels * chain["K1"], "K2": levels * chain["K2"]}),
             ("jacobi_path_bf16", "jacobi", False, {"K4": levels, "K5": levels}),
             ("fas_path_bf16", "fas", False, {"K3": 2 * levels * chain["K3"]}),
             ("v1_path_bf16", "rbgs", True, {"K7": levels, "K8": levels}),
             ("v1_fas_path_bf16", "fas", True, {"K6": 2 * levels * k6}))
    launches, ms = {}, {}
    for tag, kind, v1, want in paths:
        mk, kk = kinds[kind]
        with v1_schedule() if v1 else contextlib.nullcontext():
            d = drive_bf16_path(tag, True, bounds[kind], {**none, **want}, mk, **kk)
        launches.update(want)
        ms[tag], drops[tag] = d["ms"], d["drop"]
        if tag == "main_path_bf16":
            e = rel_err(d["eager"], plain_out)
        del d
    phase("main_path_bf16_kernel_vs_plain", max_abs=f"{e[0]:.3e}", ulps=f"{e[0] / e[2]:.2f}",
          bound_ulps=BF16_CYCLE_ULPS, drop_kernels=f"{drops['main_path_bf16']:.4e}",
          drop_plain=f"{drops['rbgs']:.4e}")
    if not e[0] <= BF16_CYCLE_ULPS * e[2]:
        raise AssertionError(f"main_path_bf16: kernel and plain cycles differ by {e[0] / e[2]:.2f} ulps")
    phase("bf16_paths", seconds=f"{time.perf_counter() - t0:.1f}",
          **{f"{k}_drop": f"{v:.4e}" for k, v in drops.items()},
          **{f"{kind}_drop_bound": f"{b:.4f}" for kind, b in bounds.items()})
    return launches, ms


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from exastencils_tpu_torch.ops.cuda import library
    from exastencils_tpu_torch.ops.cuda import stream3d as s3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    phase("device", nvidia_smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda, name=repr(name))

    t0 = time.perf_counter()
    library.load_library()
    log = library.library_path().with_suffix(".log")
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
    check_ms = check_times()
    check_solve = dsl_solve_checks()
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
    bf16 = bf16_kernel_phases()
    bf16_launches, _ = bf16_paths(none)

    solve_both("rbgs")
    solve_both("jacobi", model_kw={"smoother": "Jac"})
    solve_both("fas", solver_useFAS=True)
    solve_both("rbgs_v02", model_kw={"n_pre": 0, "n_post": 2})
    with v1_schedule():
        solve_both("rbgs_v1")
        solve_both("fas_v1", solver_useFAS=True)
    fused_path()
    varcoeff = varcoeff_path()
    norms = res_norm_times()
    cgs_paths(per_level)
    cell_path()
    nonuniform_path()
    export_path()
    io_phase()
    perf_estimate()
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
    sharded_phases()
    phase("staging", **{tag: v for tag, v in STAGING.items()})
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    phase("script", seconds=f"{time.perf_counter() - t_start:.1f}")

    kernels = []
    for kk, (fn, rep) in KERNELS.items():
        b_ms, b_by = bound(kk, n, nc, K_MAIN, torch.float32)
        kernels.append({"name": f"{kk} {fn}", "route": "cuda", "source": SOURCES[kk],
                        "replaces": rep, "launches": launches[kk],
                        "max_abs_err": full[kk]["max_abs_err"], "ms": full[kk]["ms"],
                        "plain_ms": full[kk]["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
                        # K4/K5: compositions of library calls (library_transfers); no
                        # PyTorch call computes any of the others
                        "library_ms": full[kk].get("library_ms"),
                        # bfloat16 (513^3, K=3; launches on its *_bf16 path)
                        "bf16_ms": bf16[kk]["ms"],
                        "bf16_bound_ms": bound(kk, n, nc, K_MAIN, BF16)[0],
                        "bf16_max_abs_err": bf16[kk]["max_abs_err"],
                        "bf16_launches": bf16_launches[kk]})
    for kk, fn in CHECKS.items():
        by = (3 if kk == "K9" else 1) * n ** 3 * 4
        kernels.append({"name": f"{kk} {fn}", "route": "cuda", "source":
                        "exastencils_tpu_torch/csrc/check3d.cu", "replaces": None,
                        "launches_per_solve": check_solve[kk], "ms": check_ms[kk],
                        "bound_ms": by / PEAK_BYTES_S * 1e3, "bound_by": "bytes"})
    for kk, fn in (("K11", "smooth_res_restrict_faces"), ("K12", "prolong_correct_smooth_faces")):
        # 513^3 float64, K=3, on the variable-coefficient star (varcoeff_path)
        kernels.append({"name": f"{kk} {fn}", "route": "cuda",
                        "source": "exastencils_tpu_torch/csrc/legs3d.cu", "replaces": None,
                        "dtype": "float64", "launches_per_cycle": varcoeff[kk]["launches"],
                        "ms": varcoeff[kk]["ms"], "plain_ms": varcoeff[kk]["plain_ms"],
                        "bound_ms": varcoeff[kk]["bound_ms"], "bound_by": "bytes"})
    for kk in ("K13", "K13_faces"):
        # 513^3 float64, the finest level of api.l9_f64 and api_vc.l9_f64 (res_norm_times)
        kernels.append({"name": f"{kk} res_norm", "route": "cuda",
                        "source": "exastencils_tpu_torch/csrc/check3d.cu", "replaces": None,
                        "dtype": "float64", "ms": norms[kk]["ms"],
                        "plain_ms": norms[kk]["plain_ms"], "bound_ms": norms[kk]["bound_ms"],
                        "bound_by": "bytes"})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
