"""The port's CUDA kernels K1-K8 against their plain PyTorch versions, on the
GPU, and solves on the GPU that print the CPU's lines.  Skips where torch.cuda.is_available() is false (the kernels have no
interpret mode).  This file imports no jax, so on a GPU machine without jax
it runs on its own:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import os

import numpy as np
import pytest
import torch

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.core.domain import unit_domain
from exastencils_tpu_torch.core.grid import level_grids
from exastencils_tpu_torch.core.stencil import node_prolongation, node_restriction
from exastencils_tpu_torch.models.poisson import PoissonMGSolver, laplace_stencil
from exastencils_tpu_torch.ops.cuda import stream3d as s3
from exastencils_tpu_torch.ops.transfer import separable_kernels

pytestmark = pytest.mark.cuda
OMEGA = 0.8
# max|kernel - plain| / max|plain|; float32: the plain transfers are banded
# matmuls that sum the taps in another order
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def laplacian(level, dtype, device):
    k = Knowledge(dimensionality=3, minLevel=level, maxLevel=level).update()
    return laplace_stencil(3).bind(level_grids(unit_domain(3), k, device, dtype=dtype)[level])


def leg_launches(mode, K, dtype):
    """legs3d.cu launches of one K1/K2/K3 call: one up to max_leg_k."""
    return len(s3.leg_chain(mode, K, dtype, 1 if mode == s3.LEG_RESTRICT else 0))


def k6_launches(K, dtype, cluster=None):
    """cluster_legs3d.cu launches of one K6 call: one per max_wavefront_k
    iterations."""
    return -(-K // s3.max_wavefront_k(dtype, cluster))


def k6_excess(K, dtype):
    """K6 launches of one K7 and one K8 call for the iterations they do not
    hold."""
    return sum(k6_launches(max(K - s3.max_cluster_k(dtype, m), 0), dtype)
               for m in (s3.LEG_RESTRICT, s3.LEG_PROLONG))


@pytest.mark.parametrize("level,K", [(4, 1), (5, 3)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_legs_match_plain(cuda, level, K, dtype):
    """K1/K2 (legs3d.cu): one launch per call up to max_leg_k; the smoothed
    sol bitwise the plain version's; K1's coarse rhs and K2 bitwise the
    compositions K3+K4 and K5+K3, and within TOL of the plain versions."""
    rng = np.random.default_rng(level * 10 + K)
    n, nc = 2 ** level + 1, 2 ** (level - 1) + 1
    sol, rhs = (torch.from_numpy(rng.standard_normal((n,) * 3)).to(cuda, dtype) for _ in range(2))
    sol_c = torch.from_numpy(rng.standard_normal((nc,) * 3)).to(cuda, dtype)
    A = laplacian(level, dtype, cuda)
    R, P = node_restriction(3), node_prolongation(3)
    rk, pk = separable_kernels(R), separable_kernels(P)
    n0 = (s3.smooth_res_restrict.launches, s3.prolong_correct_smooth.launches)
    s_got, rc_got = s3.smooth_res_restrict(sol.clone(), rhs, A, OMEGA, K, rk, R.lo, (nc,) * 3)
    u_got = s3.prolong_correct_smooth(sol.clone(), sol_c, rhs, A, OMEGA, K, pk, P.lo)
    torch.cuda.synchronize()
    assert (s3.smooth_res_restrict.launches - n0[0],
            s3.prolong_correct_smooth.launches - n0[1]) == (
        leg_launches(s3.LEG_RESTRICT, K, dtype), leg_launches(s3.LEG_PROLONG, K, dtype))
    s_ref, rc_ref = s3.smooth_res_restrict_plain(sol, rhs, A, OMEGA, K, rk, R.lo, (nc,) * 3)
    u_ref = s3.prolong_correct_smooth_plain(sol, sol_c, rhs, A, OMEGA, K, pk, P.lo)
    assert torch.equal(s_got, s_ref)  # --fmad=false: the RBGS is bitwise
    assert torch.equal(rc_got, s3.res_restrict(s3.rbgs_fused(sol.clone(), rhs, A, OMEGA, K),
                                               rhs, A, rk, R.lo, (nc,) * 3))
    assert torch.equal(u_got, s3.rbgs_fused(s3.prolong_correct(sol.clone(), sol_c, pk, P.lo),
                                            rhs, A, OMEGA, K))
    for got, ref in ((rc_got, rc_ref), (u_got, u_ref)):
        assert (got - ref).abs().max().item() <= TOL[dtype] * ref.abs().max().item()


@pytest.mark.parametrize("level,K", [(4, 1), (5, 3)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_kernels_match_plain(cuda, level, K, dtype):
    """K3 (bitwise, with and without excl planes), K4 and K5: one legs3d.cu
    launch per K3 call up to max_leg_k, one launch per transfer."""
    rng = np.random.default_rng(level * 10 + K + 1)
    n, nc = 2 ** level + 1, 2 ** (level - 1) + 1
    sol, rhs = (torch.from_numpy(rng.standard_normal((n,) * 3)).to(cuda, dtype) for _ in range(2))
    sol_c = torch.from_numpy(rng.standard_normal((nc,) * 3)).to(cuda, dtype)
    A = laplacian(level, dtype, cuda)
    R, P = node_restriction(3), node_prolongation(3)
    rk, pk = separable_kernels(R), separable_kernels(P)
    excl = (2, n - 3, -1, 5, 1, -1)
    n0 = (s3.rbgs_fused.launches, s3.res_restrict.launches, s3.prolong_correct.launches)
    s_got = s3.rbgs_fused(sol.clone(), rhs, A, OMEGA, K)
    e_got = s3.rbgs_fused(sol.clone(), rhs, A, OMEGA, K, excl)
    rc_got = s3.res_restrict(sol, rhs, A, rk, R.lo, (nc,) * 3)
    u_got = s3.prolong_correct(sol.clone(), sol_c, pk, P.lo)
    torch.cuda.synchronize()
    assert (s3.rbgs_fused.launches - n0[0], s3.res_restrict.launches - n0[1],
            s3.prolong_correct.launches - n0[2]) == (2 * leg_launches(s3.LEG_SMOOTH, K, dtype), 1, 1)
    assert torch.equal(s_got, s3.rbgs_fused_plain(sol, rhs, A, OMEGA, K))
    assert torch.equal(e_got, s3.rbgs_fused_plain(sol, rhs, A, OMEGA, K, excl))
    rc_ref = s3.res_restrict_plain(sol, rhs, A, rk, R.lo, (nc,) * 3)
    u_ref = s3.prolong_correct_plain(sol, sol_c, pk, P.lo)
    for got, ref in ((rc_got, rc_ref), (u_got, u_ref)):
        assert (got - ref).abs().max().item() <= TOL[dtype] * ref.abs().max().item()


@pytest.mark.parametrize("level,K", [(4, 1), (4, 3), (5, 1), (5, 3)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wavefronts_match_plain(cuda, level, K, dtype):
    """K6 (with and without excl planes) and K7's sol bitwise, K7's coarse
    rhs and K8 within TOL; K7/K8 one launch per call, K6 one per
    max_wavefront_k iterations; sol left as it was."""
    rng = np.random.default_rng(level * 10 + K + 2)
    n, nc = 2 ** level + 1, 2 ** (level - 1) + 1
    sol, rhs = (torch.from_numpy(rng.standard_normal((n,) * 3)).to(cuda, dtype) for _ in range(2))
    sol_c = torch.from_numpy(rng.standard_normal((nc,) * 3)).to(cuda, dtype)
    before = sol.clone()
    A = laplacian(level, dtype, cuda)
    R, P = node_restriction(3), node_prolongation(3)
    rk, pk = separable_kernels(R), separable_kernels(P)
    excl = (2, n - 3, -1, 5, 1, -1)
    counters = (s3.rbgs_wavefront, s3.smooth_res_restrict_wavefront,
                s3.prolong_correct_smooth_wavefront)
    n0 = [fn.launches for fn in counters]
    s6 = s3.rbgs_wavefront(sol, rhs, A, OMEGA, K)
    e6 = s3.rbgs_wavefront(sol, rhs, A, OMEGA, K, excl)
    s7, rc7 = s3.smooth_res_restrict_wavefront(sol, rhs, A, OMEGA, K, rk, R.lo, (nc,) * 3)
    s8 = s3.prolong_correct_smooth_wavefront(sol, sol_c, rhs, A, OMEGA, K, pk, P.lo)
    torch.cuda.synchronize()
    # K7/K8 run the iterations one launch does not hold as K6 launches
    k6 = 2 * k6_launches(K, dtype) + k6_excess(K, dtype)
    assert [fn.launches - k for fn, k in zip(counters, n0)] == [k6, 1, 1]
    assert torch.equal(sol, before)
    assert torch.equal(s6, s3.rbgs_wavefront_plain(sol, rhs, A, OMEGA, K))
    assert torch.equal(e6, s3.rbgs_wavefront_plain(sol, rhs, A, OMEGA, K, excl))
    r7, rrc7 = s3.smooth_res_restrict_wavefront_plain(sol, rhs, A, OMEGA, K, rk, R.lo, (nc,) * 3)
    assert torch.equal(s7, r7)
    r8 = s3.prolong_correct_smooth_wavefront_plain(sol, sol_c, rhs, A, OMEGA, K, pk, P.lo)
    for got, ref in ((rc7, rrc7), (s8, r8)):
        assert (got - ref).abs().max().item() <= TOL[dtype] * ref.abs().max().item()


@pytest.mark.parametrize("level", [7, 9])
def test_rbgs_wavefront_tile_edges(cuda, level):
    """Blocks run concurrently; a tile that read a neighbour's smoothed
    halo would differ from plain at tile edges, and only sometimes.
    Several seeds, each run three times, all bitwise."""
    n = 2 ** level + 1
    A = laplacian(level, torch.float32, cuda)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        sol, rhs = (torch.from_numpy(rng.standard_normal((n,) * 3)).to(cuda, torch.float32)
                    for _ in range(2))
        ref = s3.rbgs_wavefront_plain(sol, rhs, A, OMEGA, 3)
        for _ in range(3):
            assert torch.equal(s3.rbgs_wavefront(sol, rhs, A, OMEGA, 3), ref)


# K3/K6 at odd shapes with excl planes on both sides of tile edges (31 | 32,
# 63 | 64: the inner edges of 1 x 2, 2 x 1 and 2 x 2 clusters in x or y
# and outer ones) and of z-chunk edges, one in the array's last tile (a
# node past the tile at 65 and 129)
SMOOTHER_CASES = (((5, 5, 5), (2, -1, -1, -1, 1, -1)),
                  ((17, 33, 9), (2, 14, -1, 20, 1, -1)),
                  ((65, 65, 65), (3, 4, 31, 32, 32, 63)),
                  ((66, 40, 37), (7, 8, 32, -1, 31, 33)),
                  ((139, 9, 17), (127, 128, -1, -1, 8, -1)),
                  ((129, 129, 129), (63, 64, 63, 96, 64, 127)))


def star_inputs(shape, dtype, device, seed):
    """A 7-point star with distinct coefficients and random sol, rhs."""
    A, sol, rhs, _ = star_fields(shape, (1, 1, 1), dtype, device, seed)
    return A, sol, rhs


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_smoothers_match_plain_at_odd_shapes(cuda, dtype):
    """K3 (legs3d.cu, in place) and K6 (cluster_legs3d.cu on every cluster
    shape, a new tensor) bitwise rbgs_fused_plain with and without excl
    planes on tile, cluster and z-chunk edges, K = 1..5: K3 one launch per
    max_leg_k iterations, K6 one per max_wavefront_k; K6 leaves sol as it
    was."""
    for shape, excl in SMOOTHER_CASES:
        for K in (1, 2, 3, 4, 5):
            A, sol, rhs = star_inputs(shape, dtype, cuda, K)
            before = sol.clone()
            for ex in (s3.NO_EXCL, excl):
                want = s3.rbgs_fused_plain(sol, rhs, A, OMEGA, K, ex)
                n0 = s3.rbgs_fused.launches
                s = sol.clone()
                assert s3.rbgs_fused(s, rhs, A, OMEGA, K, ex) is s
                torch.cuda.synchronize()
                assert s3.rbgs_fused.launches - n0 == leg_launches(s3.LEG_SMOOTH, K, dtype)
                assert torch.equal(s, want), (shape, K, ex)
                for cluster in s3.CLUSTER_SHAPES:
                    n0 = s3.rbgs_wavefront.launches
                    got = s3.rbgs_wavefront(sol, rhs, A, OMEGA, K, ex, cluster=cluster)
                    torch.cuda.synchronize()
                    assert s3.rbgs_wavefront.launches - n0 == k6_launches(K, dtype, cluster)
                    assert torch.equal(got, want), (shape, K, ex, cluster)
            assert torch.equal(sol, before)


def test_k3_chunks_and_launch_count(cuda):
    """K3 on 129^3 float32, K=3, at block z-chunks of 4 to 256 planes: all
    bitwise the plain version, one launch each; K = 0 launches nothing and
    changes nothing."""
    A, sol, rhs = star_inputs((129,) * 3, torch.float32, cuda, 5)
    excl = SMOOTHER_CASES[-1][1]
    want = s3.rbgs_fused_plain(sol, rhs, A, OMEGA, 3, excl)
    for chunk in (4, 16, 64, 128, 256):
        n0 = s3.rbgs_fused.launches
        got = s3.rbgs_fused(sol.clone(), rhs, A, OMEGA, 3, excl, chunk=chunk)
        torch.cuda.synchronize()
        assert s3.rbgs_fused.launches - n0 == 1
        assert torch.equal(got, want), chunk
    n0, s = s3.rbgs_fused.launches, sol.clone()
    assert torch.equal(s3.rbgs_fused(s, rhs, A, OMEGA, 0), sol)
    assert s3.rbgs_fused.launches == n0


@pytest.mark.parametrize("level", [7, 9])
def test_smoothers_excl_on_edges(cuda, level):
    """K3 and K6 (default cluster and 2 x 2) on a level's Laplacian, float32
    K=3, excl planes on tile, cluster and z-chunk edges: several seeds,
    each run twice, all bitwise the plain version."""
    n = 2 ** level + 1
    A = laplacian(level, torch.float32, cuda)
    h = n // 2
    excl = (h - 1, h, 31, h, 32, n - 2)  # z at a chunk edge at 513^3; n - 2: the last inner x
    for seed in range(3):
        rng = np.random.default_rng(seed)
        sol, rhs = (torch.from_numpy(rng.standard_normal((n,) * 3)).to(cuda, torch.float32)
                    for _ in range(2))
        ref = s3.rbgs_fused_plain(sol, rhs, A, OMEGA, 3, excl)
        for _ in range(2):
            assert torch.equal(s3.rbgs_fused(sol.clone(), rhs, A, OMEGA, 3, excl), ref)
            for cluster in (None, (2, 2)):
                assert torch.equal(s3.rbgs_wavefront(sol, rhs, A, OMEGA, 3, excl, cluster=cluster),
                                   ref)


@pytest.mark.parametrize("level", [7, 9])
def test_legs_tile_edges(cuda, level):
    """K1/K2's blocks run concurrently on overlapping windows; a block that
    read a neighbour's output, or missed a node of its halo or z-chunk,
    would differ at tile or chunk edges, and only sometimes.  Several
    seeds, each run three times, all bitwise: K1's sol the plain version's,
    its coarse rhs K3+K4's, K2 K5+K3's."""
    n, nc = 2 ** level + 1, 2 ** (level - 1) + 1
    A = laplacian(level, torch.float32, cuda)
    R, P = node_restriction(3), node_prolongation(3)
    rk, pk = separable_kernels(R), separable_kernels(P)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        sol, rhs = (torch.from_numpy(rng.standard_normal((n,) * 3)).to(cuda, torch.float32)
                    for _ in range(2))
        sol_c = torch.from_numpy(rng.standard_normal((nc,) * 3)).to(cuda, torch.float32)
        s_ref = s3.rbgs_fused_plain(sol, rhs, A, OMEGA, 3)
        rc_ref = s3.res_restrict(s3.rbgs_fused(sol.clone(), rhs, A, OMEGA, 3), rhs, A, rk, R.lo,
                                 (nc,) * 3)
        u_ref = s3.rbgs_fused(s3.prolong_correct(sol.clone(), sol_c, pk, P.lo), rhs, A, OMEGA, 3)
        for _ in range(3):
            s_got, rc_got = s3.smooth_res_restrict(sol.clone(), rhs, A, OMEGA, 3, rk, R.lo,
                                                   (nc,) * 3)
            u_got = s3.prolong_correct_smooth(sol.clone(), sol_c, rhs, A, OMEGA, 3, pk, P.lo)
            assert torch.equal(s_got, s_ref)
            assert torch.equal(rc_got, rc_ref)
            assert torch.equal(u_got, u_ref)


# K4/K5 (stream3d.cu): odd and non-cubic shapes, ones that a tile or z-chunk
# does not divide (K4's last tile one node more: 33 coarse nodes at 65, 65
# at 129, 257 at 513), 129^3 and 513^3
TRANSFER_CASES = ((5, 5, 5), (17, 33, 9), (66, 40, 37), (139, 9, 17), (65, 19, 131),
                  (129, 129, 129), (513, 513, 513))


def transfer_ops(cell):
    from exastencils_tpu_torch.core.stencil import cell_prolongation, cell_restriction

    R, P = ((cell_restriction(3), cell_prolongation(3)) if cell
            else (node_restriction(3), node_prolongation(3)))
    return R, P, separable_kernels(R), separable_kernels(P)


@pytest.mark.parametrize("cell", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_transfers_match_plain(cuda, dtype, cell):
    """K4 and K5 within TOL of their plain versions with node and cell taps,
    one launch per call; several seeds, each run three times, all bitwise
    the first run (a block that raced another, or read a halo node late,
    would differ only sometimes); K4 leaves sol and rhs as they were."""
    R, P, rk, pk = transfer_ops(cell)
    for shape in TRANSFER_CASES:
        cshape = tuple(m // 2 if cell else (m - 1) // 2 + 1 for m in shape)
        for seed in range(3 if min(shape) >= 129 else 1):
            A, sol, rhs, sol_c = star_fields(shape, cshape, dtype, cuda, seed)
            before = (sol.clone(), rhs.clone())
            n0 = (s3.res_restrict.launches, s3.prolong_correct.launches)
            rc = s3.res_restrict(sol, rhs, A, rk, R.lo, cshape)
            u = sol.clone()
            assert s3.prolong_correct(u, sol_c, pk, P.lo) is u
            torch.cuda.synchronize()
            assert (s3.res_restrict.launches - n0[0], s3.prolong_correct.launches - n0[1]) == (1, 1)
            assert torch.equal(sol, before[0]) and torch.equal(rhs, before[1])
            rc_ref = s3.res_restrict_plain(sol, rhs, A, rk, R.lo, cshape)
            u_ref = s3.prolong_correct_plain(sol, sol_c, pk, P.lo)
            for got, ref in ((rc, rc_ref), (u, u_ref)):
                assert (got - ref).abs().max().item() <= TOL[dtype] * ref.abs().max().item(), shape
            assert torch.equal(u[0], sol[0]) and torch.equal(u[:, :, -1], sol[:, :, -1])
            for _ in range(2):
                assert torch.equal(s3.res_restrict(sol, rhs, A, rk, R.lo, cshape), rc), shape
                assert torch.equal(s3.prolong_correct(sol.clone(), sol_c, pk, P.lo), u), shape


def test_transfer_chunks_and_refusal(cuda):
    """K4/K5 at 129^3 float32 at block z-chunks of 2 to 64 planes: bitwise
    the default chunk's result, one launch each; an odd K4 chunk is refused
    by the C entry and raises, and nothing runs instead."""
    R, P, rk, pk = transfer_ops(False)
    A, sol, rhs, sol_c = star_fields((129,) * 3, (65,) * 3, torch.float32, cuda, 7)
    rc = s3.res_restrict(sol, rhs, A, rk, R.lo, (65,) * 3)
    u = s3.prolong_correct(sol.clone(), sol_c, pk, P.lo)
    for chunk in (2, 4, 8, 32, 64):
        n0 = (s3.res_restrict.launches, s3.prolong_correct.launches)
        assert torch.equal(s3.res_restrict(sol, rhs, A, rk, R.lo, (65,) * 3, chunk=chunk), rc)
        assert torch.equal(s3.prolong_correct(sol.clone(), sol_c, pk, P.lo, chunk=chunk), u)
        assert (s3.res_restrict.launches - n0[0], s3.prolong_correct.launches - n0[1]) == (1, 1)
    n0 = s3.res_restrict.launches
    with pytest.raises(RuntimeError, match="residual_restrict: CUDA error"):
        s3.res_restrict(sol, rhs, A, rk, R.lo, (65,) * 3, chunk=3)
    assert s3.res_restrict.launches == n0


# K7/K8 (cluster_legs3d.cu) against K1/K2 (legs3d.cu): odd shapes, one with
# a last node past a tile (33), two z-chunks, the smallest level
CLUSTER_CASES = (((5, 5, 5), (3, 3, 3)), ((17, 33, 9), (9, 17, 5)), ((65, 65, 65), (33, 33, 33)),
                 ((139, 9, 17), (70, 5, 9)))


def star_fields(shape, cshape, dtype, device, seed):
    """Random fields and a 7-point star with distinct coefficients."""
    from exastencils_tpu_torch.core.stencil import BoundStencil

    rng = np.random.default_rng(seed)
    offs = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))
    A = BoundStencil("A", offs, (6.5, -0.9, -1.1, -0.7, -1.3, -0.95, -1.05))
    return (A, *(torch.from_numpy(rng.standard_normal(sh)).to(device, dtype)
                 for sh in (shape, shape, cshape)))


@pytest.mark.parametrize("cluster", s3.CLUSTER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cluster_legs_equal_k1_k2(cuda, dtype, cluster):
    """K7 bitwise K1 in both outputs and K8 bitwise K2, for every cluster
    shape, K = 1..4; the inputs left as they were."""
    R, P = node_restriction(3), node_prolongation(3)
    rk, pk = separable_kernels(R), separable_kernels(P)
    for shape, cshape in CLUSTER_CASES:
        for K in (1, 2, 3, 4):
            A, sol, rhs, sol_c = star_fields(shape, cshape, dtype, cuda, K)
            before = sol.clone()
            s7, c7 = s3.smooth_res_restrict_wavefront(sol, rhs, A, OMEGA, K, rk, R.lo, cshape,
                                                      cluster=cluster)
            s8 = s3.prolong_correct_smooth_wavefront(sol, sol_c, rhs, A, OMEGA, K, pk, P.lo,
                                                     cluster=cluster)
            s1, c1 = s3.smooth_res_restrict(sol.clone(), rhs, A, OMEGA, K, rk, R.lo, cshape)
            s2 = s3.prolong_correct_smooth(sol.clone(), sol_c, rhs, A, OMEGA, K, pk, P.lo)
            assert torch.equal(sol, before)
            assert torch.equal(s7, s1) and torch.equal(c7, c1), (shape, K, cluster)
            assert torch.equal(s8, s2), (shape, K, cluster)


@pytest.mark.parametrize("level", [7, 9])
def test_cluster_legs_tile_edges(cuda, level):
    """K7/K8's clusters run concurrently and their blocks read each other's
    shared memory; a read before the neighbour's write, or a missed halo,
    edge or z-chunk node, would differ at tile, cluster or chunk edges, and
    only sometimes.  Several seeds, each run three times, all bitwise K1/K2."""
    n, nc = 2 ** level + 1, 2 ** (level - 1) + 1
    A = laplacian(level, torch.float32, cuda)
    R, P = node_restriction(3), node_prolongation(3)
    rk, pk = separable_kernels(R), separable_kernels(P)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        sol, rhs = (torch.from_numpy(rng.standard_normal((n,) * 3)).to(cuda, torch.float32)
                    for _ in range(2))
        sol_c = torch.from_numpy(rng.standard_normal((nc,) * 3)).to(cuda, torch.float32)
        s1, c1 = s3.smooth_res_restrict(sol.clone(), rhs, A, OMEGA, 3, rk, R.lo, (nc,) * 3)
        s2 = s3.prolong_correct_smooth(sol.clone(), sol_c, rhs, A, OMEGA, 3, pk, P.lo)
        for _ in range(3):
            s7, c7 = s3.smooth_res_restrict_wavefront(sol, rhs, A, OMEGA, 3, rk, R.lo, (nc,) * 3)
            assert torch.equal(s7, s1) and torch.equal(c7, c1)
            assert torch.equal(s3.prolong_correct_smooth_wavefront(sol, sol_c, rhs, A, OMEGA, 3,
                                                                   pk, P.lo), s2)


@pytest.mark.parametrize("dtype,K", [(torch.float32, 3), (torch.float32, 5), (torch.float64, 3)])
def test_cluster_leg_launches(cuda, dtype, K):
    """One K7/K8 launch per call, K6 launches for the iterations it does not
    hold (K6 before K7, after K8): f32 K=3 none, f32 K=5 one each, f64
    K=3 one each (K7 holds 1, K8 2; K6 2)."""
    n, nc = 17, 9
    A = laplacian(4, dtype, cuda)
    R, P = node_restriction(3), node_prolongation(3)
    rk, pk = separable_kernels(R), separable_kernels(P)
    sol, rhs = (torch.ones((n,) * 3, dtype=dtype, device=cuda) for _ in range(2))
    sol_c = torch.ones((nc,) * 3, dtype=dtype, device=cuda)
    counters = (s3.rbgs_wavefront, s3.smooth_res_restrict_wavefront,
                s3.prolong_correct_smooth_wavefront)
    for fn, call, mode in (
            (s3.smooth_res_restrict_wavefront,
             lambda: s3.smooth_res_restrict_wavefront(sol, rhs, A, OMEGA, K, rk, R.lo, (nc,) * 3),
             s3.LEG_RESTRICT),
            (s3.prolong_correct_smooth_wavefront,
             lambda: s3.prolong_correct_smooth_wavefront(sol, sol_c, rhs, A, OMEGA, K, pk, P.lo),
             s3.LEG_PROLONG)):
        n0 = [c.launches for c in counters]
        call()
        torch.cuda.synchronize()
        moved = dict(zip(("K6", "K7", "K8"), (c.launches - k for c, k in zip(counters, n0))))
        k6 = k6_launches(max(K - s3.max_cluster_k(dtype, mode), 0), dtype)
        assert k6 == int(K > s3.max_cluster_k(dtype, mode))
        assert moved == {"K6": k6, "K7": int(mode == s3.LEG_RESTRICT),
                         "K8": int(mode == s3.LEG_PROLONG)}


def test_refused_cluster_launch_raises(cuda):
    """A cluster shape the kernel does not take is refused by the C entry
    and raises, for K7 and K6, and so are excl planes given to K7/K8;
    nothing runs on the CPU instead."""
    A = laplacian(3, torch.float32, cuda)
    R = node_restriction(3)
    t = torch.zeros((9, 9, 9), dtype=torch.float32, device=cuda)
    n0 = (s3.smooth_res_restrict_wavefront.launches, s3.rbgs_wavefront.launches)
    with pytest.raises(RuntimeError, match="cluster_leg: CUDA error"):
        s3.smooth_res_restrict_wavefront(t, t, A, OMEGA, 1, separable_kernels(R), R.lo, (5, 5, 5),
                                         cluster=(1, 4))
    with pytest.raises(RuntimeError, match="cluster_leg: CUDA error"):
        s3.rbgs_wavefront(t, t, A, OMEGA, 1, cluster=(1, 4))
    with pytest.raises(RuntimeError, match="cluster_leg: CUDA error"):
        s3._cluster_leg_launch(s3.LEG_RESTRICT, t, t, A, OMEGA, 1, separable_kernels(R), R.lo,
                               (1, 2), coarse_shape=(5, 5, 5), excl=(2, -1, -1, -1, -1, -1))
    assert (s3.smooth_res_restrict_wavefront.launches, s3.rbgs_wavefront.launches) == n0


def test_wrapper_rejects_non_contiguous(cuda):
    A = laplacian(3, torch.float64, cuda)
    R = node_restriction(3)
    t = torch.zeros((9, 9, 9), dtype=torch.float64, device=cuda).transpose(0, 2)
    with pytest.raises(ValueError, match="contiguous"):
        s3.smooth_res_restrict(t, t, A, OMEGA, 1, separable_kernels(R), R.lo, (5, 5, 5))


SOLVES = {
    "rbgs": ({}, {}),
    "jacobi": ({}, {"smoother": "Jac"}),
    "fas": ({"solver_useFAS": True}, {}),
    "rbgs_v02": ({}, {"n_pre": 0, "n_post": 2}),
}


def solve_l4(name, device, use_kernels=True, max_level=4):
    knowledge_kw, model_kw = SOLVES[name]
    k = Knowledge(dimensionality=3, minLevel=0, maxLevel=max_level, tpu_use_pallas=use_kernels,
                  **knowledge_kw).update()
    return PoissonMGSolver(k, device=device, **model_kw).solve(
        max_its=100, target_res_reduction=1e-10)


@pytest.mark.parametrize("name", ["fas", "jacobi", "rbgs"])
def test_solve_on_cuda_prints_the_cpu_lines(cuda, name):
    got, want = solve_l4(name, "cuda"), solve_l4(name, "cpu")
    assert got[1] == want[1]
    assert got[4] == want[4]


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_kernel_solve_matches_plain_solve_on_cuda(cuda, name):
    """With kernels and with plain ops on the card: the same lines and the
    same final residual to the last bit.  (Against the CPU, the V(0,2)
    residual after cycle 21 is 9.2305e-06, a tie in the 4-digit print that
    the CPU's and the card's matmul sums round apart, with or without the
    kernels.)"""
    got, want = solve_l4(name, "cuda"), solve_l4(name, "cuda", use_kernels=False)
    assert got[1] == want[1]
    assert (got[3], got[4]) == (want[3], want[4])


@pytest.mark.parametrize("name", ["fas", "rbgs"])
def test_v1_solve_matches_plain_solve_on_cuda(cuda, monkeypatch, name):
    """EXA_STREAM_V1=1, maxLevel 5 f64: with the wavefronts K6 (FAS) or
    K7/K8 (RBGS) the lines and the final residual equal the card's plain
    solve to the last bit, and no K1-K3 kernel runs."""
    monkeypatch.setenv("EXA_STREAM_V1", "1")
    v2 = (s3.smooth_res_restrict, s3.prolong_correct_smooth, s3.rbgs_fused)
    v1 = (s3.rbgs_wavefront, s3.smooth_res_restrict_wavefront,
          s3.prolong_correct_smooth_wavefront)
    n0 = [fn.launches for fn in v1 + v2]
    got = solve_l4(name, "cuda", max_level=5)
    moved = [fn.launches - k for fn, k in zip(v1 + v2, n0)]
    want = solve_l4(name, "cuda", use_kernels=False, max_level=5)
    assert got[1] == want[1]
    assert (got[3], got[4]) == (want[3], want[4])
    assert moved[3:] == [0, 0, 0]
    assert (moved[0] > 0) if name == "fas" else (moved[1] > 0 and moved[2] > 0)


# ----------------------------------------------------------------------
# the DSL path: examples/poisson_3d_bench.exa4 through the L4 executor
# ----------------------------------------------------------------------

BENCH_EXA4 = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                          "examples", "poisson_3d_bench.exa4")


def dsl_bench(device, max_level=6, fastpath=True):
    """The bench program at maxLevel `max_level`, f64: (executable, lines)."""
    from exastencils_tpu_torch.dsl.interpreter import L4Executable
    from exastencils_tpu_torch.dsl.parser import parse_l4

    k = Knowledge(dimensionality=3, minLevel=1, maxLevel=max_level, useDblPrecision=True,
                  tpu_shard_dsl=False, tpu_dsl_fastpath=fastpath).update()
    lines = []
    ex = L4Executable(parse_l4(BENCH_EXA4), k, device=device, out=lines.append)
    return ex, lines


def test_dsl_on_cuda_prints_the_cpu_lines(cuda):
    ex, got = dsl_bench("cuda")
    assert ex._fastpath is not None
    ex.run()
    cpu, want = dsl_bench("cpu", fastpath=False)
    cpu.run()
    assert got == want


@pytest.mark.parametrize("v1", [False, True])
def test_dsl_cycle_launches_the_leg_kernels(cuda, monkeypatch, v1):
    """One MGCycle@finest at maxLevel 6: levels 5 and 6 (>= 33 nodes) run
    the whole-leg kernels, K1/K2 leg_launches per level and leg (f64, K=3:
    two, as one launch holds K2 2 and K1 1 iterations in f64), or with
    EXA_STREAM_V1=1 K7/K8 one launch per level and leg, and a K6 launch
    each for the iterations they do not hold in f64.  The cycle is staged:
    the first call captures it, the counted one is a replay, whose graphs
    count the launches captured in them."""
    if v1:
        monkeypatch.setenv("EXA_STREAM_V1", "1")
    kernels = (s3.smooth_res_restrict, s3.prolong_correct_smooth, s3.rbgs_fused,
               s3.smooth_res_restrict_wavefront, s3.prolong_correct_smooth_wavefront,
               s3.rbgs_wavefront)
    ex, _ = dsl_bench("cuda")
    finest = ex.hi
    ex.call_function(ex.functions[("InitF", finest)], finest, [])
    captures = ex.stage_stats.captures
    ex.call_function(ex.functions[("MGCycle", finest)], finest, [])
    assert ex.jit_functions and ex.stage_stats.captures == captures + 1
    n0 = [fn.launches for fn in kernels]
    ex.call_function(ex.functions[("MGCycle", finest)], finest, [])
    torch.cuda.synchronize()
    moved = [fn.launches - k for fn, k in zip(kernels, n0)]
    k1, k2 = (2 * leg_launches(m, 3, torch.float64) for m in (s3.LEG_RESTRICT, s3.LEG_PROLONG))
    # v1 in float64: K7 holds 1 iteration and K8 2, K6 runs the rest
    k6 = 2 * k6_excess(3, torch.float64)
    assert moved == ([0, 0, 0, 2, 2, k6] if v1 else [k1, k2, 0, 0, 0, 0])


def test_dsl_profile_reports_every_level(cuda):
    """The DSL cycle breakdown tool at maxLevel 6: for the eager executor a
    time for every MGCycle level, summing to the cycle time of the same
    cycles; for the staged one its graphs and host reads; device activity
    in the trace and cycle times by block for both."""
    from exastencils_tpu_torch.runtime import dsl_profile

    r = dsl_profile.profile_variant(6, "eager", 2)
    assert sorted(r["exclusive_ms_by_level"]) == list(range(1, 7))
    assert abs(r["levels_sum_ms"] - r["levels_cycle_ms"]) <= 0.01
    s = dsl_profile.profile_variant(6, "staged", 2)
    assert s["staging"]["graphs"] > 0 and s["staging"]["unstaged"] == 0
    assert s["staging"]["host_reads_per_cycle"] == 1.0  # the coarsest CG's exit
    for v in (r, s):
        assert len(v["cycle_ms_by_block"]) == 4 and min(v["cycle_ms_by_block"]) > 0
        assert v["device_busy_ms_per_cycle"] > 0 and v["device_kernels_per_cycle"] > 0


# ----------------------------------------------------------------------
# staged execution: CUDA graphs (runtime/staging, dsl/interp_staging)
# ----------------------------------------------------------------------

STAGED_CYCLES = {
    "rbgs": ({}, {}, False),
    "jacobi": ({}, {"smoother": "Jac"}, False),
    "fas": ({"solver_useFAS": True}, {}, False),
    "v1_rbgs": ({}, {}, True),
    "v1_fas": ({"solver_useFAS": True}, {}, True),
}


def staged_solver(name, monkeypatch, dtype=torch.float32, max_level=5):
    knowledge_kw, model_kw, v1 = STAGED_CYCLES[name]
    if v1:
        monkeypatch.setenv("EXA_STREAM_V1", "1")
    f64 = dtype == torch.float64
    k = Knowledge(dimensionality=3, minLevel=0, maxLevel=max_level, useDblPrecision=f64,
                  tpu_compute_dtype="" if f64 else "float32", **knowledge_kw).update()
    return PoissonMGSolver(k, device="cuda", **model_kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(STAGED_CYCLES))
def test_staged_cycle_equals_eager_bitwise(cuda, monkeypatch, name, dtype):
    """The wrapped cycle replays CUDA graphs (captured after a warm-up with
    sync debug "error"): bit for bit the eager cycle, twice in a row, the
    iterate written back in place, the kernels counted per replay."""
    from exastencils_tpu_torch.runtime.staging import Staged

    ts = staged_solver(name, monkeypatch, dtype)
    assert isinstance(ts._cycle, Staged)
    sol, rhs = ts.init_state()
    e1 = ts.mg.cycle(sol.clone(), rhs).clone()
    e2 = ts.mg.cycle(e1.clone(), rhs).clone()
    x = sol.clone()
    assert ts._cycle(x, rhs) is x and torch.equal(x, e1)
    counters = [getattr(s3, fn) for fn in (
        "smooth_res_restrict", "prolong_correct_smooth", "rbgs_fused", "res_restrict",
        "prolong_correct", "rbgs_wavefront", "smooth_res_restrict_wavefront",
        "prolong_correct_smooth_wavefront")]
    n0 = [c.launches for c in counters]
    assert ts._cycle(x, rhs) is x and torch.equal(x, e2)
    assert sum(c.launches - k for c, k in zip(counters, n0)) > 0
    st = ts._cycle.stats
    assert st.captures == 1 and st.replays == 2 and st.graphs >= 3 and st.loops == 1
    assert st.pool_bytes > 0


def test_staged_capture_refuses_a_host_read(cuda):
    """A host read inside a staged function raises before capture (the
    warm-up runs with host reads forbidden and sync debug "error")."""
    from exastencils_tpu_torch.runtime import staging

    x = torch.ones(8, device="cuda")
    with pytest.raises(RuntimeError):
        staging.Staged(lambda a: a * float(a.sum()))(x)
    assert torch.cuda.get_sync_debug_mode() == 0


def test_held_iterate_is_unchanged_by_the_next_replay(cuda, monkeypatch):
    """A cycle's result held by the caller is not touched by a replay on
    another iterate, and a residual norm held from one replay is not
    overwritten by the next (results never stay in a graph pool)."""
    ts = staged_solver("rbgs", monkeypatch)
    sol, rhs = ts.init_state()
    a = ts._cycle(sol.clone(), rhs)
    held = a.clone()
    r_a = ts._res_norm(a, rhs)
    r_held = r_a.clone()
    b = ts._cycle(sol.clone(), rhs)
    ts._cycle(b, rhs)
    ts._res_norm(b, rhs)
    r_b = ts._res_norm(b, rhs)
    assert torch.equal(a, held) and torch.equal(r_a, r_held)
    assert not torch.equal(r_b, r_a)


def test_kernel_error_inside_a_staged_run_propagates(cuda, monkeypatch):
    ts = staged_solver("rbgs", monkeypatch)
    sol, rhs = ts.init_state()

    def boom(*args, **kwargs):
        raise RuntimeError("leg kernel failed")

    monkeypatch.setattr(ts.mg.levels[5], "down_leg_fn", boom)
    with pytest.raises(RuntimeError, match="leg kernel failed"):
        ts._cycle(sol.clone(), rhs)


def test_solve_fused_matches_solve_on_cuda(cuda, monkeypatch):
    """maxLevel 6 f64: the device-resident solve (one recording, a device
    loop over cycles) takes the staged solve's cycles to the same final
    residual and iterate, bit for bit."""
    a = staged_solver("rbgs", monkeypatch, torch.float64, max_level=6)
    sol, _, init, cur, it = a.solve(max_its=100, target_res_reduction=1e-10)
    b = staged_solver("rbgs", monkeypatch, torch.float64, max_level=6)
    f_sol, f_init, f_cur, f_it = b.solve_fused(max_its=100, target_res_reduction=1e-10)
    assert int(f_it) == it and float(f_cur) == cur and float(f_init) == init
    assert torch.equal(f_sol, sol)


@pytest.mark.parametrize("v1", [False, True])
def test_staged_dsl_equals_eager_bitwise(cuda, monkeypatch, v1):
    """The bench program at maxLevel 6 float32, staged (the default on
    CUDA) against jit_functions=False: every field and line bit for bit,
    MGCycle@finest one staged run with no run left eager."""
    from exastencils_tpu_torch.dsl.interpreter import L4Executable
    from exastencils_tpu_torch.dsl.parser import parse_l4

    if v1:
        monkeypatch.setenv("EXA_STREAM_V1", "1")
    out = {}
    for jit in (None, False):
        k = Knowledge(dimensionality=3, minLevel=1, maxLevel=6, useDblPrecision=False,
                      tpu_compute_dtype="float32", tpu_shard_dsl=False).update()
        lines = []
        ex = L4Executable(parse_l4(BENCH_EXA4), k, device="cuda", out=lines.append,
                          jit_functions=jit)
        ex.run()
        out[jit] = (ex, lines)
    (staged, l1), (eager, l0) = out[None], out[False]
    assert staged.jit_functions and not eager.jit_functions
    assert l1 == l0
    for key, t in eager.state.items():
        assert torch.equal(staged.state[key], t), key
    st = staged.staging_stats()
    assert st["unstaged"] == 0 and st["graphs"] > 0 and st["loops"] >= 1


def traced_float_bits(op, device):
    """A Python float and the 0-d float64 tensor a staged run traces it as
    (marked `py_float`) give the same bits and type against a float32 and
    a float64 field, a float32 0-d value (a reduction) and a traced int,
    on either side of the operator; two traced floats compute in float64,
    as Python does."""
    from exastencils_tpu_torch.dsl.interp_base import _apply_binop, is_py_float, py_float

    rng = np.random.default_rng(5)
    f32 = torch.from_numpy(rng.standard_normal((7, 9)).astype(np.float32)).to(device)
    operands = (f32, f32.double(), f32.sum(), torch.full((), 7, dtype=torch.int64, device=device))
    for v in (0.8, 1.0 / 3.0, 1e-3, np.pi, -2.5e7, 3.0000001):
        t = py_float(torch.full((), v, dtype=torch.float64, device=device))
        for x in operands:
            for lhs, rhs, tl, tr in ((x, v, x, t), (v, x, t, x)):
                got = _apply_binop(op, tl, tr)
                if x.dtype == torch.int64:  # a traced int: Python's float arithmetic
                    py = {"+": float.__add__, "-": float.__sub__, "*": float.__mul__,
                          "/": float.__truediv__, "<=": float.__le__, ">": float.__gt__}[op]
                    want = py(7.0, float(v)) if lhs is x else py(float(v), 7.0)
                    assert got.item() == want, (op, v)
                    continue
                want = _apply_binop(op, lhs, rhs)
                assert got.dtype == want.dtype, (op, v, x.dtype)
                assert torch.equal(got.cpu(), want.cpu()), (op, v, x.dtype, x.dim())
    a, b = 0.1, 0.7
    ta, tb = (py_float(torch.full((), u, dtype=torch.float64, device=device)) for u in (a, b))
    got = _apply_binop(op, ta, tb)
    assert got.item() == {"+": a + b, "-": a - b, "*": a * b, "/": a / b,
                          "<=": a <= b, ">": a > b}[op]
    assert is_py_float(got) == (op not in ("<=", ">"))


@pytest.mark.parametrize("op", ["+", "-", "*", "/", "<=", ">"])
def test_traced_float_gives_the_python_float_bits_on_cuda(cuda, op):
    """On the card a division by a Python float is a product with its
    reciprocal: the traced float gives the same bits there too."""
    traced_float_bits(op, "cuda")
