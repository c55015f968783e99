"""The block decomposition of the v1 kernels K6-K8 (csrc/cluster_legs3d.cu:
the fused smoother K6, LEG_SMOOTH, and the legs K7/K8), emulated in plain
PyTorch on the CPU.

The CUDA kernel cannot run here, so this file replays what each block of
each thread-block cluster computes: LEG_TILE^2 (y, x) tiles, where the
array's last node one past a tile goes to that tile (513 nodes: 16 tiles);
the grid rounded up to whole clusters, the padded blocks included; the
z-chunks of the wrapper's leg_chunk; a window with the halo of 2K nodes (K7:
2K+1 plus the restriction's reach; in x rounded up to even) on the
cluster's outer sides only, shrinking there by one node per half-sweep; on
the inner sides no halo, the neighbour across the edge read from the
neighbouring block's window as it stands after the last half-sweep; K7's
residual on each block's box (its tile, plus `reach` on outer sides), the
coarse taps across an inner edge read from the neighbour's box, each
coarse node written by one block; and the chained launches of a K deeper
than one launch holds (K6 before K7, after K8; K6 chained on itself).
Float64, held bitwise to the plain versions `smooth_res_restrict_plain` /
`prolong_correct_smooth_plain` / `rbgs_fused_plain` at odd shapes, with
K = 1..4 (K6: 1..5, with excl planes on tile, cluster and z-chunk edges);
a halo, an edge read, a box, a z-range or an excl mask one node short
breaks the equality."""

import pytest
import torch
from test_torch_legs import CASES, H100_SMS, NO_TAPS, OMEGA, SMOOTH_CASES, inputs, span, star, updatable

from exastencils_tpu_torch.ops.cuda import stream3d as s3
from exastencils_tpu_torch.ops.smoothers import jacobi_update
from exastencils_tpu_torch.ops.stencil_apply import apply_stencil
from exastencils_tpu_torch.ops.transfer import (
    apply_separable,
    prolongation_matrix_1d,
    restriction_matrix_1d,
    separable_kernels,
)

torch.set_num_threads(1)
T = s3.CLUSTER_TILE


def tiles(n, t):
    return -(-n // t)


def own_range(t0, n, nc):
    """cluster_legs3d.cu own_range: the fine nodes [f0, f1) and coarse nodes
    [c0, c1) a block writes along one dim from its tile origin t0, and
    whether its last fine node (n - 1, one past the tile) is copied."""
    takes, gives = t0 + T == n - 1, t0 == n - 1 and t0 > 0
    f0, f1 = (n if gives else t0), (n if takes else min(t0 + T, n))
    c0, c1 = t0 // 2, min(t0 // 2 + T // 2, nc)
    if takes and c1 == nc - 1:
        c1 = nc
    if gives and c0 == nc - 1:
        c0 = nc
    return f0, max(f1, f0), c0, max(c1, c0), takes


def tiles_for(n, nc, down):
    """cluster_legs3d.cu tiles_for: tiles along one dim."""
    t = (n - 2) // T + 1 if n > 1 else 1
    while down and own_range((t - 1) * T, n, nc)[3] < nc:
        t += 1
    return t


def emulate_cluster_launch(mode, sol, rhs, A, K, kern, lo, cluster, sol_c=None,
                           coarse_shape=None, chunk=None, halo_cut=0, z_cut=0,
                           edge=1, stale_edges=False, own_box_only=False, excl=s3.NO_EXCL,
                           excl_shift=0):
    """One cluster_leg launch, cluster by cluster and block by block, out of
    place: returns (new sol, coarse rhs or None) and checks that every
    output node is written by exactly one block.  `excl`: K6's excl planes.
    Faults the tests must catch: `halo_cut` shortens the outer halo,
    `z_cut` the half-sweeps' z-ranges below the chunk, `edge` = 0 drops the
    read across an inner edge, `stale_edges` reads the neighbour as it was
    before the launch, `own_box_only` restricts from the block's own
    residual box only, `excl_shift` moves the excl planes of the updatable
    mask."""
    down, up = mode == s3.LEG_RESTRICT, mode == s3.LEG_PROLONG
    shape = tuple(sol.shape)
    nz, ny, nx = shape
    cshape = tuple(coarse_shape) if down else tuple(sol_c.shape) if up else (0, 0, 0)
    nzc, nyc, nxc = cshape
    cy, cx = cluster
    CZ = s3.leg_chunk(shape, H100_SMS) if chunk is None else chunk
    reach = s3.restrict_reach(kern, lo) if down else 0
    hy = s3.leg_halo(mode, K, reach) - halo_cut
    hx = hy + hy % 2
    ty_n = tiles(tiles_for(ny, nyc, down), cy) * cy
    tx_n = tiles(tiles_for(nx, nxc, down), cx) * cx
    tz_n = max(tiles(nz, CZ), tiles(nzc, CZ // 2)) if down else tiles(nz, CZ)
    out, written = torch.zeros_like(sol), torch.zeros(shape, dtype=torch.int32)
    pc = None
    if up:  # P sol_c, as the plain version computes it
        pc = apply_separable([prolongation_matrix_1d(kern[d], lo[d], shape[d], cshape[d], shape[d])
                              for d in range(3)], sol_c)
    out_c = written_c = rmats = None
    if down:
        out_c = torch.zeros(cshape, dtype=sol.dtype)
        written_c = torch.zeros(cshape, dtype=torch.int32)
        rmats = [restriction_matrix_1d(kern[d], lo[d], cshape[d], shape[d], cshape[d])
                 for d in range(3)]
    for bz in range(tz_n):
        z0, z1, cz0, cz1, rz0, rz1, zf0, zf1 = span(bz, CZ, nz, nzc if down else 0, down, kern, lo)
        if zf0 > zf1:
            continue
        zw0, zw1 = zf0 - 2 * K, zf1 + 2 * K
        for Y in range(ty_n // cy):
            for X in range(tx_n // cx):
                # the cluster's windows together: its tiles plus the outer halo
                org = (zw0, Y * cy * T - hy, X * cx * T - hx)
                ext = (zw1 - zw0 + 1, cy * T + 2 * hy, cx * T + 2 * hx)
                gz, gy, gx = (torch.arange(o, o + e).reshape([-1 if d == i else 1 for i in range(3)])
                              for d, (o, e) in enumerate(zip(org, ext)))
                inside = (gz >= 0) & (gz < nz) & (gy >= 0) & (gy < ny) & (gx >= 0) & (gx < nx)
                idx = (gz.clamp(0, nz - 1), gy.clamp(0, ny - 1), gx.clamp(0, nx - 1))
                W = torch.where(inside, sol[idx], 0.0)
                F = torch.where(inside, rhs[idx], 0.0)
                upd = updatable(shape, [p + excl_shift if p >= 0 else p for p in excl], gz, gy, gx)
                if up:
                    W = torch.where(upd, W + pc[idx], W)
                W0 = W.clone()
                blocks = []
                for py in range(cy):
                    for px in range(cx):
                        ylo, yhi, xlo, xhi = py == 0, py == cy - 1, px == 0, px == cx - 1
                        ty0, tx0 = (Y * cy + py) * T, (X * cx + px) * T
                        # window rows/cols in the cluster array, and the
                        # extension by `edge` nodes on the inner sides
                        r0 = ty0 - (hy if ylo else 0) - org[1]
                        r1 = ty0 + T + (hy if yhi else 0) - org[1]
                        q0 = tx0 - (hx if xlo else 0) - org[2]
                        q1 = tx0 + T + (hx if xhi else 0) - org[2]
                        e = (0 if ylo else edge, 0 if yhi else edge, 0 if xlo else edge,
                             0 if xhi else edge)
                        ly = torch.arange(r1 - r0).reshape(-1, 1)
                        lx = torch.arange(q1 - q0).reshape(1, -1)
                        far = 1 << 20
                        dy = torch.minimum(ly if ylo else torch.full_like(ly, far),
                                           (r1 - r0 - 1 - ly) if yhi else torch.full_like(ly, far))
                        dx = torch.minimum(lx if xlo else torch.full_like(lx, far),
                                           (q1 - q0 - 1 - lx) if xhi else torch.full_like(lx, far))
                        blocks.append(dict(ty0=ty0, tx0=tx0, ylo=ylo, yhi=yhi, xlo=xlo, xhi=xhi,
                                           win=(r0, r1, q0, q1), e=e,
                                           dist=torch.minimum(dy, dx)))
                for lag in range(1, 2 * K + 1):
                    color = 0 if lag % 2 else 1
                    zr = (gz >= zf0 - (2 * K - lag) + z_cut) & (gz <= zf1 + (2 * K - lag))
                    before = W.clone()
                    for b in blocks:
                        r0, r1, q0, q1 = b["win"]
                        e = b["e"]
                        sl = (slice(None), slice(r0 - e[0], r1 + e[1]), slice(q0 - e[2], q1 + e[3]))
                        Wb = before[sl].clone()
                        if stale_edges:  # the extension as it was before the launch
                            keep = torch.zeros(Wb.shape[1:], dtype=torch.bool)
                            keep[e[0]:keep.shape[0] - e[1], e[2]:keep.shape[1] - e[3]] = True
                            Wb = torch.where(keep, Wb, W0[sl])
                        own = (slice(None), slice(e[0], e[0] + r1 - r0), slice(e[2], e[2] + q1 - q0))
                        mask = torch.zeros(Wb.shape, dtype=torch.bool)
                        mask[own] = (upd & zr & ((gz + gy + gx) % 2 == color))[
                            (slice(None), slice(r0, r1), slice(q0, q1))] & (b["dist"] >= lag)
                        Wb = jacobi_update(Wb, F[sl], A, OMEGA, mask)
                        W[(slice(None), slice(r0, r1), slice(q0, q1))] = Wb[own]
                R = torch.zeros_like(W)
                for b in blocks:
                    r0, r1, q0, q1 = b["win"]
                    wsl = (slice(None), slice(r0, r1), slice(q0, q1))
                    bgz, bgy, bgx = gz, gy[:, r0:r1], gx[:, :, q0:q1]
                    fy0, fy1, cy0, cy1, ycopy = own_range(b["ty0"], ny, nyc)
                    fx0, fx1, cx0, cx1, xcopy = own_range(b["tx0"], nx, nxc)
                    # the block's fine nodes from its window; a last row or
                    # column past the tile from sol
                    tile = ((bgz >= z0) & (bgz < z1) & (bgy >= fy0) & (bgy < min(fy1, b["ty0"] + T))
                            & (bgx >= fx0) & (bgx < min(fx1, b["tx0"] + T)) & inside[wsl])
                    tile = tile.expand(W[wsl].shape)
                    gidx = tuple(g.expand(W[wsl].shape)[tile] for g in (bgz, bgy, bgx))
                    out[gidx] = W[wsl][tile]
                    written[gidx] += 1
                    for copy, sel in ((xcopy, (slice(z0, z1), slice(fy0, fy1), nx - 1)),
                                      (ycopy, (slice(z0, z1), ny - 1,
                                               slice(fx0, nx - 1 if xcopy else min(fx1, b["tx0"] + T))))):
                        if copy:
                            out[sel] = sol[sel]
                            written[sel] += 1
                    if down and cz0 < cz1:
                        r0e, r1e, q0e, q1e = r0 - b["e"][0], r1 + b["e"][1], q0 - b["e"][2], q1 + b["e"][3]
                        esl = (slice(None), slice(r0e, r1e), slice(q0e, q1e))
                        res = torch.where(upd[esl], F[esl] - apply_stencil(A, W[esl]), 0.0)
                        res = res[:, r0 - r0e:r0 - r0e + r1 - r0, q0 - q0e:q0 - q0e + q1 - q0]
                        box = ((bgz >= rz0) & (bgz <= rz1)
                               & (bgy >= b["ty0"] - (reach if b["ylo"] else 0))
                               & (bgy < b["ty0"] + T + (reach if b["yhi"] else 0))
                               & (bgx >= b["tx0"] - (reach if b["xlo"] else 0))
                               & (bgx < b["tx0"] + T + (reach if b["xhi"] else 0)) & inside[wsl])
                        R[wsl] = torch.where(box, res, R[wsl])
                        b["box"] = box.expand(res.shape), res
                if down and cz0 < cz1:
                    for b in blocks:
                        r0, r1, q0, q1 = b["win"]
                        wsl = (slice(None), slice(r0, r1), slice(q0, q1))
                        src = R
                        if own_box_only:
                            src = torch.zeros_like(R)
                            src[wsl] = torch.where(b["box"][0], b["box"][1], 0.0)
                        rfull = torch.zeros_like(sol)
                        rin = inside.expand(W.shape)
                        rfull[tuple(g.expand(W.shape)[rin] for g in (gz, gy, gx))] = src[rin]
                        coarse = apply_separable(rmats, rfull)
                        _, _, cy0, cy1, _ = own_range(b["ty0"], ny, nyc)
                        _, _, cx0, cx1, _ = own_range(b["tx0"], nx, nxc)
                        out_c[cz0:cz1, cy0:cy1, cx0:cx1] = coarse[cz0:cz1, cy0:cy1, cx0:cx1]
                        written_c[cz0:cz1, cy0:cy1, cx0:cx1] += 1
    assert torch.equal(written, torch.ones_like(written)), "fine nodes written != once"
    if down:
        assert torch.equal(written_c, torch.ones_like(written_c)), "coarse nodes written != once"
    return out, out_c


def emulate_smoother(sol, rhs, A, K, excl, cluster, dtype=None):
    """rbgs_wavefront's K6 launches: chunks of up to max_wavefront_k (for
    `dtype`, default sol's) iterations, each out of place."""
    kmax = s3.max_wavefront_k(dtype or sol.dtype, cluster)
    while K > 0:
        sol, _ = emulate_cluster_launch(s3.LEG_SMOOTH, sol, rhs, A, min(K, kmax), *NO_TAPS, cluster,
                                        excl=excl)
        K -= kmax
    return sol


def emulate_leg(mode, sol, rhs, A, K, kern, lo, cluster, sol_c=None, coarse_shape=None):
    """The wrapper's call: one launch of up to max_cluster_k iterations, the
    rest as K6 (the plain smoother here) before K7's launch or after K8's."""
    reach = s3.restrict_reach(kern, lo) if mode == s3.LEG_RESTRICT else 0
    k = min(K, s3.max_cluster_k(sol.dtype, mode, reach, cluster))
    if mode == s3.LEG_RESTRICT and K > k:
        sol = s3.rbgs_fused_plain(sol, rhs, A, OMEGA, K - k)
    sol, out_c = emulate_cluster_launch(mode, sol, rhs, A, k, kern, lo, cluster, sol_c,
                                        coarse_shape)
    if mode == s3.LEG_PROLONG and K > k:
        sol = s3.rbgs_fused_plain(sol, rhs, A, OMEGA, K - k)
    return sol, out_c


LEG_CASES = ("odd_17x33x9", "l6_65", "l2_5", "cell_36x18x20", "two_chunks_139x9x17_excl")


def _case(name, seed):
    shape, cshape, (R, P), _ = CASES[name]  # K7/K8 take no excl planes
    sol, rhs, sol_c = inputs(shape, cshape, seed)
    return shape, cshape, R, P, sol, rhs, sol_c


@pytest.mark.parametrize("cluster", [s3.CLUSTER[s3.LEG_RESTRICT], (2, 2)])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("case", LEG_CASES)
def test_down_leg_cluster_decomposition_is_plain_k1(case, K, cluster):
    shape, cshape, R, _, sol, rhs, _ = _case(case, K)
    A, rk = star(K), separable_kernels(R)
    got, got_c = emulate_leg(s3.LEG_RESTRICT, sol, rhs, A, K, rk, R.lo, cluster,
                             coarse_shape=cshape)
    want, want_c = s3.smooth_res_restrict_plain(sol, rhs, A, OMEGA, K, rk, R.lo, cshape)
    assert torch.equal(got, want)
    assert torch.equal(got_c, want_c)


@pytest.mark.parametrize("cluster", [s3.CLUSTER[s3.LEG_PROLONG], (2, 2)])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("case", LEG_CASES)
def test_up_leg_cluster_decomposition_is_plain_k2(case, K, cluster):
    shape, cshape, _, P, sol, rhs, sol_c = _case(case, 10 + K)
    A, pk = star(K), separable_kernels(P)
    got, _ = emulate_leg(s3.LEG_PROLONG, sol, rhs, A, K, pk, P.lo, cluster, sol_c=sol_c)
    assert torch.equal(got, s3.prolong_correct_smooth_plain(sol, sol_c, rhs, A, OMEGA, K, pk, P.lo))


@pytest.mark.parametrize("cluster", [(4, 2), (2, 1), (1, 2), (1, 1)])
@pytest.mark.parametrize("mode", ["K7", "K8"])
def test_other_cluster_shapes(mode, cluster):
    """The shapes chip_smoke.py times, on 65^3 (two tiles a dim: a 4 x 2
    cluster has two padded rows of blocks) at K = 2."""
    shape, cshape, R, P, sol, rhs, sol_c = _case("l6_65", 30)
    A = star(2)
    if mode == "K7":
        rk = separable_kernels(R)
        got = emulate_leg(s3.LEG_RESTRICT, sol, rhs, A, 2, rk, R.lo, cluster, coarse_shape=cshape)
        want = s3.smooth_res_restrict_plain(sol, rhs, A, OMEGA, 2, rk, R.lo, cshape)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        pk = separable_kernels(P)
        got, _ = emulate_leg(s3.LEG_PROLONG, sol, rhs, A, 2, pk, P.lo, cluster, sol_c=sol_c)
        assert torch.equal(got, s3.prolong_correct_smooth_plain(sol, sol_c, rhs, A, OMEGA, 2, pk,
                                                                P.lo))


# K6's cases: K3's (excl planes on tile and z-chunk edges; a tile edge 31 |
# 32 is the inner edge of the clusters 1 x 2 (x) and 2 x 2 (y and x))
SMOOTHER_CASES = ("l6_65_excl_on_tile_edges", "odd_66x40x37_excl_on_edges",
                  "l6_65_excl_at_chunk_edge", "two_chunks_139x9x17_excl", "odd_17x33x9_excl",
                  "l2_5_excl")


@pytest.mark.parametrize("cluster", [s3.CLUSTER[s3.LEG_SMOOTH], (1, 2), (2, 2)])
@pytest.mark.parametrize("K", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("case", SMOOTHER_CASES)
def test_smoother_cluster_decomposition_is_plain_k6(case, K, cluster):
    """K6: rbgs_wavefront's launches (float64: 2 iterations a launch, 3 on
    2 x 2 clusters), bitwise rbgs_fused_plain with its excl planes."""
    shape, excl = SMOOTH_CASES[case]
    sol, rhs, _ = inputs(shape, (1, 1, 1), 60 + K)
    A = star(K)
    got = emulate_smoother(sol, rhs, A, K, excl, cluster)
    assert torch.equal(got, s3.rbgs_fused_plain(sol, rhs, A, OMEGA, K, excl))


@pytest.mark.parametrize("cluster", [(1, 1), (2, 1), (4, 2)])
def test_smoother_float32_depth(cluster):
    """K6's float32 launches hold 3 iterations (a window of 2K = 6 nodes on
    the cluster's outer sides): K = 5 is two, emulated in float64 over 65^3
    with excl planes on tile edges."""
    shape, excl = SMOOTH_CASES["l6_65_excl_on_tile_edges"]
    sol, rhs, _ = inputs(shape, (1, 1, 1), 70)
    A = star(5)
    assert s3.max_wavefront_k(torch.float32, cluster) == 3
    got = emulate_smoother(sol, rhs, A, 5, excl, cluster, dtype=torch.float32)
    assert torch.equal(got, s3.rbgs_fused_plain(sol, rhs, A, OMEGA, 5, excl))


FAULTS = {"outer_halo": ("K8", dict(halo_cut=1)), "z_range": ("K8", dict(z_cut=1)),
          "edge_read": ("K8", dict(edge=0)), "stale_edge": ("K8", dict(stale_edges=True)),
          "k7_edge_read": ("K7", dict(edge=0)), "own_box_only": ("K7", dict(own_box_only=True)),
          "k6_outer_halo": ("K6", dict(halo_cut=1)), "k6_edge_read": ("K6", dict(edge=0)),
          "k6_excl_mask": ("K6", dict(excl_shift=1))}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_short_decomposition_breaks_the_equality(fault):
    """The check has teeth: each fault, on 2 x 2 clusters over 65^3 at K = 2
    (two z-chunks for the z-range), differs from the plain version.  K8's
    halo is exactly 2K (K7's 2K+1+reach has a node to spare in y)."""
    mode, kw = FAULTS[fault]
    name = "two_chunks_139x9x17_excl" if fault == "z_range" else "l6_65"
    shape, cshape, R, P, sol, rhs, sol_c = _case(name, 40)
    A = star(2)
    if mode == "K6":
        excl = SMOOTH_CASES["l6_65_excl_on_tile_edges"][1]
        want = s3.rbgs_fused_plain(sol, rhs, A, OMEGA, 2, excl)
        got, _ = emulate_cluster_launch(s3.LEG_SMOOTH, sol, rhs, A, 2, *NO_TAPS, (2, 2), excl=excl,
                                        **kw)
        assert not torch.equal(got, want)
    elif mode == "K7":
        rk = separable_kernels(R)
        want = s3.smooth_res_restrict_plain(sol, rhs, A, OMEGA, 2, rk, R.lo, cshape)
        got = emulate_cluster_launch(s3.LEG_RESTRICT, sol, rhs, A, 2, rk, R.lo, (2, 2),
                                     coarse_shape=cshape, **kw)
        assert not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    else:
        pk = separable_kernels(P)
        want = s3.prolong_correct_smooth_plain(sol, sol_c, rhs, A, OMEGA, 2, pk, P.lo)
        got, _ = emulate_cluster_launch(s3.LEG_PROLONG, sol, rhs, A, 2, pk, P.lo, (2, 2),
                                        sol_c=sol_c, **kw)
        assert not torch.equal(got, want)


def test_tiles_and_ownership():
    """513 nodes make 16 tiles (the last takes node 512, a boundary node,
    and the coarse node 256), where legs3d.cu has 17; K7's grid also
    covers the coarse array; every node has one owner."""
    assert [tiles_for(n, (n + 1) // 2, False) for n in (513, 257, 65, 33, 17, 5)] == \
        [16, 8, 2, 1, 1, 1]
    assert tiles_for(36, 18, True) == 2 and tiles_for(34, 17, True) == 2
    assert own_range(480, 513, 257) == (480, 513, 240, 257, True)
    assert own_range(512, 513, 257)[:4] == (513, 513, 257, 257)
    for n, nc in ((513, 257), (65, 33), (33, 17), (36, 18), (34, 17), (9, 5)):
        t = tiles_for(n, nc, True)
        fine = [f for b in range(t + 1) for f in range(*own_range(b * T, n, nc)[:2])]
        coarse = [c for b in range(t + 1) for c in range(*own_range(b * T, n, nc)[2:4])]
        assert fine == list(range(n)) and coarse == list(range(nc))


def test_cluster_depths_and_launch_shapes():
    """One launch up to 3 iterations in float32 for every cluster shape, in
    float64 K8 2 and K7 1; the shared memory within one block's 227 KB
    and the threads within 1024 (768 at two pairs a thread); the window of
    a block sharing its x-halo in pairs (K7's default) is 48 x 40 nodes at
    K = 3, against 48 x 48 without sharing."""
    for cluster in s3.CLUSTER_SHAPES:
        assert [s3.max_cluster_k(dt, m, 1, cluster) for dt in (torch.float32, torch.float64)
                for m in (s3.LEG_PROLONG, s3.LEG_RESTRICT)] == [3, 3, 2, 1]
        for mode, reach in ((s3.LEG_PROLONG, 0), (s3.LEG_RESTRICT, 1)):
            for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
                k = s3.max_cluster_k(dtype, mode, reach, cluster)
                assert s3._cluster_smem(mode, k, reach, size, cluster) <= s3.SMEM_LIMIT
                rows, rx = s3._cluster_window(mode, k, reach, cluster)
                limit = s3.CLUSTER_THREADS if rows * rx // 2 <= s3.CLUSTER_THREADS else 768
                assert s3._cluster_threads(mode, k, reach, cluster) <= limit
    assert s3._cluster_window(s3.LEG_RESTRICT, 3, 1, (1, 2)) == (48, 40)
    assert s3._cluster_window(s3.LEG_RESTRICT, 3, 1, (1, 1)) == (48, 48)
    assert s3._cluster_window(s3.LEG_PROLONG, 3, 0, (2, 2)) == (38, 38)
