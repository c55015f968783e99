"""The block decomposition of the one-launch legs K1/K2 and of the fused
smoother K3 (csrc/legs3d.cu, LEG_SMOOTH), emulated in plain PyTorch on the
CPU.

The CUDA kernel cannot run here, so this file replays what each of its
blocks computes: a LEG_TILE^2 (y, x) tile of a z-chunk (the wrapper's
leg_chunk, or LEG_CHUNK planes), a window with a halo of 2K nodes (K1:
2K+1 plus the restriction's reach), half-sweep l on the planes within
2K-l of the chunk's final planes and on the window minus its outer l
nodes, the out-of-place write of the tile, K1's residual box and its
coarse planes (each written by one block), and the chain of launches of a K deeper than one launch
holds (leg_chain).  Float64, held bitwise to the plain versions
`smooth_res_restrict_plain` / `prolong_correct_smooth_plain` /
`rbgs_fused_plain`, at odd shapes, the smallest level, with excl planes
(K3 also on tile and z-chunk edges) and K = 1..4 (K3 1..5); a halo, a
z-range or an excl mask one node short breaks the equality."""

import pytest
import torch

from exastencils_tpu_torch.core.stencil import (
    BoundStencil,
    cell_prolongation,
    cell_restriction,
    node_prolongation,
    node_restriction,
)
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
OMEGA = 0.8
TY = TX = s3.LEG_TILE
H100_SMS = 132


def star(seed=0):
    """A constant 7-point star with distinct coefficients (centre, z-, z+,
    y-, y+, x-, x+), so a neighbour read from the wrong side shows."""
    g = torch.Generator().manual_seed(seed)
    c = (-torch.rand(6, generator=g, dtype=torch.float64) - 0.5).tolist()
    offs = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))
    return BoundStencil("A", offs, (6.5, *c))


def tiles(n, t):
    return -(-n // t)


def span(bz, CZ, nz, nzc, down, r_kern, r_lo):
    """legs3d.cu span_for: fine output planes [z0, z1), coarse planes
    [cz0, cz1), residual planes [rz0, rz1], final planes [zf0, zf1]."""
    z0 = bz * CZ
    z1 = min(z0 + CZ, nz)
    zf0, zf1, cz0, cz1, rz0, rz1 = z0, z1 - 1, 0, 0, 0, -1
    if down:
        cz0, cz1 = bz * (CZ // 2), min(bz * (CZ // 2) + CZ // 2, nzc)
        if cz0 < cz1:
            rz0 = max(2 * cz0 + r_lo[0], 0)
            rz1 = min(2 * (cz1 - 1) + r_lo[0] + len(r_kern[0]) - 1, nz - 1)
            zf0, zf1 = min(zf0, rz0 - 1), max(zf1, rz1 + 1)
    return z0, z1, cz0, cz1, rz0, rz1, max(zf0, 0), min(zf1, nz - 1)


def updatable(shape, excl, z, y, x):
    """The kernels' updatable() on global index grids (broadcasting)."""
    nz, ny, nx = shape
    ok = (z >= 1) & (z <= nz - 2) & (y >= 1) & (y <= ny - 2) & (x >= 1) & (x <= nx - 2)
    for d, g in enumerate((z, y, x)):
        for p in excl[2 * d:2 * d + 2]:
            if p >= 0:
                ok = ok & (g != p)
    return ok


def emulate_launch(mode, sol, rhs, A, K, kern, lo, excl, sol_c=None, coarse_shape=None,
                   halo_cut=0, z_cut=0, chunk=None, excl_shift=0, geom=None):
    """One leg_kernel launch, block by block, out of place: returns
    (new sol, coarse rhs or None) and checks that every output node is
    written by exactly one block.  `chunk`: the fine z-planes of a block
    (default: the wrapper's choice on an H100's 132 SMs).  `halo_cut`
    shortens the halo, `z_cut` the half-sweeps' z-ranges below the chunk
    and `excl_shift` moves the excl planes of the updatable mask (faults
    the tests must catch).  `geom`: K1's Coarse geometry (legs3d.cu; the
    12 ints of stream3d.coarse_geometry, `lo` then the aligned taps' lo):
    blocks restrict aligned coarse nodes, written at array index + off
    where inside the window [lo, hi]; default the dense geometry."""
    down, up = mode == s3.LEG_RESTRICT, mode == s3.LEG_PROLONG
    shape = tuple(sol.shape)
    nz, ny, nx = shape
    if down and geom is None:
        geom = (0, 0, 0, *coarse_shape, 0, 0, 0, *(n - 1 for n in coarse_shape))
    if down:
        off, cn, wlo, whi = geom[0:3], geom[3:6], geom[6:9], geom[9:12]
    CZ = s3.leg_chunk(shape, H100_SMS) if chunk is None else chunk
    reach = s3.restrict_reach(kern, lo) if down else 0
    halo = s3.leg_halo(mode, K, reach) - halo_cut
    RY, RX = TY + 2 * halo, TX + 2 * halo
    out, written = torch.zeros_like(sol), torch.zeros(shape, dtype=torch.int32)
    pc = None
    if up:  # P sol_c, as the plain version computes it
        mats = [prolongation_matrix_1d(kern[d], lo[d], shape[d], sol_c.shape[d], shape[d])
                for d in range(3)]
        pc = apply_separable(mats, sol_c)
    out_c = written_c = rmats = None
    if down:
        out_c = torch.zeros(coarse_shape, dtype=sol.dtype)
        written_c = torch.zeros(coarse_shape, dtype=torch.int32)
        rmats = [restriction_matrix_1d(kern[d], lo[d], cn[d], shape[d], cn[d]) for d in range(3)]
    grid = [tiles(nz, CZ), tiles(ny, TY), tiles(nx, TX)]
    if down:
        grid = [max(grid[0], tiles(cn[0], CZ // 2)),
                max(grid[1], tiles(cn[1], TY // 2)),
                max(grid[2], tiles(cn[2], TX // 2))]
    for bz in range(grid[0]):
        z0, z1, cz0, cz1, rz0, rz1, zf0, zf1 = span(bz, CZ, nz, cn[0] if down else 0,
                                                   down, kern, lo)
        if zf0 > zf1:
            continue
        zw0, zw1 = zf0 - 2 * K, zf1 + 2 * K  # window planes (those outside the array: 0)
        for by in range(grid[1]):
            for bx in range(grid[2]):
                ty0, tx0 = by * TY, bx * TX
                org = (zw0, ty0 - halo, tx0 - halo)
                ext = (zw1 - zw0 + 1, RY, RX)
                gz, gy, gx = (torch.arange(o, o + e).reshape([-1 if d == i else 1 for i in range(3)])
                              for d, (o, e) in enumerate(zip(org, ext)))
                inside = (gz >= 0) & (gz < nz) & (gy >= 0) & (gy < ny) & (gx >= 0) & (gx < nx)
                idx = (gz.clamp(0, nz - 1), gy.clamp(0, ny - 1), gx.clamp(0, nx - 1))
                W = torch.where(inside, sol[idx], 0.0)
                F = torch.where(inside, rhs[idx], 0.0)
                upd = updatable(shape, [p + excl_shift if p >= 0 else p for p in excl], gz, gy, gx)
                if up:
                    W = torch.where(upd, W + pc[idx], W)
                ly, lx = gy - org[1], gx - org[2]
                for lag in range(1, 2 * K + 1):
                    color = 0 if lag % 2 else 1
                    zr = (gz >= zf0 - (2 * K - lag) + z_cut) & (gz <= zf1 + (2 * K - lag))
                    region = (ly >= lag) & (ly < RY - lag) & (lx >= lag) & (lx < RX - lag)
                    mask = upd & zr & region & ((gz + gy + gx) % 2 == color)
                    W = jacobi_update(W, F, A, OMEGA, mask)
                tile = (gz >= z0) & (gz < z1) & (ly >= halo) & (ly < halo + TY) & \
                    (lx >= halo) & (lx < halo + TX) & inside
                tile = tile.expand(W.shape)
                gidx = tuple(g.expand(W.shape)[tile] for g in (gz, gy, gx))
                out[gidx] = W[tile]
                written[gidx] += 1
                if down and cz0 < cz1:
                    res = torch.where(upd, F - apply_stencil(A, W), 0.0)
                    box = (gz >= rz0) & (gz <= rz1) & (ly >= halo - reach) & \
                        (ly < halo + TY + reach) & (lx >= halo - reach) & \
                        (lx < halo + TX + reach) & inside
                    box = box.expand(W.shape)
                    rfull = torch.zeros_like(sol)
                    rfull[tuple(g.expand(W.shape)[box] for g in (gz, gy, gx))] = res[box]
                    coarse = apply_separable(rmats, rfull)
                    # the block's aligned coarse tile, then its array nodes
                    # inside the window
                    a0 = (cz0, ty0 // 2, tx0 // 2)
                    a1 = (cz1, min(ty0 // 2 + TY // 2, cn[1]), min(tx0 // 2 + TX // 2, cn[2]))
                    lo_a = [max(a0[d], wlo[d] - off[d]) for d in range(3)]
                    hi_a = [min(a1[d], whi[d] - off[d] + 1) for d in range(3)]
                    if all(lo_a[d] < hi_a[d] for d in range(3)):
                        src = tuple(slice(lo_a[d], hi_a[d]) for d in range(3))
                        dst = tuple(slice(lo_a[d] + off[d], hi_a[d] + off[d]) for d in range(3))
                        out_c[dst] = coarse[src]
                        written_c[dst] += 1
    assert torch.equal(written, torch.ones_like(written)), "fine nodes written != once"
    if down:
        want = torch.zeros_like(written_c)
        want[tuple(slice(max(wlo[d], off[d]), min(whi[d] + 1, off[d] + cn[d]))
                   for d in range(3))] = 1
        assert torch.equal(written_c, want), "coarse nodes written != once in the window"
    return out, out_c


def emulate_leg(mode, sol, rhs, A, K, kern, lo, excl, sol_c=None, coarse_shape=None,
                chunk=None, dtype=None, ghost=s3.NO_GHOST):
    """The wrapper's chain of launches (leg_chain for `dtype`, default
    sol's), each out of place; `ghost` a halo-extended fragment's
    geometry, as the wrapper passes it (_leg_launches)."""
    geom = None
    if mode == s3.LEG_RESTRICT:
        lo, geom = s3.coarse_geometry(sol.shape, coarse_shape, lo, ghost)
    elif mode == s3.LEG_PROLONG:
        lo = tuple(lo[d] - ghost[d] for d in range(3))
    reach = s3.restrict_reach(kern, lo) if mode == s3.LEG_RESTRICT else 0
    out_c = None
    for m, k in s3.leg_chain(mode, K, dtype or sol.dtype, reach):
        sol, c = emulate_launch(m, sol, rhs, A, k, kern, lo, excl, sol_c, coarse_shape,
                                chunk=chunk, geom=geom)
        out_c = c if c is not None else out_c
    return sol, out_c


NODE = (node_restriction(3), node_prolongation(3))
CELL = (cell_restriction(3), cell_prolongation(3))
# (fine shape, coarse shape, transfers, excl planes (z lo/hi, y lo/hi, x lo/hi))
CASES = {
    "odd_17x33x9": ((17, 33, 9), (9, 17, 5), NODE, s3.NO_EXCL),
    "odd_17x33x9_excl": ((17, 33, 9), (9, 17, 5), NODE, (2, 14, -1, 20, 1, -1)),
    "l6_65": ((65,) * 3, (33,) * 3, NODE, s3.NO_EXCL),
    "l6_65_excl_at_chunk_edge": ((65,) * 3, (33,) * 3, NODE, (31, 33, -1, 16, 15, -1)),
    "l2_5": ((5,) * 3, (3,) * 3, NODE, s3.NO_EXCL),
    "l2_5_excl": ((5,) * 3, (3,) * 3, NODE, (2, -1, -1, -1, 1, -1)),
    "cell_36x18x20": ((36, 18, 20), (18, 9, 10), CELL, s3.NO_EXCL),
    "two_chunks_139x9x17_excl": ((139, 9, 17), (70, 5, 9), NODE, (127, 129, -1, -1, 8, -1)),
}
# K3's excl planes on block edges: y and x planes on both sides of a tile
# edge (31 | 32) and z planes on both sides of a z-chunk edge (the wrapper
# takes 4 planes a chunk at these sizes)
SMOOTH_CASES = {
    **{name: (shape, excl) for name, (shape, _, _, excl) in CASES.items()},
    "l6_65_excl_on_tile_edges": ((65,) * 3, (3, 4, 31, 32, 32, 63)),
    "odd_66x40x37_excl_on_edges": ((66, 40, 37), (7, 8, 32, -1, 31, 33)),
}
NO_TAPS = (((0.0,),) * 3, (0, 0, 0))


def inputs(shape, coarse_shape, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(s, generator=g, dtype=torch.float64)
                 for s in (shape, shape, coarse_shape))


@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_down_leg_decomposition_is_plain_k1(case, K):
    shape, cshape, (R, _), excl = CASES[case]
    sol, rhs, _ = inputs(shape, cshape, K)
    A, rk = star(K), separable_kernels(R)
    got, got_c = emulate_leg(s3.LEG_RESTRICT, sol, rhs, A, K, rk, R.lo, excl,
                             coarse_shape=cshape)
    want, want_c = s3.smooth_res_restrict_plain(sol, rhs, A, OMEGA, K, rk, R.lo, cshape, excl)
    assert torch.equal(got, want)
    assert torch.equal(got_c, want_c)


@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_up_leg_decomposition_is_plain_k2(case, K):
    shape, cshape, (_, P), excl = CASES[case]
    sol, rhs, sol_c = inputs(shape, cshape, 10 + K)
    A, pk = star(K), separable_kernels(P)
    got, _ = emulate_leg(s3.LEG_PROLONG, sol, rhs, A, K, pk, P.lo, excl, sol_c=sol_c)
    assert torch.equal(got, s3.prolong_correct_smooth_plain(sol, sol_c, rhs, A, OMEGA, K, pk,
                                                            P.lo, excl))


# One rank's halo-extended fragment on the sharded path (ops/cuda
# make_sharded_fused_legs_3d): (local cells, ghost per dim, excl planes of
# the rank).  The smallest fragment the legs admit at K = 1 (ghost 4);
# unequal cells at ghost 8, the low corner rank and the high one; x
# unsharded (ghost 0); an odd ghost width (9).
GHOSTED = {
    "smallest_g4_low": ((2, 2, 2), (4, 4, 4), (4, -1, 4, -1, 4, -1)),
    "cells_6x10x14_g8_low": ((6, 10, 14), (8, 8, 8), (8, -1, 8, -1, 8, -1)),
    "cells_6x10x14_g8_high": ((6, 10, 14), (8, 8, 8), (-1, 14, -1, 18, -1, 22)),
    "x_unsharded": ((10, 6, 32), (8, 8, 0), (-1, 14, 8, -1, 0, 32)),
    "odd_g9": ((6, 6, 6), (9, 9, 9), (9, -1, -1, 15, 9, -1)),
}


def ghosted(case):
    cells, ghost, excl = GHOSTED[case]
    shape = tuple(n + 1 + 2 * g for n, g in zip(cells, ghost))
    cshape = tuple(n // 2 + 1 + 2 * g for n, g in zip(cells, ghost))
    return shape, cshape, ghost, excl


@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(GHOSTED))
def test_ghosted_legs_decomposition_is_plain(case, K):
    """K1 and K2 on a halo-extended fragment: K1's blocks restrict aligned
    coarse nodes (the taps' lo shifted by the ghost width's parity only,
    so the window's halo stays that of the dense node restriction, also
    for an odd ghost width) into the coarse write window, zeros
    elsewhere; K2 prolongs over the whole
    fragment with the taps' lo shifted by the ghost width.  Sol bitwise,
    the coarse rhs within 1e-12 (its matrices are shaped otherwise)."""
    shape, cshape, ghost, excl = ghosted(case)
    sol, rhs, sol_c = inputs(shape, cshape, 60 + K)
    A, (R, P) = star(K), NODE
    rk, pk = separable_kernels(R), separable_kernels(P)
    lo_eff, _ = s3.coarse_geometry(shape, cshape, R.lo, ghost)
    assert s3.restrict_reach(rk, lo_eff) == 1
    got, got_c = emulate_leg(s3.LEG_RESTRICT, sol, rhs, A, K, rk, R.lo, excl, coarse_shape=cshape,
                             ghost=ghost)
    want, want_c = s3.smooth_res_restrict_plain(sol, rhs, A, OMEGA, K, rk, R.lo, cshape, excl,
                                                ghost=ghost)
    assert torch.equal(got, want)
    assert torch.allclose(got_c, want_c, rtol=0, atol=1e-12)
    got, _ = emulate_leg(s3.LEG_PROLONG, sol, rhs, A, K, pk, P.lo, excl, sol_c=sol_c, ghost=ghost)
    assert torch.equal(got, s3.prolong_correct_smooth_plain(sol, sol_c, rhs, A, OMEGA, K, pk,
                                                            P.lo, excl, ghost=ghost))


@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("mode", ["K1", "K2"])
def test_largest_chunk(mode, K):
    """Blocks of LEG_CHUNK planes, which the wrapper takes at 513^3 (the
    cases above are small enough for it to halve the chunk down to 4),
    across a chunk edge with excl planes beside it."""
    shape, cshape, (R, P), excl = CASES["two_chunks_139x9x17_excl"]
    sol, rhs, sol_c = inputs(shape, cshape, 20 + K)
    A = star(K)
    if mode == "K1":
        rk = separable_kernels(R)
        got = emulate_leg(s3.LEG_RESTRICT, sol, rhs, A, K, rk, R.lo, excl, coarse_shape=cshape,
                          chunk=s3.LEG_CHUNK)
        want = s3.smooth_res_restrict_plain(sol, rhs, A, OMEGA, K, rk, R.lo, cshape, excl)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        pk = separable_kernels(P)
        got, _ = emulate_leg(s3.LEG_PROLONG, sol, rhs, A, K, pk, P.lo, excl, sol_c=sol_c,
                             chunk=s3.LEG_CHUNK)
        assert torch.equal(got, s3.prolong_correct_smooth_plain(sol, sol_c, rhs, A, OMEGA, K, pk,
                                                                P.lo, excl))


def test_chunk_choice():
    """The wrapper's z-chunk per level on an H100 (132 SMs): 128 planes at
    513^3, halved to give every SM two blocks on the smaller levels."""
    assert [s3.leg_chunk((n,) * 3, H100_SMS) for n in (513, 257, 129, 65, 33, 5)] == \
        [128, 64, 8, 4, 4, 4]


@pytest.mark.parametrize("K", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("case", sorted(SMOOTH_CASES))
def test_smoother_decomposition_is_plain_k3(case, K):
    """K3: the LEG_SMOOTH launches of one rbgs_fused call (float64: 2
    iterations a launch, so K = 3..5 chain), bitwise rbgs_fused_plain."""
    shape, excl = SMOOTH_CASES[case]
    sol, rhs, _ = inputs(shape, (1, 1, 1), 30 + K)
    A = star(K)
    got, _ = emulate_leg(s3.LEG_SMOOTH, sol, rhs, A, K, *NO_TAPS, excl)
    assert torch.equal(got, s3.rbgs_fused_plain(sol, rhs, A, OMEGA, K, excl))


@pytest.mark.parametrize("chunk", [None, s3.LEG_CHUNK])
@pytest.mark.parametrize("K", [3, 5])
def test_smoother_float32_chain(K, chunk):
    """K3's float32 launches (3 iterations a launch, a window of 2K = 6
    nodes around the tile: K = 3 one launch, K = 5 two), emulated in
    float64 on excl planes at tile and chunk edges, with the wrapper's
    z-chunk and with LEG_CHUNK (two chunks of 139 planes)."""
    shape, excl = ((139, 40, 37), (127, 128, 31, 32, 32, 33))
    sol, rhs, _ = inputs(shape, (1, 1, 1), 40 + K)
    A = star(K)
    assert len(s3.leg_chain(s3.LEG_SMOOTH, K, torch.float32)) == (K + 2) // 3
    got, _ = emulate_leg(s3.LEG_SMOOTH, sol, rhs, A, K, *NO_TAPS, excl, chunk=chunk,
                         dtype=torch.float32)
    assert torch.equal(got, s3.rbgs_fused_plain(sol, rhs, A, OMEGA, K, excl))


@pytest.mark.parametrize("fault", ["halo", "z_range", "excl_mask"])
def test_short_smoother_breaks_the_equality(fault):
    """K3's check has teeth: a window one node short of 2K, half-sweeps one
    plane short of the chunk's z-halo, or excl planes one node off in the
    updatable mask differ from the plain version."""
    shape, excl = SMOOTH_CASES["l6_65_excl_on_tile_edges"]
    sol, rhs, _ = inputs(shape, (1, 1, 1), 50)
    A = star(50)
    kw = {"halo": dict(halo_cut=1), "z_range": dict(z_cut=1), "excl_mask": dict(excl_shift=1)}
    got, _ = emulate_launch(s3.LEG_SMOOTH, sol, rhs, A, 2, *NO_TAPS, excl, **kw[fault])
    assert not torch.equal(got, s3.rbgs_fused_plain(sol, rhs, A, OMEGA, 2, excl))


@pytest.mark.parametrize("cut", ["halo", "z_range"])
def test_short_window_breaks_the_equality(cut):
    """The check has teeth: a K2 window one node short of 2K in y/x, or
    half-sweeps one plane short of the chunk's z-halo, differ from the
    plain version."""
    case = "l6_65" if cut == "halo" else "two_chunks_139x9x17_excl"  # > one tile / chunk
    shape, cshape, (_, P), _ = CASES[case]
    excl = s3.NO_EXCL
    sol, rhs, sol_c = inputs(shape, cshape, 0)
    A, pk = star(0), separable_kernels(P)
    want = s3.prolong_correct_smooth_plain(sol, sol_c, rhs, A, OMEGA, 2, pk, P.lo)
    got, _ = emulate_launch(s3.LEG_PROLONG, sol, rhs, A, 2, pk, P.lo, excl, sol_c=sol_c,
                            halo_cut=int(cut == "halo"), z_cut=int(cut == "z_range"))
    assert not torch.equal(got, want)


def test_chain_and_depths():
    """One launch up to max_leg_k (3 in float32; in float64 K2 and K3 2 and
    K1 1 with the node restriction), the smem of each within one block's
    227 KB and its threads within 1024 (K1: 768); deeper K chains: K2 and
    K3 smooth after their first launch, K1 before its last; K3 with K = 0
    launches nothing."""
    f32, f64 = torch.float32, torch.float64
    modes = (s3.LEG_SMOOTH, s3.LEG_PROLONG, s3.LEG_RESTRICT)
    assert [s3.max_leg_k(f32, m) for m in modes] == [3, 3, 3]
    assert [s3.max_leg_k(f64, m) for m in modes] == [2, 2, 1]
    for dtype, size in ((f32, 4), (f64, 8)):
        for mode in modes:
            k = s3.max_leg_k(dtype, mode)
            assert s3._leg_smem(mode, k, 1, size) <= s3.SMEM_LIMIT
            assert s3._leg_threads(mode, k, 1) <= (768 if mode == s3.LEG_RESTRICT else 1024)
            assert (k == s3.MAX_LEG_K or s3._leg_smem(mode, k + 1, 1, size) > s3.SMEM_LIMIT
                    or s3._leg_threads(mode, k + 1, 1) > (768 if mode == s3.LEG_RESTRICT else 1024))
    assert s3.leg_chain(s3.LEG_PROLONG, 3, f32) == [(s3.LEG_PROLONG, 3)]
    assert s3.leg_chain(s3.LEG_RESTRICT, 3, f32) == [(s3.LEG_RESTRICT, 3)]
    assert s3.leg_chain(s3.LEG_RESTRICT, 4, f64) == [(s3.LEG_SMOOTH, 2), (s3.LEG_SMOOTH, 1),
                                                     (s3.LEG_RESTRICT, 1)]
    assert s3.leg_chain(s3.LEG_PROLONG, 7, f32) == [(s3.LEG_PROLONG, 3), (s3.LEG_SMOOTH, 3),
                                                    (s3.LEG_SMOOTH, 1)]
    assert s3.leg_chain(s3.LEG_SMOOTH, 3, f32) == [(s3.LEG_SMOOTH, 3)]
    assert s3.leg_chain(s3.LEG_SMOOTH, 5, f64) == [(s3.LEG_SMOOTH, 2)] * 2 + [(s3.LEG_SMOOTH, 1)]
    assert s3.leg_chain(s3.LEG_SMOOTH, 0, f32) == []
