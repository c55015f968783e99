"""The block decomposition of the fused transfers K4 (stream3d.cu
restrict_kernel) and K5 (prolong_kernel), emulated in plain PyTorch on the
CPU.

The CUDA kernels cannot run here, so this file replays what each of their
blocks computes, step by step in z: K5's tiles of inner fine nodes
(UP_TILE) and z-chunks, the coarse box of a tile loaded into a ring of four
slots by coarse plane, its z-sums formed once per fine plane into two slots,
each fine node's y then x taps; K4's coarse tiles (DOWN_TILE, the last tile
of a dim one node more) and z-chunks, the sol window with its one-node halo
and the rhs window streamed through rings of TRANSFER_AHEAD + 3 slots, the
residual of every window node computed once and added into the running
z-sums of its coarse planes (by plane parity, each started from zero at
the plane's first tap), a completed plane's y then x taps summed the step
after.  Float64.

The replay is held bit for bit (the bit patterns, so that a -0 counts) to a
transcription of the per-node order the kernels keep (z taps innermost, then
y, then x, each sum from +0 in increasing tap order, a tap outside the array
skipped), and within 1e-12 of the JAX package's Pallas kernels in interpret
mode.  Faults must break it: a halo one node short, a z-chunk edge off by
one, a zero correction added on the Dirichlet ring instead of skipped."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exastencils_tpu.core.stencil import cell_prolongation as j_cell_prolongation
from exastencils_tpu.core.stencil import cell_restriction as j_cell_restriction
from exastencils_tpu.core.stencil import node_prolongation as j_node_prolongation
from exastencils_tpu.core.stencil import node_restriction as j_node_restriction
from exastencils_tpu.ops.pallas.stream3d import prolong_correct_fused_3d, res_restrict_fused_3d
from exastencils_tpu.ops.transfer import build_prolong_mats, build_restrict_mats
from exastencils_tpu.ops.transfer import separable_kernels as j_separable_kernels

from exastencils_tpu_torch.core.stencil import (
    BoundStencil,
    cell_prolongation,
    cell_restriction,
    node_prolongation,
    node_restriction,
)
from exastencils_tpu_torch.ops.cuda import stream3d as s3
from exastencils_tpu_torch.ops.transfer import separable_kernels

torch.set_num_threads(1)
UTY, UTX = s3.UP_TILE
DTY, DTX = s3.DOWN_TILE
MT = s3.MAX_TAPS
BOXY, BOXX = (UTY + MT) // 2 + 1, (UTX + MT) // 2 + 1  # K5's coarse box (kUpBoxY, kUpBoxX)
SLOTS = s3.TRANSFER_AHEAD + 3  # K4's ring slots (kDownSlots)
H100_SMS = 132
COEFS = (6.5, -0.9, -1.1, -0.7, -1.3, -0.95, -1.05)  # centre, z-, z+, y-, y+, x-, x+
OFFS = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))


def bits(t):
    return t.contiguous().view(torch.int64)


def floor_half(a):
    return a // 2


def padded(kern):
    """Per-dim taps padded with zeros to MAX_TAPS (the kernels' Taps)."""
    return [list(map(float, k)) + [0.0] * (MT - len(k)) for k in kern]


def tap_pair(f, nc, w, n, lo):
    """star3d.cuh tap_pair on an index tensor: (c0, v0, v1, w0, w1)."""
    k0 = (f - lo) & 1
    c0 = (f - lo - k0) >> 1
    v0 = (k0 < n) & (c0 >= 0) & (c0 < nc)
    v1 = (k0 == 0) & (n > 2) & (c0 >= 1) & (c0 - 1 < nc)
    w0 = torch.where(k0 == 1, torch.tensor(w[1], dtype=torch.float64),
                     torch.tensor(w[0], dtype=torch.float64))
    return c0, v0, v1, w0, w[2]


def gather2(a, iy, ix):
    """a[iy, ix] for index vectors (outer product), indices clamped: the
    caller masks what lies outside."""
    iy = iy.clamp(0, a.shape[0] - 1)
    ix = ix.clamp(0, a.shape[1] - 1)
    return a[iy][:, ix]


def inputs(shape, cshape, seed):
    """Random sol, rhs, sol_c with -0 seeded in each (so a sign of zero that
    a sum loses shows in the bits)."""
    rng = np.random.default_rng(seed)
    sol, rhs = (torch.from_numpy(rng.standard_normal(shape)) for _ in range(2))
    sol_c = torch.from_numpy(rng.standard_normal(cshape))
    for t, k in ((sol, 7), (rhs, 11), (sol_c, 5)):
        t.view(-1)[::k] = -0.0
    return sol, rhs, sol_c


# ----------------------------------------------------------------------
# the per-node order (the kernels' sums, one output node at a time)
# ----------------------------------------------------------------------


def residual(sol, rhs):
    """rhs - A sol on inner nodes, A's terms in the order centre, z-, z+,
    y-, y+, x-, x+ (star_apply); zero elsewhere."""
    c = COEFS
    i = (slice(1, -1),) * 3
    au = c[0] * sol[i]
    au = au + c[1] * sol[:-2, 1:-1, 1:-1]
    au = au + c[2] * sol[2:, 1:-1, 1:-1]
    au = au + c[3] * sol[1:-1, :-2, 1:-1]
    au = au + c[4] * sol[1:-1, 2:, 1:-1]
    au = au + c[5] * sol[1:-1, 1:-1, :-2]
    au = au + c[6] * sol[1:-1, 1:-1, 2:]
    r = torch.zeros_like(sol)
    r[i] = rhs[i] - au
    return r


def per_node_restrict(sol, rhs, kern, lo, cshape):
    """out[c] = sum_x w_x (sum_y w_y (sum_z w_z r)), each sum from +0 in
    increasing tap order, a tap outside the fine array skipped."""
    r, w, n = residual(sol, rhs), padded(kern), [len(k) for k in kern]
    cz, cy, cx = torch.meshgrid(*(torch.arange(m) for m in cshape), indexing="ij")
    acc_x = torch.zeros(cshape, dtype=sol.dtype)
    for kx in range(MT):
        x = 2 * cx + lo[2] + kx
        vx = (kx < n[2]) & (x >= 0) & (x < sol.shape[2])
        acc_y = torch.zeros_like(acc_x)
        for ky in range(MT):
            y = 2 * cy + lo[1] + ky
            vy = (ky < n[1]) & (y >= 0) & (y < sol.shape[1])
            acc_z = torch.zeros_like(acc_x)
            for kz in range(MT):
                z = 2 * cz + lo[0] + kz
                vz = (kz < n[0]) & (z >= 0) & (z < sol.shape[0])
                v = r[z.clamp(0, sol.shape[0] - 1), y.clamp(0, sol.shape[1] - 1),
                      x.clamp(0, sol.shape[2] - 1)]
                acc_z = torch.where(vz, acc_z + w[0][kz] * v, acc_z)
            acc_y = torch.where(vy, acc_y + w[1][ky] * acc_z, acc_y)
        acc_x = torch.where(vx, acc_x + w[2][kx] * acc_y, acc_x)
    return acc_x


def per_node_prolong(sol, sol_c, kern, lo):
    """sol + (P sol_c) on inner nodes, prolong_at's order: for each fine
    node the parity-matching coarse taps, z innermost, then y, then x."""
    w, n = padded(kern), [len(k) for k in kern]
    shape, cshape = sol.shape, sol_c.shape
    z, y, x = torch.meshgrid(*(torch.arange(m) for m in shape), indexing="ij")
    acc_x = torch.zeros_like(sol)
    for kx in range(MT):
        nux = x - lo[2] - kx
        vx = (kx < n[2]) & (nux % 2 == 0) & (nux // 2 >= 0) & (nux // 2 < cshape[2])
        acc_y = torch.zeros_like(sol)
        for ky in range(MT):
            nuy = y - lo[1] - ky
            vy = (ky < n[1]) & (nuy % 2 == 0) & (nuy // 2 >= 0) & (nuy // 2 < cshape[1])
            acc_z = torch.zeros_like(sol)
            for kz in range(MT):
                nuz = z - lo[0] - kz
                vz = (kz < n[0]) & (nuz % 2 == 0) & (nuz // 2 >= 0) & (nuz // 2 < cshape[0])
                v = sol_c[(nuz // 2).clamp(0, cshape[0] - 1), (nuy // 2).clamp(0, cshape[1] - 1),
                          (nux // 2).clamp(0, cshape[2] - 1)]
                acc_z = torch.where(vz, acc_z + w[0][kz] * v, acc_z)
            acc_y = torch.where(vy, acc_y + w[1][ky] * acc_z, acc_y)
        acc_x = torch.where(vx, acc_x + w[2][kx] * acc_y, acc_x)
    inner = torch.zeros(shape, dtype=torch.bool)
    inner[1:-1, 1:-1, 1:-1] = True
    return torch.where(inner, sol + acc_x, sol)


# ----------------------------------------------------------------------
# the kernels' blocks
# ----------------------------------------------------------------------


def inner_tiles(n, t):
    return -(-(n - 2) // t)


def own_tiles(n, t):
    return max(n - 2, 0) // t + 1


def own_range(b, t, n):
    c0 = b * t
    return c0, (n if b == own_tiles(n, t) - 1 else min(c0 + t, n))


def emulate_prolong(sol, sol_c, kern, lo, chunk, box_cut=0, chunk_cut=0, ring_zero=False):
    """One prolong_kernel launch, block by block: returns the new sol and
    checks that every inner node is written by exactly one block.
    `box_cut` leaves the first column of each coarse box unloaded,
    `chunk_cut` ends each z-chunk a plane early, `ring_zero` adds a zero
    correction on the x = 0 face of the Dirichlet ring instead of skipping
    it (faults the tests must catch)."""
    nz, ny, nx = sol.shape
    nzc, nyc, nxc = sol_c.shape
    w, n = padded(kern), [len(k) for k in kern]
    out, written = sol.clone(), torch.zeros(sol.shape, dtype=torch.int32)
    for bz in range(inner_tiles(nz, chunk)):
        z0 = 1 + bz * chunk
        z1 = min(z0 + chunk, nz - 1) - chunk_cut
        for by in range(inner_tiles(ny, UTY)):
            for bx in range(inner_tiles(nx, UTX)):
                ty0, tx0 = 1 + by * UTY, 1 + bx * UTX
                by0, bx0 = floor_half(ty0 - lo[1] - (MT - 1)), floor_half(tx0 - lo[2] - (MT - 1))
                ys, xs = ty0 + torch.arange(UTY), tx0 + torch.arange(UTX)
                rok, cok = ys <= ny - 2, xs <= nx - 2
                py = tap_pair(ys, nyc, w[1], n[1], lo[1])
                px = tap_pair(xs, nxc, w[2], n[2], lo[2])
                by_ = by0 + torch.arange(BOXY)
                bx_ = bx0 + torch.arange(BOXX)
                box_in = ((by_ >= 0) & (by_ < nyc))[:, None] & ((bx_ >= 0) & (bx_ < nxc))[None, :]
                ring = torch.full((4, BOXY, BOXX), float("nan"), dtype=sol.dtype)
                state = {"cz_next": max(floor_half(z0 - lo[0] - (n[0] - 1)), 0)}

                def issue_upto(z):
                    if z >= z1:
                        return
                    hi = min(floor_half(z - lo[0]), nzc - 1)
                    while state["cz_next"] <= hi:
                        c = state["cz_next"]
                        ring[c & 3] = torch.where(box_in, gather2(sol_c[c], by_, bx_), 0.0)
                        ring[c & 3, :, :box_cut] = float("nan")
                        state["cz_next"] += 1

                def coarse_z(z):
                    c0, v0, v1, w0, w1 = tap_pair(torch.tensor(z), nzc, w[0], n[0], lo[0])
                    acc = torch.zeros((BOXY, BOXX), dtype=sol.dtype)
                    if v0:
                        acc = acc + w0 * ring[int(c0) & 3]
                    if v1:
                        acc = acc + w1 * ring[(int(c0) - 1) & 3]
                    return acc

                zsum = [None, None]
                issue_upto(z0)
                issue_upto(z0 + 1)
                zsum[0] = coarse_z(z0)
                for z in range(z0, z1):
                    s = (z - z0) & 1
                    issue_upto(z + 2)
                    if z + 1 < z1:
                        zsum[s ^ 1] = coarse_z(z + 1)
                    zs = zsum[s]

                    def sum_y(o):
                        c0, v0, v1, w0, w1 = py
                        acc = torch.zeros((UTY, UTX), dtype=sol.dtype)
                        acc = torch.where(v0[:, None], acc + w0[:, None] * gather2(zs, c0 - by0, o), acc)
                        return torch.where(v1[:, None],
                                           acc + w1 * gather2(zs, c0 - 1 - by0, o), acc)

                    c0, v0, v1, w0, w1 = px
                    acc = torch.zeros((UTY, UTX), dtype=sol.dtype)
                    acc = torch.where(v0[None, :], acc + w0[None, :] * sum_y(c0 - bx0), acc)
                    acc = torch.where(v1[None, :], acc + w1 * sum_y(c0 - 1 - bx0), acc)
                    m = rok[:, None] & cok[None, :]
                    yy, xx = ys[:, None].expand(m.shape)[m], xs[None, :].expand(m.shape)[m]
                    out[z, yy, xx] = sol[z, yy, xx] + acc[m]
                    written[z, yy, xx] += 1
                    if ring_zero and bx == 0:
                        yy = ys[rok]
                        out[z, yy, 0] = sol[z, yy, 0] + torch.zeros(len(yy), dtype=sol.dtype)
    inner = torch.zeros(sol.shape, dtype=torch.int32)
    inner[1:-1, 1:-1, 1:-1] = 1
    if not (ring_zero or chunk_cut):
        assert torch.equal(written, inner), "inner nodes written != once"
    return out


def emulate_restrict(sol, rhs, kern, lo, cshape, chunk, halo_cut=0, chunk_cut=0):
    """One restrict_kernel launch, block by block, step by step: returns
    the coarse rhs and checks that every coarse node is written by exactly
    one block.  `halo_cut` leaves the last column of the sol window
    unloaded (zero), `chunk_cut` stops each z-chunk's residual planes one short
    (faults the tests must catch)."""
    nz, ny, nx = sol.shape
    nzc, nyc, nxc = cshape
    w, n = padded(kern), [len(k) for k in kern]
    c = COEFS
    out = torch.full(cshape, float("nan"), dtype=sol.dtype)
    written = torch.zeros(cshape, dtype=torch.int32)
    for bz in range(own_tiles(nzc, chunk // 2)):
        cz0, cz1 = own_range(bz, chunk // 2, nzc)
        rz0 = max(2 * cz0 + lo[0], 0)
        rz1 = min(2 * (cz1 - 1) + lo[0] + n[0] - 1, nz - 1) - chunk_cut
        for by in range(own_tiles(nyc, DTY)):
            cy0, cy1 = own_range(by, DTY, nyc)
            for bx in range(own_tiles(nxc, DTX)):
                cx0, cx1 = own_range(bx, DTX, nxc)
                ry0, rx0 = 2 * cy0 + lo[1], 2 * cx0 + lo[2]
                RY, RX = 2 * (cy1 - cy0 - 1) + n[1], 2 * (cx1 - cx0 - 1) + n[2]
                assert RY <= 2 * DTY + MT and RX <= 2 * DTX + MT  # the kernel's kResY, kResX
                gy, gx = ry0 + torch.arange(RY), rx0 + torch.arange(RX)
                ok = ((gy >= 1) & (gy <= ny - 2))[:, None] & ((gx >= 1) & (gx <= nx - 2))[None, :]
                sy, sx = ry0 - 1 + torch.arange(RY + 2), rx0 - 1 + torch.arange(RX + 2)
                sok = ((sy >= 0) & (sy < ny))[:, None] & ((sx >= 0) & (sx < nx))[None, :]
                if halo_cut:
                    sok[:, -1] = False
                sring = torch.full((SLOTS, RY + 2, RX + 2), float("nan"), dtype=sol.dtype)
                rring = torch.full((SLOTS, RY, RX), float("nan"), dtype=sol.dtype)
                zacc = torch.full((2, RY, RX), float("nan"), dtype=sol.dtype)
                pfirst, plast = rz0 - 1, rz1 + 1

                def issue(p, slot):
                    if 0 <= p < nz and p <= plast:
                        sring[slot] = torch.where(sok, gather2(sol[p], sy, sx), 0.0)
                        if rz0 <= p <= rz1:
                            rring[slot] = torch.where(ok, gather2(rhs[p], gy, gx), 0.0)

                def restrict_yx(cz):
                    zb = zacc[cz & 1]
                    ly, lx = torch.arange(cy1 - cy0), torch.arange(cx1 - cx0)
                    acc_x = torch.zeros((cy1 - cy0, cx1 - cx0), dtype=sol.dtype)
                    for kx in range(MT):
                        x = 2 * (cx0 + lx) + lo[2] + kx
                        vx = (kx < n[2]) & (x >= 0) & (x < nx)
                        acc_y = torch.zeros_like(acc_x)
                        for ky in range(MT):
                            y = 2 * (cy0 + ly) + lo[1] + ky
                            vy = (ky < n[1]) & (y >= 0) & (y < ny)
                            acc_y = torch.where(vy[:, None], acc_y + w[1][ky] * gather2(
                                zb, y - ry0, x - rx0), acc_y)
                        acc_x = torch.where(vx[None, :], acc_x + w[2][kx] * acc_y, acc_x)
                    out[cz, cy0:cy1, cx0:cx1] = acc_x
                    written[cz, cy0:cy1, cx0:cx1] += 1

                def last_of(cz):
                    return min(max(2 * cz + lo[0] + n[0] - 1, 0), nz - 1)

                for j in range(s3.TRANSFER_AHEAD):
                    issue(pfirst + j, j)
                czw = czr = cz0
                s0 = 0
                for p in range(pfirst, plast + 1):
                    issue(p + s3.TRANSFER_AHEAD, (s0 + s3.TRANSFER_AHEAD) % SLOTS)
                    while czr < czw:
                        restrict_yx(czr)
                        czr += 1
                    q = p - 1
                    if rz0 <= q <= rz1:
                        zm, b, zp = (sring[(s0 - d) % SLOTS] for d in (2, 1, 0))
                        rq = rring[(s0 - 1) % SLOTS]
                        i = (slice(1, -1), slice(1, -1))
                        au = c[0] * b[i]
                        au = au + c[1] * zm[i]
                        au = au + c[2] * zp[i]
                        au = au + c[3] * b[:-2, 1:-1]
                        au = au + c[4] * b[2:, 1:-1]
                        au = au + c[5] * b[1:-1, :-2]
                        au = au + c[6] * b[1:-1, 2:]
                        r = torch.where(ok & (1 <= q <= nz - 2), rq - au, 0.0)
                        k0 = (q - lo[0]) & 1
                        c0 = (q - lo[0] - k0) >> 1
                        for cc, wz, tap in ((c0, w[0][k0], k0 < n[0]),
                                            (c0 - 1, w[0][2], k0 == 0 and n[0] > 2)):
                            if tap and cz0 <= cc < cz1:
                                first = q == max(2 * cc + lo[0], 0)
                                zs = torch.zeros_like(r) if first else zacc[cc & 1]
                                zacc[cc & 1] = zs + wz * r
                        while czw < cz1 and last_of(czw) == q:
                            czw += 1
                    s0 = (s0 + 1) % SLOTS
                while czr < czw:
                    restrict_yx(czr)
                    czr += 1
    if not chunk_cut:
        assert torch.equal(written, torch.ones_like(written)), "coarse nodes written != once"
    return out


# ----------------------------------------------------------------------
# cases
# ----------------------------------------------------------------------

NODE = (node_restriction(3), node_prolongation(3))
CELL = (cell_restriction(3), cell_prolongation(3))
J_NODE = (j_node_restriction, j_node_prolongation)
J_CELL = (j_cell_restriction, j_cell_prolongation)


def coarse_of(shape, cell):
    return tuple(m // 2 if cell else (m - 1) // 2 + 1 for m in shape)


# name -> (fine shape, cell transfers?).  Levels 2-5; shapes one node
# either side of K5's tile (inner 15/16/17 rows, 63/64/65 columns) and of
# K4's coarse tile (7/8/9/10 rows, 31/32/33/34 columns, the last two where
# the last tile takes one more or a partial tile follows), and of z-chunks.
CASES = {
    "l2_5": ((5, 5, 5), False),
    "l3_9": ((9, 9, 9), False),
    "l4_17": ((17, 17, 17), False),
    "l5_33": ((33, 33, 33), False),
    "odd_17x33x9": ((17, 33, 9), False),
    "up_tile_rows_17_18_19": ((9, 18, 19), False),
    "up_tile_cols_65": ((7, 17, 65), False),
    "up_tile_cols_66_67": ((6, 19, 66), False),
    "up_tile_cols_67": ((7, 5, 67), False),
    "down_tile_15x63": ((7, 15, 63), False),
    "down_tile_17x65": ((9, 17, 65), False),
    "down_tile_19x67": ((5, 19, 67), False),
    "down_tile_13x61": ((11, 13, 61), False),
    "z_chunk_35": ((35, 9, 9), False),
    "z_chunk_36": ((36, 7, 10), False),
    "cell_16": ((16, 16, 16), True),
    "cell_36x18x20": ((36, 18, 20), True),
    "cell_34x17x66": ((34, 17, 66), True),
    "cell_odd_9x37x70": ((9, 37, 70), True),
}


def case(name, seed=0):
    shape, cell = CASES[name]
    cshape = coarse_of(shape, cell)
    R, P = CELL if cell else NODE
    sol, rhs, sol_c = inputs(shape, cshape, seed)
    return shape, cshape, R, P, sol, rhs, sol_c


def chunks(shape, cshape):
    """The wrapper's chunk on an H100 for each kernel, and 2, 4 and
    TRANSFER_CHUNK."""
    return sorted({2, 4, s3.TRANSFER_CHUNK,
                   s3.transfer_chunk(s3.LEG_PROLONG, shape, cshape, H100_SMS),
                   s3.transfer_chunk(s3.LEG_RESTRICT, shape, cshape, H100_SMS)})


@pytest.mark.parametrize("name", sorted(CASES))
def test_restrict_decomposition_is_per_node_order(name):
    shape, cshape, R, _, sol, rhs, _ = case(name, 1)
    rk = separable_kernels(R)
    want = per_node_restrict(sol, rhs, rk, R.lo, cshape)
    for chunk in chunks(shape, cshape):
        got = emulate_restrict(sol, rhs, rk, R.lo, cshape, chunk)
        assert torch.equal(bits(got), bits(want)), chunk
    plain = s3.res_restrict_plain(sol, rhs, BoundStencil("A", OFFS, COEFS), rk, R.lo, cshape)
    assert (want - plain).abs().max() <= 1e-12 * plain.abs().max()


@pytest.mark.parametrize("name", sorted(CASES))
def test_prolong_decomposition_is_per_node_order(name):
    _, cshape, _, P, sol, _, sol_c = case(name, 2)
    pk = separable_kernels(P)
    want = per_node_prolong(sol, sol_c, pk, P.lo)
    for chunk in chunks(sol.shape, cshape):
        got = emulate_prolong(sol, sol_c, pk, P.lo, chunk)
        assert torch.equal(bits(got), bits(want)), chunk
    plain = s3.prolong_correct_plain(sol, sol_c, pk, P.lo)
    assert (want - plain).abs().max() <= 1e-12 * plain.abs().max()


JAX_CASES = ("l3_9", "l4_17", "l5_33", "odd_17x33x9", "down_tile_17x65", "cell_16",
             "cell_36x18x20")


def close(got, want):
    want = torch.from_numpy(np.array(want))
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()


@pytest.mark.parametrize("name", JAX_CASES)
def test_restrict_decomposition_matches_pallas(name):
    """K4's replay within 1e-12 of res_restrict_fused_3d (interpret mode)."""
    from exastencils_tpu.core.stencil import BoundStencil as JBoundStencil

    shape, cshape, R, _, sol, rhs, _ = case(name, 3)
    jR = (J_CELL if CASES[name][1] else J_NODE)[0](3)
    A = JBoundStencil("A", OFFS, COEFS)
    r_mats = build_restrict_mats(jR, cshape, shape, cshape)
    want = res_restrict_fused_3d(jnp.asarray(sol.numpy()), jnp.asarray(rhs.numpy()), A.offsets,
                                 A.coefs, r_mats[1], r_mats[2], j_separable_kernels(jR)[0],
                                 jR.lo[0], cshape, interpret=True)
    got = emulate_restrict(sol, rhs, separable_kernels(R), R.lo, cshape,
                           s3.transfer_chunk(s3.LEG_RESTRICT, shape, cshape, H100_SMS))
    close(got, want)


@pytest.mark.parametrize("name", JAX_CASES)
def test_prolong_decomposition_matches_pallas(name):
    """K5's replay within 1e-12 of prolong_correct_fused_3d (interpret
    mode)."""
    shape, cshape, _, P, sol, _, sol_c = case(name, 4)
    jP = (J_CELL if CASES[name][1] else J_NODE)[1](3)
    p_mats = build_prolong_mats(jP, shape, cshape, shape)
    want = prolong_correct_fused_3d(jnp.asarray(sol.numpy()), jnp.asarray(sol_c.numpy()),
                                    p_mats[1], p_mats[2], j_separable_kernels(jP)[0], jP.lo[0],
                                    interpret=True)
    got = emulate_prolong(sol, sol_c, separable_kernels(P), P.lo,
                          s3.transfer_chunk(s3.LEG_PROLONG, shape, cshape, H100_SMS))
    close(got, want)


@pytest.mark.parametrize("fault", ["restrict_halo", "restrict_chunk_edge", "prolong_halo",
                                   "prolong_chunk_edge", "prolong_ring_zero"])
def test_faults_break_the_equality(fault):
    """The checks have teeth: K4's sol window one column short or its
    z-chunks' residual planes one short; K5's coarse box one column short
    or its z-chunks one plane short; K5 adding its (zero) correction on the
    Dirichlet ring instead of skipping it, which turns a -0 there into +0
    (torch.equal cannot see that; the bit patterns do).  Two K4 tiles in x
    and several z-chunks, so that the cut column and plane are read."""
    shape, cshape = (9, 17, 129), (5, 9, 65)
    R, P = NODE
    sol, rhs, sol_c = inputs(shape, cshape, 5)
    if fault.startswith("restrict"):
        rk = separable_kernels(R)
        got = emulate_restrict(sol, rhs, rk, R.lo, cshape, 4,
                               halo_cut=int(fault == "restrict_halo"),
                               chunk_cut=int(fault == "restrict_chunk_edge"))
        assert not torch.equal(bits(got), bits(per_node_restrict(sol, rhs, rk, R.lo, cshape)))
        return
    pk = separable_kernels(P)
    if fault == "prolong_ring_zero":
        sol = torch.where(torch.arange(shape[2]) == 0, -0.0, sol)  # -0 on the x = 0 face
    want = per_node_prolong(sol, sol_c, pk, P.lo)
    got = emulate_prolong(sol, sol_c, pk, P.lo, 4, box_cut=int(fault == "prolong_halo"),
                          chunk_cut=int(fault == "prolong_chunk_edge"),
                          ring_zero=fault == "prolong_ring_zero")
    assert not torch.equal(bits(got), bits(want))
    if fault == "prolong_ring_zero":
        assert torch.equal(got, want)  # equal as values: only the sign of a zero moved


def test_chunk_choice_and_grids():
    """The wrapper's z-chunk per level on an H100 (132 SMs): 32 planes at
    513^3 and 16 at 257^3, every SM four blocks or more on every level down
    to 65^3 (4096 blocks of each kernel at 513^3); every K5 row of blocks
    is full but for the boundary node, and no K4 tile holds fewer nodes than
    the tile (257 coarse nodes: seven tiles of 32, then 33)."""
    levels = [2 ** L + 1 for L in range(2, 10)]
    for mode in (s3.LEG_PROLONG, s3.LEG_RESTRICT):
        got = [s3.transfer_chunk(mode, (n,) * 3, ((n - 1) // 2 + 1,) * 3, H100_SMS)
               for n in levels]
        assert got[-2:] == [16, 32]
        for n, chunk in zip(levels, got):
            blocks = s3.transfer_blocks(mode, (n,) * 3, ((n - 1) // 2 + 1,) * 3, chunk)
            assert blocks >= 4 * H100_SMS or chunk == 2, (mode, n)
        assert s3.transfer_blocks(mode, (513,) * 3, (257,) * 3, 32) == 4096
    for n in levels[4:]:
        assert (n - 2) % UTX in (0, UTX - 1) and (n - 2) % UTY in (0, UTY - 1)
        nc = (n - 1) // 2 + 1
        sizes = [own_range(b, DTX, nc)[1] - own_range(b, DTX, nc)[0] for b in range(own_tiles(nc, DTX))]
        assert min(sizes) >= min(DTX, nc) and max(sizes) <= DTX + 1
    assert [own_range(b, DTX, 257) for b in (6, 7)] == [(192, 224), (224, 257)]
