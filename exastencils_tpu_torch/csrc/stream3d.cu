// The fused transfers for 3D radius-1 star stencils on Hopper (sm_90a),
// one launch each, with their wrappers, launch counts and plain versions in
// ops/cuda/stream3d.py:
//   K4 = exastencils_tpu/ops/pallas/stream3d.py:260 _down_kernel
//        residual + restriction (the down-leg tail where the legs decline,
//        e.g. Jacobi): restrict_kernel (wrapper res_restrict)
//   K5 = exastencils_tpu/ops/pallas/stream3d.py:380 _up_kernel
//        prolongation + correction (the up-leg head): prolong_kernel
//        (wrapper prolong_correct)
// (K1-K3 are legs3d.cu's, K6-K8 cluster_legs3d.cu's.)
//
// What the TPU kernels compute is kept exactly: the residual rhs - A sol
// with A's terms summed in the order centre, z-, z+, y-, y+, x-, x+
// (exastencils_tpu/ops/stencil_apply.apply_stencil), zero off the inner
// nodes; K5 writes inner nodes only and does not reapply bc.  Both sum the
// transfer taps z innermost, then y, then x, each in increasing tap order
// from a sum that starts at zero, and skip a tap outside the array (the
// order of the first port's one thread per output node), so K1's coarse
// rhs is bitwise K3 + K4's and K2 bitwise K5 + K3's (legs3d.cu sums in the
// same order).  Built with --fmad=false, the residual arithmetic is
// bitwise that of the plain PyTorch path; only the order of the transfer
// sums differs from its banded matmuls.  The taps stay general (Taps<T>,
// up to kMaxTaps per dim, any lo).  Fields are float32, float64 or
// bfloat16 (star3d.cuh's rounding contract: float32 rings and sums, the
// residual and every output value rounded once; loads synchronous).
//
// Bound: device-memory bytes.  Each kernel must read two fine arrays (K4:
// sol, rhs; K5: sol, and write it back) and one coarse one: (2N + Nc)
// values, 1.148 GB at 513^3 f32, 0.343 ms at the H100's 3.35 TB/s.  The
// arithmetic (14 flops per fine node for the residual, ~7 per node for
// either transfer) is a tenth of that.  The TPU kernels walked the z-planes
// in order and did the y/x transfer as banded matrix products; the first
// port ran one thread per output node, so K4 evaluated every fine residual
// ~3.4 times (27 taps for 8 fine nodes a coarse node) and K5 ran 27
// guarded taps with a division and a modulo each per fine node, and
// 128-thread rows of 257 or 513 nodes left one block in three or five
// nearly empty (1.56 and 2.65 ms at 513^3 f32 on an H100; PERF.md §6).
// This design:
//
// - A loop over z inside a block takes the place of the TPU grid's
//   sequential dimension.  Each block owns a (y, x) tile and a z-chunk
//   of at most kTransferChunk fine planes (the wrapper halves the chunk on
//   levels too small to give each SM four blocks).
// - K5: tiles of kUpTileY x kUpTileX inner fine nodes (511 = 8 x 64 - 1
//   and 32 x 16 - 1 at 513^3: every row of blocks is full).  The coarse box
//   of the tile, ((tile + 3) / 2 + 1)^2 nodes of each coarse plane, comes
//   into a ring in shared memory once per coarse plane (cp.async, one fine
//   plane ahead); the z-sums of the box (the innermost sums) are formed
//   once per fine plane; each fine node then sums at most 2 x 2 of them, y
//   then x, with its taps worked out once before the z loop.  sol is read
//   and written once, each warp on 32 consecutive nodes of a row, the next
//   plane's values loaded while this one is summed.  One barrier per plane.
// - K4: tiles of kDownTileY x kDownTileX coarse nodes (the last tile of a
//   dim takes one node more: 257 = 7 x 32 + 33, so no block is nearly
//   empty).  Planes of sol with a one-node y/x halo around the tile's
//   residual window, and of rhs, stream through rings in shared memory
//   (cp.async, kDownAhead plane ahead).  Each residual of the window is
//   computed once and added into running z-sums, in shared memory, of the
//   (at most two) coarse planes it is a tap of; a completed plane's y and
//   x taps are summed from there the step after.  A thread takes a pair of
//   x-neighbours, whose values it reads 8 bytes at a time (rows padded to
//   an even length): 8 shared loads for two residuals, not 16.  A z-chunk's
//   edge plane is computed by both chunks (one plane in kTransferChunk / 2
//   + 1), the window's one-node rim by both tiles.  Launch shapes timed on
//   an H100 (PERF.md §6): 24 warps an SM ran 0.83-0.90 ms at 513^3 f32
//   whatever the tile, 32 warps (kDownAhead = 1, registers capped for
//   four blocks an SM) 0.81, and the pairs 0.77.
// - No TMA: a row of 513 values is 2052 bytes in f32 (4104 in f64), not a
//   multiple of 16, so the copies are cp.async of one value.

#include "star3d.cuh"

namespace {

using namespace exa;

constexpr int kUpTileY = 16;          // K5: inner fine nodes of a tile, y
constexpr int kUpTileX = 64;          //     and x (two columns a lane)
constexpr int kDownTileY = 8;         // K4: coarse nodes of a tile, y
constexpr int kDownTileX = 32;        //     and x (the last tile of a dim: one more)
constexpr int kTransferThreads = 256;
constexpr int kTransferChunk = 32;    // fine z-planes of a block, at most
constexpr int kDownAhead = 1;         // K4: planes in flight ahead of the one used
constexpr int kCoarseSlots = 4;       // K5: ring of coarse boxes (enough for one plane ahead)

constexpr int kWarps = kTransferThreads / 32;
constexpr int kUpCols = kUpTileX / 32;      // a lane's columns: lane, lane + 32, ...
constexpr int kUpRows = kUpTileY / kWarps;  // a warp's rows: warp, warp + kWarps, ...
constexpr int kUpBoxY = (kUpTileY + kMaxTaps) / 2 + 1;
constexpr int kUpBoxX = (kUpTileX + kMaxTaps) / 2 + 1;
constexpr int kUpBox = kUpBoxY * kUpBoxX;
constexpr int kUpBoxPer = (kUpBox + kTransferThreads - 1) / kTransferThreads;

// K4's residual window (coarse tile t: 2 (t - 1) + ntaps fine nodes; t is
// at most the tile + 1) in pairs of x-neighbours; its planes' row stride
// (even, so that a pair's two values are one aligned 8- or 16-byte word;
// window column c at c + 2, its halo at 1 and at RX + 2); the planes of sol
// (with a halo row each side) and of rhs and the z-sums; the rings' slots;
// each thread's share of the pairs and of the halo the pairs leave.
constexpr int kResY = 2 * kDownTileY + kMaxTaps;
constexpr int kResX = 2 * kDownTileX + kMaxTaps;
constexpr int kPairsX = (kResX + 1) / 2;
constexpr int kStride = 2 * kPairsX + 2;
constexpr int kSolPlane = (kResY + 2) * kStride;
constexpr int kResPlane = kResY * kStride;
constexpr int kDownSlots = kDownAhead + 3;  // planes q - 1, q, q + 1 and those in flight
constexpr int kPairsPer = (kResY * kPairsX + kTransferThreads - 1) / kTransferThreads;
constexpr int kHaloPer = (2 * (kResX + 2) + 2 * kResY + kTransferThreads - 1) / kTransferThreads;

static_assert(kUpTileX % 32 == 0 && kUpTileY % kWarps == 0, "K5 tile: whole warps");
static_assert(kStride % 2 == 0 && kSolPlane % 2 == 0 && kResPlane % 2 == 0, "K4: aligned pairs");

// Tiles along one dim of n nodes when the last tile takes a remainder of
// one node (never a tile of one), and tile b's nodes [c0, c1).
__device__ __host__ inline int own_tiles(int n, int t) { return n > 2 ? (n - 2) / t + 1 : 1; }

struct Range {
  int c0, c1;
};

__device__ inline Range own_range(int b, int t, int n) {
  Range r;
  r.c0 = b * t;
  r.c1 = b == own_tiles(n, t) - 1 ? n : min(r.c0 + t, n);
  return r;
}

// Tiles along one dim of n nodes when only the n - 2 inner nodes are
// covered, from node 1.
__device__ __host__ inline int inner_tiles(int n, int t) { return (n - 2 + t - 1) / t; }

template <typename C>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

// prolong_kernel: K5.  sol += P sol_c on the inner nodes of the block's
// tile and z-chunk, summed in the per-node order (bfloat16: in float32,
// each corrected value rounded once).
template <typename T>
__global__ void __launch_bounds__(kTransferThreads)
prolong_kernel(T* __restrict__ sol, const T* __restrict__ solc, int nz, int ny, int nx, int nzc,
               int nyc, int nxc, int chunk, Taps<compute_t<T>> t) {
  using C = compute_t<T>;
  __shared__ C cring[kCoarseSlots * kUpBox];  // coarse boxes, by coarse plane % kCoarseSlots
  __shared__ C zsum[2 * kUpBox];              // their z-sums, by fine plane parity in the chunk
  const int z0 = 1 + blockIdx.z * chunk, z1 = min(z0 + chunk, nz - 1);
  if (z0 >= z1) return;  // block-uniform
  const int ty0 = 1 + blockIdx.y * kUpTileY, tx0 = 1 + blockIdx.x * kUpTileX;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int by0 = floor_half(ty0 - t.lo[1] - (kMaxTaps - 1));  // the box's origin
  const int bx0 = floor_half(tx0 - t.lo[2] - (kMaxTaps - 1));

  // The thread's rows and columns: inner or not, their y and x taps, their
  // offsets in the box and in a plane of sol.
  TapPair<C> py[kUpRows], px[kUpCols];
  bool rok[kUpRows], cok[kUpCols];
  int oy[kUpRows], ox[kUpCols], gy[kUpRows], gx[kUpCols];
#pragma unroll
  for (int r = 0; r < kUpRows; ++r) {
    const int y = ty0 + warp + kWarps * r;
    rok[r] = y <= ny - 2;
    py[r] = tap_pair(y, nyc, t.w[1], t.n[1], t.lo[1]);
    oy[r] = (py[r].c0 - by0) * kUpBoxX;
    gy[r] = y * nx;
  }
#pragma unroll
  for (int c = 0; c < kUpCols; ++c) {
    const int x = tx0 + lane + 32 * c;
    cok[c] = x <= nx - 2;
    px[c] = tap_pair(x, nxc, t.w[2], t.n[2], t.lo[2]);
    ox[c] = px[c].c0 - bx0;
    gx[c] = x;
  }
  // The thread's share of a coarse box: offsets in a coarse plane.
  int coff[kUpBoxPer];
  bool cin[kUpBoxPer];
#pragma unroll
  for (int k = 0; k < kUpBoxPer; ++k) {
    const int i = threadIdx.x + k * kTransferThreads;
    const int cy = by0 + i / kUpBoxX, cx = bx0 + i % kUpBoxX;
    cin[k] = i < kUpBox && cy >= 0 && cy < nyc && cx >= 0 && cx < nxc;
    coff[k] = cin[k] ? cy * nxc + cx : 0;
  }
  const int64_t plane = static_cast<int64_t>(ny) * nx, cplane = static_cast<int64_t>(nyc) * nxc;

  // The coarse planes fine plane z prolongs from that are not loaded yet,
  // into the ring: one copy group (empty past the chunk).  Block-uniform.
  int cz_next = max(floor_half(z0 - t.lo[0] - (t.n[0] - 1)), 0);
  auto issue_upto = [&](int z) {
    if (z < z1) {
      for (const int hi = min(floor_half(z - t.lo[0]), nzc - 1); cz_next <= hi; ++cz_next) {
        const T* src = solc + cz_next * cplane;
        C* dst = cring + (cz_next & (kCoarseSlots - 1)) * kUpBox;
#pragma unroll
        for (int k = 0; k < kUpBoxPer; ++k) {
          const int i = threadIdx.x + k * kTransferThreads;
          if (i < kUpBox) load_shared(dst + i, src + coff[k], cin[k]);
        }
      }
    }
    cp_async_commit();
  };
  // The z-sums of the box for fine plane z (the innermost sums, in their
  // order) into dst; z's coarse planes must have arrived.
  auto coarse_z = [&](int z, C* dst) {
    const TapPair<C> pz = tap_pair(z, nzc, t.w[0], t.n[0], t.lo[0]);
    const C* ca = cring + (pz.c0 & (kCoarseSlots - 1)) * kUpBox;  // read only where valid
    const C* cb = cring + ((pz.c0 - 1) & (kCoarseSlots - 1)) * kUpBox;
    for (int i = threadIdx.x; i < kUpBox; i += kTransferThreads) {
      C acc = C(0);
      if (pz.v0) acc = acc + pz.w0 * ca[i];
      if (pz.v1) acc = acc + pz.w1 * cb[i];
      dst[i] = acc;
    }
  };
  C v[kUpRows][kUpCols], nv[kUpRows][kUpCols];
  auto load = [&](int z, C (&dst)[kUpRows][kUpCols]) {
    const T* src = sol + z * plane;
#pragma unroll
    for (int r = 0; r < kUpRows; ++r)
#pragma unroll
      for (int c = 0; c < kUpCols; ++c)
        if (rok[r] && cok[c]) dst[r][c] = widen(src[gy[r] + gx[c]]);
  };

  issue_upto(z0);
  issue_upto(z0 + 1);
  cp_async_wait<1>();
  __syncthreads();
  coarse_z(z0, zsum);
  load(z0, v);
  for (int z = z0; z < z1; ++z) {
    const int s = (z - z0) & 1;
    issue_upto(z + 2);  // overwrites a coarse plane no fine plane from z on reads
    cp_async_wait<1>();  // z + 1's coarse planes have arrived
    if (z + 1 < z1) load(z + 1, nv);
    // z's z-sums are complete, and every thread is done with the slot
    // that z + 1's go to.
    __syncthreads();
    if (z + 1 < z1) coarse_z(z + 1, zsum + (s ^ 1) * kUpBox);
    const C* zs = zsum + s * kUpBox;
    T* dst = sol + z * plane;
#pragma unroll
    for (int r = 0; r < kUpRows; ++r) {
      auto sum_y = [&](int o) {
        C acc = C(0);
        if (py[r].v0) acc = acc + py[r].w0 * zs[oy[r] + o];
        if (py[r].v1) acc = acc + py[r].w1 * zs[oy[r] - kUpBoxX + o];
        return acc;
      };
#pragma unroll
      for (int c = 0; c < kUpCols; ++c) {
        if (!(rok[r] && cok[c])) continue;
        C acc = C(0);
        if (px[c].v0) acc = acc + px[c].w0 * sum_y(ox[c]);
        if (px[c].v1) acc = acc + px[c].w1 * sum_y(ox[c] - 1);
        dst[gy[r] + gx[c]] = narrow<T>(v[r][c] + acc);
        v[r][c] = nv[r][c];
      }
    }
  }
}

// restrict_kernel: K4.  The coarse rhs of the block's coarse tile and
// z-chunk: the residual (zero off the inner nodes) restricted, its taps
// summed z innermost, then y, then x (bfloat16: in float32, each residual
// and each coarse value rounded once).  Registers capped so that an SM
// holds four f32 blocks, as their shared memory allows (f64: two; bf16's
// rings are f32's).
template <typename T>
__global__ void __launch_bounds__(kTransferThreads, sizeof(compute_t<T>) == 4 ? 4 : 2)
restrict_kernel(const T* __restrict__ sol, const T* __restrict__ rhs, T* __restrict__ outc, int nz,
                int ny, int nx, int nzc, int nyc, int nxc, int chunk, Star<compute_t<T>> s,
                Taps<compute_t<T>> t) {
  using C = compute_t<T>;
  using V2 = typename Vec2<C>::type;
  constexpr int S = kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  C* sring = reinterpret_cast<C*>(smem);
  C* rring = sring + kDownSlots * kSolPlane;
  C* zacc = rring + kDownSlots * kResPlane;
  const Range cz = own_range(blockIdx.z, chunk / 2, nzc);
  if (cz.c0 >= cz.c1) return;
  const Range cy = own_range(blockIdx.y, kDownTileY, nyc), cx = own_range(blockIdx.x, kDownTileX, nxc);
  const int ry0 = 2 * cy.c0 + t.lo[1], rx0 = 2 * cx.c0 + t.lo[2];
  const int RY = 2 * (cy.c1 - cy.c0 - 1) + t.n[1], RX = 2 * (cx.c1 - cx.c0 - 1) + t.n[2];
  const int PX = (RX + 1) / 2;
  const int rz0 = max(2 * cz.c0 + t.lo[0], 0);
  const int rz1 = min(2 * (cz.c1 - 1) + t.lo[0] + t.n[0] - 1, nz - 1);
  const int64_t plane = static_cast<int64_t>(ny) * nx;

  // The thread's pairs: smem offset of the first node in a sol plane (the
  // rhs and z-sum planes: one row less), its global offset in a plane, and
  // flags (bit 0/1: node a/b inside the array and the window or its right
  // halo, 2/3: inner, 4: the pair is the thread's).
  int os[kPairsPer], go[kPairsPer], fl[kPairsPer];
#pragma unroll
  for (int k = 0; k < kPairsPer; ++k) {
    const int i = threadIdx.x + k * kTransferThreads;
    const int ly = i / PX, j = i - ly * PX, y = ry0 + ly, x = rx0 + 2 * j;
    const bool mine = i < RY * PX, row = mine && y >= 0 && y < ny;
    const bool rin = mine && y >= 1 && y <= ny - 2;
    int f = mine ? 16 : 0;
    if (row && x >= 0 && x < nx) f |= 1;
    if (row && x + 1 >= 0 && x + 1 < nx && 2 * j + 1 <= RX) f |= 2;
    if (rin && x >= 1 && x <= nx - 2 && 2 * j < RX) f |= 4;
    if (rin && x + 1 >= 1 && x + 1 <= nx - 2 && 2 * j + 1 < RX) f |= 8;
    fl[k] = f;
    os[k] = (ly + 1) * S + 2 * j + 2;
    go[k] = y * nx + x;
  }
  // The halo cells the pairs do not cover: rows -1 and RY, the column left
  // of the window and, for an even RX, the one right of it.
  int hs[kHaloPer], hg[kHaloPer];
  bool hin[kHaloPer], hmine[kHaloPer];
#pragma unroll
  for (int k = 0; k < kHaloPer; ++k) {
    int h = threadIdx.x + k * kTransferThreads, ly, lx;  // window row -1..RY, column -1..RX
    const int w = RX + 2;
    hmine[k] = true;
    if (h < 2 * w) {
      ly = h < w ? -1 : RY;
      lx = (h < w ? h : h - w) - 1;
    } else if ((h -= 2 * w) < RY) {
      ly = h;
      lx = -1;
    } else if ((h -= RY) < RY && RX % 2 == 0) {
      ly = h;
      lx = RX;
    } else {
      ly = lx = 0;
      hmine[k] = false;
    }
    const int y = ry0 + ly, x = rx0 + lx;
    hin[k] = hmine[k] && y >= 0 && y < ny && x >= 0 && x < nx;
    hs[k] = (ly + 1) * S + lx + 2;
    hg[k] = hin[k] ? y * nx + x : 0;
  }

  const int pfirst = rz0 - 1, plast = rz1 + 1;
  auto issue = [&](int p, int slot) {
    if (p >= 0 && p < nz && p <= plast) {
      const T* src = sol + p * plane;
      C* ds = sring + slot * kSolPlane;
#pragma unroll
      for (int k = 0; k < kPairsPer; ++k) {
        if (!(fl[k] & 16)) continue;
        load_shared(ds + os[k], (fl[k] & 1) ? src + go[k] : src, fl[k] & 1);
        load_shared(ds + os[k] + 1, (fl[k] & 2) ? src + go[k] + 1 : src, fl[k] & 2);
      }
#pragma unroll
      for (int k = 0; k < kHaloPer; ++k)
        if (hmine[k]) load_shared(ds + hs[k], src + hg[k], hin[k]);
      if (p >= rz0 && p <= rz1) {
        const T* rs = rhs + p * plane;
        C* dr = rring + slot * kResPlane - S;  // a rhs plane has no halo row
#pragma unroll
        for (int k = 0; k < kPairsPer; ++k) {
          if (fl[k] & 4) load_shared(dr + os[k], rs + go[k], true);
          if (fl[k] & 8) load_shared(dr + os[k] + 1, rs + go[k] + 1, true);
        }
      }
    }
    cp_async_commit();
  };
  auto slot_back = [](int slot, int n) { return slot - n < 0 ? slot - n + kDownSlots : slot - n; };
  auto last_of = [&](int c) { return min(max(2 * c + t.lo[0] + t.n[0] - 1, 0), nz - 1); };
  auto restrict_yx = [&](int c) {
    const C* zb = zacc + (c & 1) * kResPlane + 2;
    const int nyt = cy.c1 - cy.c0, nxt = cx.c1 - cx.c0;
    for (int i = threadIdx.x; i < nyt * nxt; i += kTransferThreads) {
      const int ly = i / nxt, lx = i - ly * nxt;
      const int cyy = cy.c0 + ly, cxx = cx.c0 + lx;
      C acc_x = C(0);
#pragma unroll
      for (int kx = 0; kx < kMaxTaps; ++kx) {
        const int x = 2 * cxx + t.lo[2] + kx;
        if (kx >= t.n[2] || x < 0 || x >= nx) continue;
        C acc_y = C(0);
#pragma unroll
        for (int ky = 0; ky < kMaxTaps; ++ky) {
          const int y = 2 * cyy + t.lo[1] + ky;
          if (ky >= t.n[1] || y < 0 || y >= ny) continue;
          acc_y = acc_y + t.w[1][ky] * zb[(y - ry0) * S + x - rx0];
        }
        acc_x = acc_x + t.w[2][kx] * acc_y;
      }
      outc[(static_cast<int64_t>(c) * nyc + cyy) * nxc + cxx] = narrow<T>(acc_x);
    }
  };

#pragma unroll
  for (int j = 0; j < kDownAhead; ++j) issue(pfirst + j, j);
  cp_async_wait<kDownAhead - 1>();
  __syncthreads();
  int czw = cz.c0, czr = cz.c0;
  for (int p = pfirst, s0 = 0; p <= plast; ++p, s0 = s0 + 1 < kDownSlots ? s0 + 1 : 0) {
    issue(p + kDownAhead, s0 + kDownAhead < kDownSlots ? s0 + kDownAhead : s0 + kDownAhead - kDownSlots);
    for (; czr < czw; ++czr) restrict_yx(czr);
    const int q = p - 1;
    if (q >= rz0 && q <= rz1) {
      const bool plane_ok = q >= 1 && q <= nz - 2;
      const C* zm = sring + slot_back(s0, 2) * kSolPlane;
      const C* b = sring + slot_back(s0, 1) * kSolPlane;
      const C* zp = sring + s0 * kSolPlane;
      const C* rq = rring + slot_back(s0, 1) * kResPlane - S;
      const int k0 = (q - t.lo[0]) & 1, c0 = (q - t.lo[0] - k0) >> 1;
      const bool tap0 = k0 < t.n[0] && c0 >= cz.c0 && c0 < cz.c1;
      const bool tap2 = k0 == 0 && t.n[0] > 2 && c0 - 1 >= cz.c0 && c0 - 1 < cz.c1;
      const C w0 = k0 ? t.w[0][1] : t.w[0][0];
      const bool first0 = q == max(2 * c0 + t.lo[0], 0);  // q is c0's first tap in the array
      const bool first2 = q == max(2 * (c0 - 1) + t.lo[0], 0);
#pragma unroll
      for (int k = 0; k < kPairsPer; ++k) {
        if (!(fl[k] & 16)) continue;
        const int o = os[k];
        const V2 c = *reinterpret_cast<const V2*>(b + o);
        const V2 ym = *reinterpret_cast<const V2*>(b + o - S);
        const V2 yp = *reinterpret_cast<const V2*>(b + o + S);
        const V2 dm = *reinterpret_cast<const V2*>(zm + o);
        const V2 dp = *reinterpret_cast<const V2*>(zp + o);
        const V2 rr = *reinterpret_cast<const V2*>(rq + o);
        const C xl = b[o - 1], xr = b[o + 2];
        C ra = C(0), rb = C(0);
        if (plane_ok && (fl[k] & 4)) {
          C au = s.c[0] * c.x;
          au = au + s.c[1] * dm.x;
          au = au + s.c[2] * dp.x;
          au = au + s.c[3] * ym.x;
          au = au + s.c[4] * yp.x;
          au = au + s.c[5] * xl;
          au = au + s.c[6] * c.y;
          ra = round_stored<T>(rr.x - au);
        }
        if (plane_ok && (fl[k] & 8)) {
          C au = s.c[0] * c.y;
          au = au + s.c[1] * dm.y;
          au = au + s.c[2] * dp.y;
          au = au + s.c[3] * ym.y;
          au = au + s.c[4] * yp.y;
          au = au + s.c[5] * c.x;
          au = au + s.c[6] * xr;
          rb = round_stored<T>(rr.y - au);
        }
        // The running z-sums in shared memory, by coarse plane parity; a
        // plane's first tap starts its sum from zero.
        auto add = [&](int cc, C w, bool first) {
          V2* z = reinterpret_cast<V2*>(zacc + (cc & 1) * kResPlane - S + o);
          V2 v = *z;
          if (first) v.x = v.y = C(0);
          v.x = v.x + w * ra;
          v.y = v.y + w * rb;
          *z = v;
        };
        if (tap0) add(c0, w0, first0);
        if (tap2) add(c0 - 1, t.w[0][2], first2);
      }
      for (; czw < cz.c1 && last_of(czw) == q; ++czw) {
      }  // czw's sums are complete: restricted after the barrier
    }
    cp_async_wait<kDownAhead - 1>();
    __syncthreads();
  }
  for (; czr < czw; ++czr) restrict_yx(czr);
}

size_t restrict_smem(size_t itemsize) {
  return (kDownSlots * (kSolPlane + kResPlane) + 2 * kResPlane) * itemsize;
}

template <typename T>
cudaError_t launch_restrict(const void* sol, const void* rhs, void* out, int nz, int ny, int nx,
                            int nzc, int nyc, int nxc, const double* coefs, const double* taps,
                            const int* ntaps, const int* lo, int chunk, cudaStream_t stream) {
  if (chunk < 2 || chunk % 2) return cudaErrorInvalidValue;
  using C = compute_t<T>;
  const size_t smem = restrict_smem(sizeof(C));
  cudaError_t err = cudaFuncSetAttribute(restrict_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(own_tiles(nxc, kDownTileX), own_tiles(nyc, kDownTileY), own_tiles(nzc, chunk / 2));
  restrict_kernel<T><<<grid, kTransferThreads, smem, stream>>>(
      static_cast<const T*>(sol), static_cast<const T*>(rhs), static_cast<T*>(out), nz, ny, nx,
      nzc, nyc, nxc, chunk, make_star<C>(coefs), make_taps<C>(taps, ntaps, lo));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_prolong(void* sol, const void* solc, int nz, int ny, int nx, int nzc, int nyc,
                           int nxc, const double* taps, const int* ntaps, const int* lo, int chunk,
                           cudaStream_t stream) {
  if (chunk < 1) return cudaErrorInvalidValue;
  const dim3 grid(inner_tiles(nx, kUpTileX), inner_tiles(ny, kUpTileY), inner_tiles(nz, chunk));
  prolong_kernel<T><<<grid, kTransferThreads, 0, stream>>>(
      static_cast<T*>(sol), static_cast<const T*>(solc), nz, ny, nx, nzc, nyc, nxc, chunk,
      make_taps<compute_t<T>>(taps, ntaps, lo));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers except
// coefs[7], taps[3*kMaxTaps], ntaps[3] and lo[3], which are host arrays
// copied into the launch parameters; `chunk` is the fine z-planes of one
// block (K4: even); `dtype` the fields' dtype code (star3d.cuh DType; an
// unknown one is cudaErrorInvalidValue).  Each entry launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" {

int exa_max_taps() { return kMaxTaps; }

const char* exa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The layout constants the wrapper mirrors (ops/cuda/stream3d.py), in
// order: kUpTileY, kUpTileX, kDownTileY, kDownTileX, kTransferThreads,
// kTransferChunk, kDownAhead.
int exa_transfer_constant(int i) {
  const int c[] = {kUpTileY, kUpTileX, kDownTileY, kDownTileX, kTransferThreads, kTransferChunk,
                   kDownAhead};
  return i >= 0 && i < 7 ? c[i] : -1;
}

int exa_residual_restrict(const void* sol, const void* rhs, void* out, int nz, int ny, int nx,
                          int nzc, int nyc, int nxc, const double* coefs, const double* taps,
                          const int* ntaps, const int* lo, int chunk, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, static_cast<int>(cudaErrorInvalidValue), [&](auto* z) {
    return static_cast<int>(launch_restrict<std::remove_pointer_t<decltype(z)>>(
        sol, rhs, out, nz, ny, nx, nzc, nyc, nxc, coefs, taps, ntaps, lo, chunk, s));
  });
}

int exa_prolong_correct(void* sol, const void* solc, int nz, int ny, int nx, int nzc, int nyc,
                        int nxc, const double* taps, const int* ntaps, const int* lo, int chunk,
                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, static_cast<int>(cudaErrorInvalidValue), [&](auto* z) {
    return static_cast<int>(launch_prolong<std::remove_pointer_t<decltype(z)>>(
        sol, solc, nz, ny, nx, nzc, nyc, nxc, taps, ntaps, lo, chunk, s));
  });
}

}  // extern "C"
