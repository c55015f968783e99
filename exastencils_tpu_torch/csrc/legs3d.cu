// The whole multigrid legs of the v2 schedule as one launch each, for 3D
// radius-1 star stencils on Hopper (sm_90a):
//   K1 = exastencils_tpu/ops/pallas/stream3d_pair.py:_smooth_down_kernel_p2
//        K damped RBGS iterations + residual + 2:1 restriction, the down leg
//        (wrapper ops/cuda/stream3d.smooth_res_restrict)
//   K2 = exastencils_tpu/ops/pallas/stream3d_pair.py:_up_smooth_kernel_p2
//        sol += P sol_c on inner nodes + K damped RBGS iterations, the up leg
//        (wrapper ops/cuda/stream3d.prolong_correct_smooth)
// Both are one kernel, leg_kernel, in three modes: kProlong (K2), kRestrict
// (K1) and kSmooth (no transfer), which is also
//   K3 = exastencils_tpu/ops/pallas/stream3d_pair.py:94 _rbgs_kernel_p2
//        K damped RBGS iterations, the fused smoother, with excl planes
//        (wrapper ops/cuda/stream3d.rbgs_fused)
// and smooths the extra iterations of a K1/K2 deeper than one launch holds:
// up to kMaxLegK iterations a launch as shared memory and threads allow.
//
// What is computed is the TPU kernels' (and the plain PyTorch path's) to the
// last bit in the smoothing: star3d.cuh's arithmetic (the reference term
// order, global (z+y+x)%2 parity, red first, built with --fmad=false), the
// Dirichlet ring and the excl planes never written.  K1 restricts in K4's
// order (z innermost, then y, then x), so its coarse rhs is bitwise that of
// K3 + K4 (stream3d.cu restrict_kernel); K2 prolongs with K5's arithmetic
// (stream3d.cu prolong_kernel: inner, non-excl nodes only, bc not
// reapplied), so K2 is bitwise K5 + K3.  The transfer taps stay general (Taps<T>, up to kMaxTaps per dim, any
// lo).
//
// Bound: device-memory bytes.  A leg must read sol and rhs and write sol
// once, and read or write the coarse array once: (3N + Nc) values, 1.69 GB
// at 513^3 f32, 0.50 ms at the H100's 3.35 TB/s.  The arithmetic (16
// flops per node and iteration, no tensor cores: TF32 would break the
// bitwise parity) is a fifth of that at the 67 TFLOP/s f32 rate.  The
// earlier design (stream3d.cu) made 2K+1 launches per leg, ~184 B/DOF;
// the first single-pass wavefronts K7/K8 ran 289 chains of 519
// plane steps in one under-filled wave, waiting on every load.  This design:
//
// - One pass per leg.  Each block owns a kLegTile^2 (y, x) tile of a
//   z-chunk (at most kLegChunk planes) and streams the planes of its window (the tile
//   plus a halo of 2K nodes; K1: 2K+1 plus the restriction's reach) through
//   a ring in shared memory.  When plane p arrives, half-sweep l (red for
//   odd l) runs on plane p-l, l = 1..2K, which equals K sequential
//   iterations; half-sweep l skips the outer l nodes of the window and the
//   planes further than 2K-l from the chunk, which no output reads.  The
//   chunk's z-halo (2K planes each side, K1: those its coarse planes read)
//   is recomputed by the neighbouring chunks' blocks as well.  K1 adds each
//   residual plane, as it becomes final, to per-thread z-sums of the coarse
//   planes it is a tap of; a completed coarse plane's sums go to a box in
//   shared memory, from which the y/x taps are summed the step after.
// - Fill the card.  Splitting z as well as (y, x) gives 17 x 17 x 5 = 1445
//   blocks of ~140 plane steps at 513^3, ~11 waves of one block per SM,
//   against 289 chains of 519 steps for K7/K8.  The tile is large because
//   the halo's redundant work, not occupancy, was what cost most on the
//   card (PERF.md: 16x32 to 32x32 tiles took K2 from 7.3 to 5.2 ms at
//   K=3); a K2 block is one thread per pair of window columns (992 at K=3),
//   a K1 block, wider by its halo, two pairs per thread (576).
// - Never wait on a load.  Planes p+1 .. p+kLegAhead of sol and rhs (K2:
//   and the coarse planes they prolong from) are in flight (cp.async) while
//   plane p is swept.  rhs has its own ring beside sol's, and each thread
//   reads only its own nodes' rhs there: never from L2 at update time.
// - No idle lanes, no bank conflicts.  Planes are stored colour-split: the
//   even and the odd x of each row in two arrays, one thread per pair of
//   columns.  At step p every half-sweep's active nodes are those with
//   p + y + x odd, one column of every pair, so each thread updates its
//   active column 2K times and a warp's neighbour reads touch consecutive
//   words.  The z-neighbour above is the value the thread just computed.
// - Race-free.  Windows overlap, so no block may write sol while others
//   load it: the result goes to a second array, which the wrapper copies
//   back into sol (~0.36 ms at 513^3 f32, counted in the leg's time), or,
//   for chained launches, uses as the next input.
// - K3 is one kSmooth launch per call (chained beyond kMaxLegK).  It
//   replaces 2K launches of a half-sweep kernel, each a pass over sol and
//   rhs (4.77 ms at 513^3 f32, K=3, on an H100).

#include <algorithm>

#include "star3d.cuh"

namespace {

using namespace exa;

constexpr int kLegTile = 32;     // fine (y, x) output tile edge (even: K1's coarse tile is half)
constexpr int kLegChunk = 128;   // fine z-planes per block, at most (the wrapper halves it on
                                 // levels too small to give each SM two blocks)
constexpr int kLegAhead = 2;     // planes in flight ahead of the one being swept
constexpr int kMaxLegK = 3;      // iterations one launch holds (kernels instantiated 1..kMaxLegK;
                                 // K=4's window would not fit 1024 threads, and K3 at K=4 as one
                                 // launch of two pairs of columns a thread was slower on an H100
                                 // than launches of 3 and 1: PERF.md §6)
constexpr int kMaxUpThreads = 1024;   // K2's and kSmooth's block, at most
constexpr int kMaxDownThreads = 768;  // K1's (two pairs of columns a thread)
constexpr int kCoarseSlots = 4;  // K2's ring of coarse planes (enough for kLegAhead <= 2)
constexpr int kResSlots = 4;     // K1's ring of boxes of z-sums

enum Mode { kSmooth = 0, kProlong = 1, kRestrict = 2 };

// K1's window, wider by its halo, has more pairs of columns than a block
// has threads: each of its threads takes two.
__device__ __host__ constexpr int leg_pairs_per_thread(int mode) { return mode == kRestrict ? 2 : 1; }

// The block's window: the tile plus `halo` nodes per side, global origin
// (wy0, wx0).  A plane is stored colour-split, (x parity, row, x / 2): the
// pair (row ly, columns 2 jx and 2 jx + 1) is thread ly * RH + jx's, at
// offsets e and e + odd.
struct Geom {
  int halo, R, RH, odd, plane, wy0, wx0, ty0, tx0;
};

__device__ __host__ inline Geom geom_for(int mode, int K, int reach, int by, int bx) {
  Geom g;
  g.halo = mode == kRestrict ? 2 * K + 1 + reach : 2 * K;
  g.R = kLegTile + 2 * g.halo;
  g.RH = g.R / 2;
  g.odd = g.R * g.RH;
  g.plane = 2 * g.odd;
  g.ty0 = by * kLegTile;
  g.tx0 = bx * kLegTile;
  g.wy0 = g.ty0 - g.halo;
  g.wx0 = g.tx0 - g.halo;
  return g;
}

// K2's coarse planes: a box of each covering every coarse node the
// window's fine nodes prolong from.
__device__ __host__ inline int coarse_edge(int R) { return (R + kMaxTaps) / 2 + 1; }

// K1: coarse plane cz of the block's coarse tile from its box of z-sums
// (zbox: for each fine (y, x) of the tile plus `reach`, the residual summed
// over cz's z taps), summed as K4 sums: the z sums are its
// innermost ones, then y, then x.
template <typename T>
__device__ void restrict_yx(T* __restrict__ outc, const T* zbox, int cz, int ny, int nx,
                            int nyc, int nxc, int reach, const Geom& g, const Taps<T>& t) {
  const int rx = kLegTile + 2 * reach;
  constexpr int ct = kLegTile / 2;  // coarse tile edge
  const int by = g.ty0 - reach, bx = g.tx0 - reach;  // box origin
  const int cy0 = g.ty0 / 2, cx0 = g.tx0 / 2;
  for (int i = threadIdx.x; i < ct * ct; i += blockDim.x) {
    const int cy = cy0 + i / ct, cx = cx0 + i % ct;
    if (cy >= nyc || cx >= nxc) continue;
    T acc_x = T(0);
#pragma unroll
    for (int kx = 0; kx < kMaxTaps; ++kx) {
      const int x = 2 * cx + t.lo[2] + kx;
      if (kx >= t.n[2] || x < 0 || x >= nx) continue;
      T acc_y = T(0);
#pragma unroll
      for (int ky = 0; ky < kMaxTaps; ++ky) {
        const int y = 2 * cy + t.lo[1] + ky;
        if (ky >= t.n[1] || y < 0 || y >= ny) continue;
        acc_y = acc_y + t.w[1][ky] * zbox[(y - by) * rx + x - bx];
      }
      acc_x = acc_x + t.w[2][kx] * acc_y;
    }
    outc[(static_cast<int64_t>(cz) * nyc + cy) * nxc + cx] = acc_x;
  }
}

// The block's z-extent.  Fine output planes [z0, z1); K1's coarse planes
// [cz0, cz1) and the residual planes [rz0, rz1] they read; the planes
// [zf0, zf1] that must be final (smoothed K times).
struct Span {
  int z0, z1, cz0, cz1, rz0, rz1, zf0, zf1;
};

template <typename T>
__device__ Span span_for(int bz, int chunk, int nz, int nzc, bool down, const Taps<T>& t) {
  Span sp;
  sp.z0 = bz * chunk;
  sp.z1 = min(sp.z0 + chunk, nz);
  sp.zf0 = sp.z0;
  sp.zf1 = sp.z1 - 1;
  sp.cz0 = sp.cz1 = 0;
  sp.rz0 = 0;
  sp.rz1 = -1;
  if (down) {
    sp.cz0 = bz * (chunk / 2);
    sp.cz1 = min(sp.cz0 + chunk / 2, nzc);
    if (sp.cz0 < sp.cz1) {
      sp.rz0 = max(2 * sp.cz0 + t.lo[0], 0);
      sp.rz1 = min(2 * (sp.cz1 - 1) + t.lo[0] + t.n[0] - 1, nz - 1);
      sp.zf0 = min(sp.zf0, sp.rz0 - 1);
      sp.zf1 = max(sp.zf1, sp.rz1 + 1);
    }
  }
  sp.zf0 = max(sp.zf0, 0);
  sp.zf1 = min(sp.zf1, nz - 1);
  return sp;
}

// One thread's pair of window columns (row ly, columns 2 jx and 2 jx + 1):
// the even column's split offset e (the odd one's is e + odd), the global
// row and even column, how many half-sweeps each column takes before the
// window's shrinking edge reaches it (dist), whether it is inside the array
// (in) and updatable (ok: off the Dirichlet ring and the y/x excl planes),
// and its offsets within a plane of sol.  Scalars picked by select: an
// array indexed by a runtime column would live in local memory.
struct Pair {
  int e, ly, jx, gy, gx, dist0, dist1;
  bool mine, in0, in1, ok0, ok1;
  int64_t g0, g1;
};

__device__ __forceinline__ Pair pair_at(int e, const Geom& g, int ny, int nx, const Excl& ex) {
  Pair c;
  c.e = e;
  c.mine = e < g.odd;
  c.ly = e / g.RH;
  c.jx = e - c.ly * g.RH;
  c.gy = g.wy0 + c.ly;
  c.gx = g.wx0 + 2 * c.jx;
  const bool row_ok = c.mine && c.gy >= 1 && c.gy <= ny - 2 && c.gy != ex.p[2] && c.gy != ex.p[3];
  auto col_ok = [&](int x) { return row_ok && x >= 1 && x <= nx - 2 && x != ex.p[4] && x != ex.p[5]; };
  c.ok0 = col_ok(c.gx);
  c.ok1 = col_ok(c.gx + 1);
  const int dy = min(c.ly, g.R - 1 - c.ly);
  c.dist0 = min(dy, min(2 * c.jx, g.R - 1 - 2 * c.jx));
  c.dist1 = min(dy, min(2 * c.jx + 1, g.R - 2 - 2 * c.jx));
  const bool row_in = c.mine && c.gy >= 0 && c.gy < ny;
  c.in0 = row_in && c.gx >= 0 && c.gx < nx;
  c.in1 = row_in && c.gx + 1 >= 0 && c.gx + 1 < nx;
  c.g0 = c.in0 ? static_cast<int64_t>(c.gy) * nx + c.gx : 0;
  c.g1 = c.in1 ? static_cast<int64_t>(c.gy) * nx + c.gx + 1 : 0;
  return c;
}

template <typename T, int K, int MODE>
__global__ void __launch_bounds__(MODE == kRestrict ? kMaxDownThreads : kMaxUpThreads)
leg_kernel(T* __restrict__ out, T* __restrict__ outc, const T* __restrict__ sol,
           const T* __restrict__ solc, const T* __restrict__ rhs, int nz, int ny, int nx,
           int nzc, int nyc, int nxc, Star<T> s, T scale, int reach, int chunk, Taps<T> t,
           Excl ex) {
  constexpr int L = 2 * K;  // half-sweeps
  constexpr bool up = MODE == kProlong, down = MODE == kRestrict;
  constexpr int S = L + 2 + down + kLegAhead;  // ring slots, of sol and of rhs
  constexpr int NP = leg_pairs_per_thread(MODE);
  extern __shared__ __align__(16) unsigned char smem[];
  const Span sp = span_for(blockIdx.z, chunk, nz, nzc, down, t);
  if (sp.zf0 > sp.zf1) return;  // block-uniform: nothing to compute
  const Geom g = geom_for(MODE, K, reach, blockIdx.y, blockIdx.x);
  T* ring = reinterpret_cast<T*>(smem);
  T* rring = ring + S * g.plane;
  T* extra = rring + S * g.plane;  // K2: coarse ring; K1: boxes of z-sums
  const int pstart = sp.zf0 - L, pend = sp.zf1 + L + 2 * down;
  const int lz0 = max(pstart, 0), lz1 = min(sp.zf1 + L, nz - 1);  // planes loaded
  const int zlo = sp.zf0 - L;  // half-sweep l runs on planes >= zlo + l
  const int odd = g.odd;
  Pair pr[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) pr[k] = pair_at(threadIdx.x + k * blockDim.x, g, ny, nx, ex);

  // K2's coarse boxes, and the y and x taps of the thread's columns (the z
  // taps change with the plane).
  const int cry = coarse_edge(g.R), crx = coarse_edge(g.R), cbox = cry * crx;
  const int cy0 = floor_half(g.wy0 - t.lo[1] - (kMaxTaps - 1));
  const int cx0 = floor_half(g.wx0 - t.lo[2] - (kMaxTaps - 1));
  int cz_next = max(floor_half(lz0 - t.lo[0] - (t.n[0] - 1)), 0);  // first coarse plane not loaded
  TapPair<T> py[NP], px0[NP], px1[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    py[k] = tap_pair(pr[k].gy, nyc, t.w[1], t.n[1], t.lo[1]);
    px0[k] = tap_pair(pr[k].gx, nxc, t.w[2], t.n[2], t.lo[2]);
    px1[k] = tap_pair(pr[k].gx + 1, nxc, t.w[2], t.n[2], t.lo[2]);
  }
  // K1's boxes of z-sums: the tile plus `reach`, at window offset boff;
  // the running z-sums of the thread's columns (za: even column, zb: odd
  // column; [0]/[1]: coarse planes of even/odd index), the next coarse
  // plane to complete (czw) and to restrict (czr).
  const int rry = kLegTile + 2 * reach, rrx = kLegTile + 2 * reach;
  const int boff = g.halo - reach;
  bool box0[NP], box1[NP];
  T za[NP][2], zb[NP][2];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int iy = pr[k].ly - boff, ix = 2 * pr[k].jx - boff;
    const bool row = pr[k].mine && iy >= 0 && iy < rry;
    box0[k] = row && ix >= 0 && ix < rrx;
    box1[k] = row && ix + 1 >= 0 && ix + 1 < rrx;
    za[k][0] = za[k][1] = zb[k][0] = zb[k][1] = T(0);
  }
  int czw = sp.cz0, czr = sp.cz0;
  auto last_of = [&](int cz) { return min(max(2 * cz + t.lo[0] + t.n[0] - 1, 0), nz - 1); };

  // Plane pp of sol and rhs into ring slot `slot` (each thread its own
  // pairs; K2: and, by all threads, the coarse planes plane pp + 1
  // prolongs from, so that its z-sums can be formed a step early).  One
  // copy group per plane.  Block-uniform.
  auto issue = [&](int pp, int slot) {
    if (pp >= lz0 && pp <= lz1) {
      const int64_t zoff = static_cast<int64_t>(pp) * ny * nx;
      T* ds = ring + slot * g.plane;
      T* dr = rring + slot * g.plane;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const Pair& c = pr[k];
        if (!c.mine) continue;
        cp_async(ds + c.e, sol + zoff + c.g0, c.in0);
        cp_async(ds + odd + c.e, sol + zoff + c.g1, c.in1);
        cp_async(dr + c.e, rhs + zoff + c.g0, c.in0);
        cp_async(dr + odd + c.e, rhs + zoff + c.g1, c.in1);
      }
      if constexpr (up) {
        for (const int hi = min(floor_half(pp + 1 - t.lo[0]), nzc - 1); cz_next <= hi; ++cz_next) {
          const T* src = solc + static_cast<int64_t>(cz_next) * nyc * nxc;
          T* dst = extra + (cz_next % kCoarseSlots) * cbox;
          for (int i = threadIdx.x; i < cbox; i += blockDim.x) {
            const int cy = cy0 + i / crx, cx = cx0 + i % crx;
            const bool in = cy >= 0 && cy < nyc && cx >= 0 && cx < nxc;
            cp_async(dst + i, in ? src + static_cast<int64_t>(cy) * nxc + cx : src, in);
          }
        }
      }
    }
    cp_async_commit();
  };
  auto slot_back = [](int slot, int n) { return slot - n < 0 ? slot - n + S : slot - n; };
  // K2: the z-sums of the coarse box for fine plane q (K5's
  // innermost sums, in its order), by all threads, into the slot
  // (q - pstart) % 2 of two; q's coarse planes must have arrived.
  T* zsum = extra + kCoarseSlots * cbox;
  auto coarse_z = [&](int q) {
    const TapPair<T> pz = tap_pair(q, nzc, t.w[0], t.n[0], t.lo[0]);
    const T* cza = extra + (pz.c0 & (kCoarseSlots - 1)) * cbox;  // read only where valid
    const T* czb = extra + ((pz.c0 - 1) & (kCoarseSlots - 1)) * cbox;
    T* dst = zsum + ((q - pstart) & 1) * cbox;
    for (int i = threadIdx.x; i < cbox; i += blockDim.x) {
      T acc = T(0);
      if (pz.v0) acc = acc + pz.w0 * cza[i];
      if (pz.v1) acc = acc + pz.w1 * czb[i];
      dst[i] = acc;
    }
  };

#pragma unroll
  for (int j = 0; j < kLegAhead; ++j) issue(pstart + j, j);
  cp_async_wait<kLegAhead - 1>();
  __syncthreads();
  if constexpr (up) {
    coarse_z(pstart);
    __syncthreads();
  }
  for (int p = pstart, s0 = 0; p <= pend; ++p, s0 = s0 + 1 < S ? s0 + 1 : 0) {
    issue(p + kLegAhead, s0 + kLegAhead < S ? s0 + kLegAhead : s0 + kLegAhead - S);
    T* bp = ring + s0 * g.plane;

    // K2's ingest: plane p += P sol_c on the thread's inner, non-excl
    // nodes, summed as K5 sums (z innermost, from the z-sums of
    // the last step; then y, then x, taps in increasing order).  Only this
    // thread reads its columns of plane p before the step's end.
    if (up && p >= lz0 && p <= lz1 && p >= 1 && p <= nz - 2 && p != ex.p[0] && p != ex.p[1]) {
      const T* zs = zsum + ((p - pstart) & 1) * cbox;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int oy = (py[k].c0 - cy0) * crx;
        auto sum_y = [&](int o) {
          T acc = T(0);
          if (py[k].v0) acc = acc + py[k].w0 * zs[oy + o];
          if (py[k].v1) acc = acc + py[k].w1 * zs[oy - crx + o];
          return acc;
        };
        auto sum_x = [&](const TapPair<T>& px) {
          const int o = px.c0 - cx0;
          T acc = T(0);
          if (px.v0) acc = acc + px.w0 * sum_y(o);
          if (px.v1) acc = acc + px.w1 * sum_y(o - 1);
          return acc;
        };
        const int e = pr[k].e;
        if (pr[k].ok0) bp[e] = bp[e] + sum_x(px0[k]);
        if (pr[k].ok1) bp[odd + e] = bp[odd + e] + sum_x(px1[k]);
      }
    }
    // The next plane's z-sums, into the slot no thread reads this step
    // (its coarse planes came with plane p's copy group).
    if constexpr (up) coarse_z(p + 1);

    // K1: the coarse planes whose z-sums the last step completed (each
    // coarse plane by exactly one block: its chunk's).
    if constexpr (down) {
      for (const int qp = p - L - 2; czr < sp.cz1 && last_of(czr) == qp; ++czr)
        restrict_yx(outc, extra + (czr % kResSlots) * rry * rrx, czr, ny, nx, nyc, nxc, reach,
                    g, t);
    }

    // Half-sweep l on plane p - l, l = 1..2K, all on the thread's active
    // column of each pair; the only reads of this step's writes are of the
    // column's own z-neighbours, made by this thread, so no barrier is
    // needed between the half-sweeps.  The z-neighbour above is the value
    // the thread just computed.
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const Pair& c = pr[k];
      if (!c.mine) continue;
      const int a = (1 + p + c.gy + c.gx) & 1;
      const bool oka = a ? c.ok1 : c.ok0;
      const int dista = a ? c.dist1 : c.dist0;
      const int li = a ? odd + c.e : c.e;
      const int xm = a ? c.e : odd + c.e - 1, xp = a ? c.e + 1 : odd + c.e;
      int sq = s0;  // slot of plane q + 1
      T zp = bp[li];
#pragma unroll
      for (int l = 1; l <= L; ++l) {
        const int q = p - l;
        const int sl = slot_back(sq, 1), sm = slot_back(sq, 2);
        T* b = ring + sl * g.plane;
        const T cen = b[li];
        T v = cen;
        if (oka && l <= dista && q >= max(zlo + l, 1) && q <= nz - 2 && q != ex.p[0] &&
            q != ex.p[1]) {
          T au = s.c[0] * cen;
          au = au + s.c[1] * ring[sm * g.plane + li];
          au = au + s.c[2] * zp;
          au = au + s.c[3] * b[li - g.RH];
          au = au + s.c[4] * b[li + g.RH];
          au = au + s.c[5] * b[xm];
          au = au + s.c[6] * b[xp];
          const T corr = scale * (rring[sl * g.plane + li] - au);
          v = cen + corr;
          b[li] = v;
        }
        zp = v;
        sq = sl;
      }
    }

    // Plane p - 2K is final: the tile's nodes to out.
    const int qo = p - L;
    if (qo >= sp.z0 && qo < sp.z1) {
      const T* b = ring + slot_back(s0, L) * g.plane;
      T* o = out + static_cast<int64_t>(qo) * ny * nx;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const Pair& c = pr[k];
        if (!c.mine || c.ly < g.halo || c.ly >= g.halo + kLegTile) continue;
        const int lx = 2 * c.jx;
        if (c.in0 && lx >= g.halo && lx < g.halo + kLegTile) o[c.g0] = b[c.e];
        if (c.in1 && lx + 1 >= g.halo && lx + 1 < g.halo + kLegTile) o[c.g1] = b[odd + c.e];
      }
    }

    // K1: the residual of plane qr = p - 2K - 1 (its z+1 plane final this
    // step) on the thread's columns, added to the z-sums of the coarse
    // planes it is a tap of, in tap order; a coarse plane whose last tap
    // this is goes to its box.
    const int qr = p - L - 1;
    if (down && qr >= sp.rz0 && qr <= sp.rz1) {
      const bool plane_ok = qr >= 1 && qr <= nz - 2 && qr != ex.p[0] && qr != ex.p[1];
      const T* zm = ring + slot_back(s0, L + 2) * g.plane;
      const T* b = ring + slot_back(s0, L + 1) * g.plane;
      const T* zq = ring + slot_back(s0, L) * g.plane;
      const T* rq = rring + slot_back(s0, L + 1) * g.plane;
      auto residual = [&](bool ok, int li, int xm, int xp) {
        if (!ok) return T(0);
        T au = s.c[0] * b[li];
        au = au + s.c[1] * zm[li];
        au = au + s.c[2] * zq[li];
        au = au + s.c[3] * b[li - g.RH];
        au = au + s.c[4] * b[li + g.RH];
        au = au + s.c[5] * b[xm];
        au = au + s.c[6] * b[xp];
        return rq[li] - au;
      };
      const int k0 = (qr - t.lo[0]) & 1, c0 = (qr - t.lo[0] - k0) >> 1;
      const bool tap0 = k0 < t.n[0] && c0 >= sp.cz0 && c0 < sp.cz1;
      const bool tap2 = k0 == 0 && t.n[0] > 2 && c0 - 1 >= sp.cz0 && c0 - 1 < sp.cz1;
      const T w0 = k0 ? t.w[0][1] : t.w[0][0];
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const Pair& c = pr[k];
        const T v0 = residual(plane_ok && c.ok0 && box0[k], c.e, odd + c.e - 1, odd + c.e);
        const T v1 = residual(plane_ok && c.ok1 && box1[k], odd + c.e, c.e, c.e + 1);
        auto add = [&](int cz, T w) {
          if (cz & 1) {
            za[k][1] = za[k][1] + w * v0;
            zb[k][1] = zb[k][1] + w * v1;
          } else {
            za[k][0] = za[k][0] + w * v0;
            zb[k][0] = zb[k][0] + w * v1;
          }
        };
        if (tap0) add(c0, w0);
        if (tap2) add(c0 - 1, t.w[0][2]);
      }
      for (; czw < sp.cz1 && last_of(czw) == qr; ++czw) {
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          T* dst = extra + (czw % kResSlots) * rry * rrx + (pr[k].ly - boff) * rrx +
                   2 * pr[k].jx - boff;
          if (czw & 1) {
            if (box0[k]) dst[0] = za[k][1];
            if (box1[k]) dst[1] = zb[k][1];
            za[k][1] = zb[k][1] = T(0);
          } else {
            if (box0[k]) dst[0] = za[k][0];
            if (box1[k]) dst[1] = zb[k][0];
            za[k][0] = zb[k][0] = T(0);
          }
        }
      }
    }
    cp_async_wait<kLegAhead - 1>();  // plane p + 1 has arrived
    __syncthreads();
  }
}

// Dynamic shared memory of one block: the rings of sol and rhs, then K2's
// coarse ring and two boxes of z-sums, or K1's boxes of z-sums.
size_t leg_smem(int mode, int K, int reach, size_t itemsize) {
  const bool up = mode == kProlong, down = mode == kRestrict;
  const Geom g = geom_for(mode, K, reach, 0, 0);
  const size_t slots = 2 * (2 * K + 2 + down + kLegAhead);
  const size_t extra = up ? (kCoarseSlots + 2) * coarse_edge(g.R) * coarse_edge(g.R)
                       : down ? kResSlots * (kLegTile + 2 * reach) * (kLegTile + 2 * reach)
                              : 0;
  return (slots * g.plane + extra) * itemsize;
}

// Threads of one block: its pairs of window columns, leg_pairs_per_thread
// to a thread, in whole warps.
int leg_threads(int mode, int K, int reach) {
  const Geom g = geom_for(mode, K, reach, 0, 0);
  const int np = leg_pairs_per_thread(mode);
  return ((g.odd + np - 1) / np + 31) / 32 * 32;
}


int tiles(int n, int tile) { return (n + tile - 1) / tile; }

template <typename T, int MODE>
auto leg_kernel_for(int K) {
  return K == 1 ? leg_kernel<T, 1, MODE> : K == 2 ? leg_kernel<T, 2, MODE> : leg_kernel<T, 3, MODE>;
}

template <typename T>
auto leg_kernel_for(int K, int mode) {
  return mode == kProlong ? leg_kernel_for<T, kProlong>(K)
       : mode == kRestrict ? leg_kernel_for<T, kRestrict>(K) : leg_kernel_for<T, kSmooth>(K);
}

// Blocks of one launch resident on one SM (registers, shared memory and
// threads all counted), or -1.
template <typename T>
int leg_occupancy(int mode, int K, int reach) {
  if (K < 1 || K > kMaxLegK) return -1;
  const size_t smem = leg_smem(mode, K, reach, sizeof(T));
  auto kernel = leg_kernel_for<T>(K, mode);
  int blocks = -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, leg_threads(mode, K, reach),
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

template <typename T>
cudaError_t launch_leg(void* out, void* outc, const void* sol, const void* solc,
                       const void* rhs, int nz, int ny, int nx, int nzc, int nyc, int nxc,
                       const double* coefs, double scale, int K, int reach, int mode,
                       int chunk, const double* taps, const int* ntaps, const int* lo,
                       const int* excl, cudaStream_t stream) {
  if (K < 1 || K > kMaxLegK || chunk < 2 || chunk % 2) return cudaErrorInvalidValue;
  const size_t smem = leg_smem(mode, K, reach, sizeof(T));
  const int threads = leg_threads(mode, K, reach);
  if (threads > (mode == kRestrict ? kMaxDownThreads : kMaxUpThreads)) return cudaErrorInvalidValue;
  if (mode < kSmooth || mode > kRestrict) return cudaErrorInvalidValue;
  auto kernel = leg_kernel_for<T>(K, mode);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(tiles(nx, kLegTile), tiles(ny, kLegTile), tiles(nz, chunk));
  if (mode == kRestrict) {
    grid.x = std::max<int>(grid.x, tiles(nxc, kLegTile / 2));
    grid.y = std::max<int>(grid.y, tiles(nyc, kLegTile / 2));
    grid.z = std::max<int>(grid.z, tiles(nzc, chunk / 2));
  }
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<T*>(out), static_cast<T*>(outc), static_cast<const T*>(sol),
      static_cast<const T*>(solc), static_cast<const T*>(rhs), nz, ny, nx, nzc, nyc, nxc,
      make_star<T>(coefs), static_cast<T>(scale), reach, chunk, make_taps<T>(taps, ntaps, lo),
      make_excl(excl));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes, as stream3d.cu's.  `out` (and K1's `outc`)
// are new arrays, never aliases of the inputs; `solc` is read by kProlong
// only, `outc` written by kRestrict only (pass any pointer otherwise).  The
// transfer taps are the prolongation's for kProlong, the restriction's
// for kRestrict; `chunk` (even) is the fine z-planes of one block.  Returns
// the CUDA error of the launch.
extern "C" {

// The layout constants the wrapper mirrors (ops/cuda/stream3d.py), in order:
// kLegTile, kLegChunk, kLegAhead, kMaxLegK.
int exa_leg_constant(int i) {
  const int c[] = {kLegTile, kLegChunk, kLegAhead, kMaxLegK};
  return i >= 0 && i < 4 ? c[i] : -1;
}

long long exa_leg_smem(int mode, int K, int reach, int itemsize) {
  return static_cast<long long>(leg_smem(mode, K, reach, itemsize));
}

int exa_leg_occupancy(int mode, int K, int reach, int is_double) {
  return is_double ? leg_occupancy<double>(mode, K, reach) : leg_occupancy<float>(mode, K, reach);
}

int exa_leg(void* out, void* outc, const void* sol, const void* solc, const void* rhs, int nz,
            int ny, int nx, int nzc, int nyc, int nxc, const double* coefs, double scale, int K,
            int reach, int mode, int chunk, const double* taps, const int* ntaps,
            const int* lo, const int* excl, int is_double, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_double ? launch_leg<double>(out, outc, sol, solc, rhs, nz, ny, nx, nzc, nyc, nxc, coefs,
                                     scale, K, reach, mode, chunk, taps, ntaps, lo, excl, st)
                : launch_leg<float>(out, outc, sol, solc, rhs, nz, ny, nx, nzc, nyc, nxc, coefs,
                                    scale, K, reach, mode, chunk, taps, ntaps, lo, excl, st));
}

}  // extern "C"
