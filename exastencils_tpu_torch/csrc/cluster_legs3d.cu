// The v1 schedule's kernels as one launch each, for 3D radius-1 star
// stencils on Hopper (sm_90a), with the y/x halo shared through
// thread-block clusters:
//   K6 = exastencils_tpu/ops/pallas/stream3d.py:84 _rbgs_kernel
//        K damped RBGS iterations, the fused smoother, with excl planes
//        (wrapper ops/cuda/stream3d.rbgs_wavefront)
//   K7 = exastencils_tpu/ops/pallas/stream3d.py:475 _smooth_down_kernel
//        K damped RBGS iterations + residual + 2:1 restriction, the down leg
//        (wrapper ops/cuda/stream3d.smooth_res_restrict_wavefront)
//   K8 = exastencils_tpu/ops/pallas/stream3d.py:629 _up_smooth_kernel
//        sol += P sol_c on inner nodes + K damped RBGS iterations, the up leg
//        (wrapper ops/cuda/stream3d.prolong_correct_smooth_wavefront)
// All are one kernel, cluster_leg, in three modes: kSmooth (K6, no
// transfer), kProlong (K8) and kRestrict (K7).  A K deeper than one launch
// holds runs the rest as further K6 launches, K7 before its launch and K8
// after it.
//
// What is computed is the plain PyTorch path's to the last bit in the
// smoothing, and K1's/K2's (legs3d.cu) in both outputs: star3d.cuh's
// arithmetic (the reference term order, global (z+y+x)%2 parity, red first,
// built with --fmad=false), the Dirichlet ring and K6's excl planes never
// written (the updatable test is on global indices, so an excl plane on a
// tile, cluster or z-chunk edge is no special case; K7/K8 take no excl
// planes, as their TPU kernels); K7 restricts
// in K4's order (z innermost, then y, then x), K8 prolongs in K5's
// (z-sums per plane step, then at most four adds a node).
//
// Bound: device-memory bytes, as K1/K2: (3N + Nc) values, 1.69 GB at 513^3
// f32, 0.50 ms at 3.35 TB/s.  The first v1 wavefronts ran 289 chains of 519
// plane steps with rhs read from L2, 27 guarded prolongation taps a node
// and 2K+1 block barriers a step: 3.3-3.6% of the bound.  This design is
// legs3d.cu's (z-chunked one-pass legs, sol and rhs rings filled by
// cp.async kAhead planes ahead, colour-split planes with one thread per
// pair of columns, all 2K half-sweeps of a plane step without a barrier
// between them, K8's prolongation from per-step coarse z-sums), with:
//
// - Fewer blocks.  The array's last node, one past a tile (n = 513 =
//   16 * 32 + 1), belongs to that tile (own_range): a boundary node, never
//   updated, copied from sol.  513^3 is 16 x 16 x 5 = 1280 blocks, not
//   17 x 17 x 5 = 1445 of which 165 held a one-node-wide tile.
// - The y/x halo shared in clusters of cy x cx blocks (cx <= 2), which
//   cover a (cy * kTile) x (cx * kTile) region together.  A block keeps the
//   halo of 2K nodes (K7: 2K+1 plus the restriction's reach; x rounded up
//   to even) only on the sides where its cluster ends, and half-sweep l
//   skips the outer l nodes there.  On its inner sides it has no halo: a
//   node on the tile's edge reads its neighbour across the edge from the
//   neighbouring block's ring (distributed shared memory, map_shared_rank),
//   all 2K of a step's such reads at once.  At K=3 a block of K7's default
//   1 x 2 cluster has a 48 x 40 window (48 x 48 alone); in 2 x 2 clusters
//   K8's is 38^2 (44^2) and K7's 40^2.
// - One barrier a step.  At step p half-sweep l updates only the nodes of
//   plane p - l with p + y + x odd, and reads that plane's other nodes,
//   which only step p - 1 wrote.  So every block of a cluster runs the same
//   plane steps (they share one z-chunk), and one cluster barrier a step
//   takes the place of __syncthreads: a block barrier, one warp's releasing
//   arrive (step_arrive), then the wait.  Between the arrive and the wait
//   sits work no other block reads before the next step: the tile's store,
//   K7's residual (its coarse planes restricted a step later), K8's ingest
//   of plane p + 1 and the z-sums of plane p + 2.
// - What it bought (H100 SXM, 700 W, 513^3 f32, K=3, device ms of one
//   call): K7 4.74 on 1 x 2 clusters (2 x 2: 5.75, 4 x 2: 5.76, 2 x 1: 5.06,
//   alone: 5.50), K1 5.61; K8 3.60 alone (1 x 2: 3.75, 2 x 1: 3.88, 2 x 2:
//   4.43), K2 3.72.  For K7 the shared halo (48 x 40 against 48^2, and no
//   second pair of columns a thread) pays for the cluster barrier and the
//   reads across the edge; for K8 (44^2 -> 44 x 38) it does not, so K8
//   launches clusters of one (block barriers only).  2 x 2 and 4 x 2
//   clusters also strand SMs: 30 and 15 fit on the card at once (120 SMs).
// - Ring slots: a cp.async refills the slot of plane p - 2K - 2 (K7: - 3),
//   which no block reads in steps p and p + 1; the ring has 2K+2+kAhead
//   slots (K7: one more), as legs3d.cu's.
// - K7's residual on the tile (plus `reach` on the cluster's outer sides)
//   goes into per-thread z-sums and, per completed coarse plane, a box in
//   shared memory; the coarse nodes whose y/x taps cross an inner edge read
//   the neighbour's box.  Each coarse node is written by one block.
// - Blocks past the array (the grid is rounded up to whole clusters) run
//   every step and barrier with nothing to update: a block that returned
//   early would leave its cluster waiting.  The kernel ends with a cluster
//   barrier, so no block exits while another reads its memory.
// - Out of place: the result goes to a second array (windows overlap).
// - K6 is K8 without the coarse ring and the ingest: the sol and rhs rings
//   only (2K+2+kAhead slots), the window of the tile plus 2K, up to kMaxK
//   iterations a launch as shared memory allows (in float64 fewer).  On a
//   cluster of one (its default, the fastest) it is compiled apart
//   (ALONE): no reads across edges, no cluster barriers.  The
//   first K6, a single-plane wavefront, ran 289 blocks of 519 plane steps
//   with rhs read from L2 and 2K+1 block barriers a step (7.1 ms at 513^3
//   f32, K=3, on an H100).

#include <algorithm>

#include <cooperative_groups.h>

#include "star3d.cuh"

namespace {

using namespace exa;
namespace cg = cooperative_groups;

constexpr int kTile = 32;         // fine (y, x) output tile edge (even: K7's coarse tile is half)
constexpr int kAhead = 2;         // planes in flight ahead of the one being swept
constexpr int kMaxK = 3;          // iterations one launch holds (kernels instantiated 1..kMaxK; K6
                                  // at K=4 as one launch of two pairs of columns a thread was slower
                                  // on an H100 than launches of 3 and 1: PERF.md §6)
constexpr int kMaxThreads = 1024;
constexpr int kMaxThreads2 = 768;  // with two pairs a thread (registers for both)
constexpr int kMaxClusterX = 2;   // the window's row length is the same in every block up to 2
constexpr int kCoarseSlots = 4;   // K8's ring of coarse planes
constexpr int kResSlots = 4;      // K7's ring of boxes of z-sums

enum Mode { kSmooth = 0, kProlong = 1, kRestrict = 2 };  // legs3d.cu's values

__device__ __host__ inline int outer_halo(int mode, int K, int reach) {
  return mode == kRestrict ? 2 * K + 1 + reach : 2 * K;
}

// One block's window in a cluster of cy x cx blocks, at position (py, px)
// in it.  Rows of `RX` nodes, split by x parity into two arrays of `rows`
// x RXH values; `rows` (the most any block of the launch has) fixes the
// plane stride, so every block's ring has the same layout and a
// neighbour's node is found at the same offsets.
struct Geom {
  int hy, hx, RY, RX, RXH, rows, odd, plane, wy0, wx0, ty0, tx0;
  bool ylo, yhi, xlo, xhi;  // the side is the cluster's edge (halo there)
};

__device__ __host__ inline Geom geom_for(int mode, int K, int reach, int cy, int cx, int py,
                                         int px, int by, int bx) {
  Geom g;
  g.hy = outer_halo(mode, K, reach);
  g.hx = g.hy + (g.hy & 1);
  g.ylo = py == 0;
  g.yhi = py == cy - 1;
  g.xlo = px == 0;
  g.xhi = px == cx - 1;
  g.RY = kTile + g.hy * (g.ylo + g.yhi);
  g.RX = kTile + g.hx * (g.xlo + g.xhi);
  g.RXH = g.RX / 2;
  g.rows = kTile + g.hy * (cy == 1 ? 2 : 1);
  g.odd = g.rows * g.RXH;
  g.plane = 2 * g.odd;
  g.ty0 = by * kTile;
  g.tx0 = bx * kTile;
  g.wy0 = g.ty0 - (g.ylo ? g.hy : 0);
  g.wx0 = g.tx0 - (g.xlo ? g.hx : 0);
  return g;
}

// K8's coarse planes: a box of each covering every coarse node the
// window's fine nodes prolong from.
__device__ __host__ inline int coarse_edge(const Geom& g) {
  return ((g.rows > g.RX ? g.rows : g.RX) + kMaxTaps) / 2 + 1;
}

// The cluster barrier, split: writes before arrive are seen by every block
// of the cluster after its wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The end of a step's shared-memory writes: a block barrier, then the
// cluster barrier's arrive, releasing in one warp only: the release is
// cumulative over the block barrier, so it publishes what every thread of
// the block wrote, and one warp's cluster fence costs less than every
// warp's (on an H100, ~0.2 ms of K8's 4.9 at 513^3 f32 on 2 x 2 clusters).
// A cluster of one needs the block barrier only.
__device__ __forceinline__ void step_arrive(bool alone) {
  __syncthreads();
  if (alone) return;
  if (threadIdx.x < 32)
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  else
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// The block's z-extent, as legs3d.cu's span_for.  Fine output planes
// [z0, z1); K7's coarse planes [cz0, cz1) and the residual planes
// [rz0, rz1] they read; the planes [zf0, zf1] that must be final.
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
// offsets, global position, half-sweeps before the shrinking outer edge
// reaches each column (dist), inside the array (in), updatable (ok: off the
// Dirichlet ring and the y/x excl planes, by global index), and which of
// its in-plane neighbours lie in another block (edge: 1 y-, 2 y+, 4 x- of
// the even column, 8 x+ of the odd one).
struct Pair {
  int e, ly, jx, gy, gx, dist0, dist1, edge;
  bool mine, in0, in1, ok0, ok1;
  int64_t g0, g1;
};

__device__ __forceinline__ Pair pair_at(int e, const Geom& g, int ny, int nx, const Excl& ex) {
  constexpr int kFar = 1 << 20;
  Pair c;
  c.e = e;
  c.mine = e < g.RY * g.RXH;
  c.ly = e / g.RXH;
  c.jx = e - c.ly * g.RXH;
  c.gy = g.wy0 + c.ly;
  c.gx = g.wx0 + 2 * c.jx;
  const bool row_ok = c.mine && c.gy >= 1 && c.gy <= ny - 2 && c.gy != ex.p[2] && c.gy != ex.p[3];
  auto col_ok = [&](int x) { return row_ok && x >= 1 && x <= nx - 2 && x != ex.p[4] && x != ex.p[5]; };
  c.ok0 = col_ok(c.gx);
  c.ok1 = col_ok(c.gx + 1);
  const int dy = min(g.ylo ? c.ly : kFar, g.yhi ? g.RY - 1 - c.ly : kFar);
  auto dx = [&](int lx) { return min(g.xlo ? lx : kFar, g.xhi ? g.RX - 1 - lx : kFar); };
  c.dist0 = min(dy, dx(2 * c.jx));
  c.dist1 = min(dy, dx(2 * c.jx + 1));
  c.edge = c.mine ? (c.ly == 0 && !g.ylo) | (c.ly == g.RY - 1 && !g.yhi) << 1 |
                    (c.jx == 0 && !g.xlo) << 2 | (c.jx == g.RXH - 1 && !g.xhi) << 3
                  : 0;
  const bool row_in = c.mine && c.gy >= 0 && c.gy < ny;
  c.in0 = row_in && c.gx >= 0 && c.gx < nx;
  c.in1 = row_in && c.gx + 1 >= 0 && c.gx + 1 < nx;
  c.g0 = c.in0 ? static_cast<int64_t>(c.gy) * nx + c.gx : 0;
  c.g1 = c.in1 ? static_cast<int64_t>(c.gy) * nx + c.gx + 1 : 0;
  return c;
}

// A node's four in-plane neighbours.
template <typename T>
struct Nbrs {
  T ym, yp, xm, xp;
};

// The y- or y+ neighbour (c.edge & 1 or & 2) and the x- or x+ neighbour
// (column a = 0 or 1) across the inner edges, at ring offset o.
template <typename T>
__device__ __forceinline__ T remote_y(const T* const* nb, int nry, const Geom& g, const Pair& c,
                                      int a, int o) {
  return (c.edge & 1) ? nb[0][o + a * g.odd + (nry - 1) * g.RXH + c.jx]
                      : nb[1][o + a * g.odd + c.jx];
}

template <typename T>
__device__ __forceinline__ T remote_x(const T* const* nb, const Geom& g, const Pair& c, int a,
                                      int o) {
  return a ? nb[3][o + c.ly * g.RXH] : nb[2][o + g.odd + c.ly * g.RXH + g.RXH - 1];
}

// This block's neighbours (a neighbour across an inner edge: a value of
// this block's own ring that the caller replaces).
template <typename T>
__device__ __forceinline__ Nbrs<T> local_nbrs(const T* ring, const Geom& g, const Pair& c, int a,
                                              int o) {
  const int li = a ? g.odd + c.e : c.e;
  Nbrs<T> v;
  v.ym = ring[o + ((c.edge & 1) ? li : li - g.RXH)];
  v.yp = ring[o + ((c.edge & 2) ? li : li + g.RXH)];
  v.xm = ring[o + (a ? c.e : g.odd + c.e - 1)];
  v.xp = ring[o + (a ? c.e + 1 : g.odd + c.e)];
  return v;
}

// The four in-plane neighbours of column a of pair c in ring slot `slot`,
// from this block's plane or, across an inner edge of the cluster, from
// the neighbouring block's (nb: its rings, y-, y+, x-, x+; nry: the y-
// neighbour's rows).
template <typename T>
__device__ __forceinline__ Nbrs<T> nbrs_at(const T* ring, const T* const* nb, int nry,
                                           const Geom& g, const Pair& c, int a, int slot) {
  const int o = slot * g.plane;
  Nbrs<T> v = local_nbrs(ring, g, c, a, o);
  if (c.edge & 3) (c.edge & 1 ? v.ym : v.yp) = remote_y(nb, nry, g, c, a, o);
  if (c.edge & (a ? 8 : 4)) (a ? v.xp : v.xm) = remote_x(nb, g, c, a, o);
  return v;
}

// The nodes a block writes along one dim: its tile [t0, t0 + kTile) of
// the n fine nodes, and the coarse tile [t0 / 2, t0 / 2 + kTile / 2) of
// the nc coarse ones, except at the end: where the array's last node n - 1
// is one past a tile (n = 513 = 16 * 32 + 1), that tile takes it (a
// boundary node, never updated: copied from sol) and with it the last
// coarse node if that is one past its coarse tile, and the tile that
// would start at n - 1 takes nothing.  So 513 nodes make 16 tiles, not 17.
struct Own {
  int f0, f1, c0, c1;
  bool copy;  // f1 - 1 = n - 1 is past the tile: copied from sol
};

__device__ __host__ inline Own own_range(int t0, int n, int nc) {
  const bool takes = t0 + kTile == n - 1, gives = t0 == n - 1 && t0 > 0;
  Own w;
  w.f0 = gives ? n : t0;
  w.f1 = takes ? n : (t0 + kTile < n ? t0 + kTile : n);
  w.c0 = t0 / 2;
  w.c1 = w.c0 + kTile / 2 < nc ? w.c0 + kTile / 2 : nc;
  if (takes && w.c1 == nc - 1) w.c1 = nc;
  if (gives && w.c0 == nc - 1) w.c0 = nc;
  if (w.f1 < w.f0) w.f1 = w.f0;  // a block past the array: empty ranges
  if (w.c1 < w.c0) w.c1 = w.c0;
  w.copy = takes;
  return w;
}

// Tiles of a launch along one dim: enough for the fine nodes (own_range)
// and, for K7, for the coarse ones.
int tiles_for(int n, int nc, bool down) {
  const int f = n > 1 ? (n - 2) / kTile + 1 : 1;
  int t = f;
  if (down)
    while (own_range((t - 1) * kTile, n, nc).c1 < nc) ++t;
  return t;
}

// K7: coarse plane cz of the block's coarse tile from the boxes of z-sums
// (for each fine (y, x) of a tile plus `reach`, the residual summed over
// cz's z taps), summed as K4 sums: z innermost, then y, then
// x.  A tap across an inner edge of the cluster reads the box of the block
// that owns that fine node (every block's box sits at the same offset).
template <typename T>
__device__ void restrict_yx(T* __restrict__ outc, const T* zbox, int cz, int ny, int nx,
                            int nyc, int nxc, int reach, int ccx, const Geom& g, const Own& oy,
                            const Own& ox, const Taps<T>& t) {
  const int rx = kTile + 2 * reach;
  const int ncx = ox.c1 - ox.c0;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  for (int i = threadIdx.x; i < (oy.c1 - oy.c0) * ncx; i += blockDim.x) {
    const int cy = oy.c0 + i / ncx, cx = ox.c0 + i % ncx;
    T acc_x = T(0);
#pragma unroll
    for (int kx = 0; kx < kMaxTaps; ++kx) {
      const int x = 2 * cx + t.lo[2] + kx;
      if (kx >= t.n[2] || x < 0 || x >= nx) continue;
      const int dx = x < g.tx0 && !g.xlo ? -1 : x >= g.tx0 + kTile && !g.xhi ? 1 : 0;
      T acc_y = T(0);
#pragma unroll
      for (int ky = 0; ky < kMaxTaps; ++ky) {
        const int y = 2 * cy + t.lo[1] + ky;
        if (ky >= t.n[1] || y < 0 || y >= ny) continue;
        const int dy = y < g.ty0 && !g.ylo ? -1 : y >= g.ty0 + kTile && !g.yhi ? 1 : 0;
        const T* src = (dx | dy) ? cl.map_shared_rank(zbox, rank + dx + dy * ccx) : zbox;
        acc_y = acc_y + t.w[1][ky] *
                            src[(y - g.ty0 - dy * kTile + reach) * rx + x - g.tx0 - dx * kTile + reach];
      }
      acc_x = acc_x + t.w[2][kx] * acc_y;
    }
    outc[(static_cast<int64_t>(cz) * nyc + cy) * nxc + cx] = acc_x;
  }
}

// Pairs of window columns a thread takes: one, or two where a window would
// need more than kMaxThreads threads (a cluster of one at K7's K=3).
__device__ __host__ inline int pairs_per_thread(const Geom& g) {
  return g.rows * g.RXH > kMaxThreads ? 2 : 1;
}

// ALONE: compiled for clusters of one (K6's), where no node has a
// neighbour in another block and block barriers suffice.
template <typename T, int K, int MODE, int NP, bool ALONE>
__global__ void __launch_bounds__(NP == 1 ? kMaxThreads : kMaxThreads2)
cluster_leg(T* __restrict__ out, T* __restrict__ outc, const T* __restrict__ sol,
            const T* __restrict__ solc, const T* __restrict__ rhs, int nz, int ny, int nx,
            int nzc, int nyc, int nxc, Star<T> s, T scale, int reach, int chunk, Taps<T> t,
            Excl ex, int ccy, int ccx) {
  constexpr int L = 2 * K;  // half-sweeps
  constexpr bool up = MODE == kProlong, down = MODE == kRestrict, smooth = MODE == kSmooth;
  constexpr int S = L + 2 + down + kAhead;  // ring slots, of sol and of rhs
  extern __shared__ __align__(16) unsigned char smem[];
  const Span sp = span_for(blockIdx.z, chunk, nz, nzc, down, t);
  if (sp.zf0 > sp.zf1) return;  // the whole cluster (one z-chunk): nothing to compute
  cg::cluster_group cl = cg::this_cluster();
  const bool alone = ALONE || ccy * ccx == 1;  // a cluster of one: block barriers suffice
  // (ALONE: the window's shape is known to the compiler)
  const int py = ALONE ? 0 : blockIdx.y % ccy, px = ALONE ? 0 : blockIdx.x % ccx;
  const Geom g = geom_for(MODE, K, reach, ALONE ? 1 : ccy, ALONE ? 1 : ccx, py, px, blockIdx.y,
                          blockIdx.x);
  T* ring = reinterpret_cast<T*>(smem);
  T* rring = ring + S * g.plane;
  T* extra = rring + S * g.plane;  // K8: coarse ring; K7: boxes of z-sums
  // The neighbours' sol rings (y-, y+, x-, x+), where this block has one;
  // the y- neighbour's rows.
  const int rank = static_cast<int>(cl.block_rank());
  const T* nb[4] = {ring, ring, ring, ring};
  if (!ALONE) {
    if (!g.ylo) nb[0] = cl.map_shared_rank(ring, rank - ccx);
    if (!g.yhi) nb[1] = cl.map_shared_rank(ring, rank + ccx);
    if (!g.xlo) nb[2] = cl.map_shared_rank(ring, rank - 1);
    if (!g.xhi) nb[3] = cl.map_shared_rank(ring, rank + 1);
  }
  const int nry = kTile + (py == 1 ? g.hy : 0);
  const Own oy = own_range(g.ty0, ny, nyc), ox = own_range(g.tx0, nx, nxc);
  const int pstart = sp.zf0 - L, pend = sp.zf1 + L + 3 * down;
  const int lz0 = max(pstart, 0), lz1 = min(sp.zf1 + L, nz - 1);  // planes loaded
  const int zlo = sp.zf0 - L;  // half-sweep l runs on planes >= zlo + l
  const int odd = g.odd;
  Pair pr[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    pr[k] = pair_at(threadIdx.x + k * blockDim.x, g, ny, nx, ex);
    if constexpr (ALONE) pr[k].edge = 0;  // known to the compiler: no remote reads
  }

  // K8's coarse boxes, and the y and x taps of the thread's columns.
  const int ce = coarse_edge(g), cbox = ce * ce;
  const int cy0 = floor_half(g.wy0 - t.lo[1] - (kMaxTaps - 1));
  const int cx0 = floor_half(g.wx0 - t.lo[2] - (kMaxTaps - 1));
  int cz_next = max(floor_half(lz0 - t.lo[0] - (t.n[0] - 1)), 0);  // first coarse plane not loaded
  TapPair<T> tpy[NP], tpx0[NP], tpx1[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    tpy[k] = tap_pair(pr[k].gy, nyc, t.w[1], t.n[1], t.lo[1]);
    tpx0[k] = tap_pair(pr[k].gx, nxc, t.w[2], t.n[2], t.lo[2]);
    tpx1[k] = tap_pair(pr[k].gx + 1, nxc, t.w[2], t.n[2], t.lo[2]);
  }
  // K7's boxes of z-sums: the tile plus `reach` (filled on the cluster's
  // outer sides only), origin (ty0 - reach, tx0 - reach); the running
  // z-sums of the thread's columns (za: even column, zb: odd; [0]/[1]:
  // coarse planes of even/odd index), the next coarse plane to complete
  // (czw) and to restrict (czr).
  const int rb = kTile + 2 * reach;
  const int by0 = g.ty0 - (g.ylo ? reach : 0), by1 = g.ty0 + kTile + (g.yhi ? reach : 0);
  const int bx0 = g.tx0 - (g.xlo ? reach : 0), bx1 = g.tx0 + kTile + (g.xhi ? reach : 0);
  bool box0[NP], box1[NP];
  T za[NP][2], zb[NP][2];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const bool row = pr[k].mine && pr[k].gy >= by0 && pr[k].gy < by1;
    box0[k] = row && pr[k].gx >= bx0 && pr[k].gx < bx1;
    box1[k] = row && pr[k].gx + 1 >= bx0 && pr[k].gx + 1 < bx1;
    za[k][0] = za[k][1] = zb[k][0] = zb[k][1] = T(0);
  }
  int czw = sp.cz0, czr = sp.cz0;
  auto last_of = [&](int cz) { return min(max(2 * cz + t.lo[0] + t.n[0] - 1, 0), nz - 1); };

  // Plane pp of sol and rhs into ring slot `slot` (each thread its own
  // pairs; K8: and, by all threads, the coarse planes plane pp + 1
  // prolongs from).  One copy group per plane.  Block-uniform.
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
            const int cy = cy0 + i / ce, cx = cx0 + i % ce;
            const bool in = cy >= 0 && cy < nyc && cx >= 0 && cx < nxc;
            cp_async(dst + i, in ? src + static_cast<int64_t>(cy) * nxc + cx : src, in);
          }
        }
      }
    }
    cp_async_commit();
  };
  auto slot_back = [](int slot, int n) { return slot - n < 0 ? slot - n + S : slot - n; };
  // K8: the z-sums of the coarse box for fine plane q (K5's
  // innermost sums, in its order), by all threads, into slot
  // (q - pstart) % 2 of two.
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

  // K8's ingest: plane q (in ring slot `slot`) += P sol_c on the thread's
  // inner nodes, summed as K5 sums (q's z-sums, then y, then x);
  // then the z-sums of plane q + 1, whose coarse planes came with plane q's
  // copy group.
  auto ingest = [&](int q, int slot) {
    if (q >= lz0 && q <= lz1 && q >= 1 && q <= nz - 2) {
      const T* zs = zsum + ((q - pstart) & 1) * cbox;
      T* bq = ring + slot * g.plane;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int oy = (tpy[k].c0 - cy0) * ce;
        auto sum_y = [&](int o) {
          T acc = T(0);
          if (tpy[k].v0) acc = acc + tpy[k].w0 * zs[oy + o];
          if (tpy[k].v1) acc = acc + tpy[k].w1 * zs[oy - ce + o];
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
        if (pr[k].ok0) bq[e] = bq[e] + sum_x(tpx0[k]);
        if (pr[k].ok1) bq[odd + e] = bq[odd + e] + sum_x(tpx1[k]);
      }
    }
    coarse_z(q + 1);
  };

  // No block may read a neighbour's ring before the neighbour has started.
  if (!ALONE) cluster_arrive();
#pragma unroll
  for (int j = 0; j < kAhead; ++j) issue(pstart + j, j);
  cp_async_wait<kAhead - 1>();
  __syncthreads();
  if constexpr (up) {
    coarse_z(pstart);
    __syncthreads();
    ingest(pstart, 0);
  }
  if (!ALONE) cluster_wait();
  for (int p = pstart, s0 = 0; p <= pend; ++p, s0 = s0 + 1 < S ? s0 + 1 : 0) {
    issue(p + kAhead, s0 + kAhead < S ? s0 + kAhead : s0 + kAhead - S);
    T* bp = ring + s0 * g.plane;

    // K7: the coarse planes whose z-sums the step before last completed
    // (published by the last step's barrier).
    if constexpr (down) {
      for (const int qp = p - L - 3; czr < sp.cz1 && last_of(czr) == qp; ++czr)
        restrict_yx(outc, extra + (czr % kResSlots) * rb * rb, czr, ny, nx, nyc, nxc, reach, ccx,
                    g, oy, ox, t);
    }
    // Half-sweep l on plane p - l, l = 1..2K, on the thread's active column
    // of each pair; the only reads of this step's writes are of the
    // column's own z-neighbours, made by this thread, so no barrier is
    // needed between the half-sweeps.  The z-neighbour above is the value
    // the thread just computed; neighbours across an inner edge were loaded
    // at the step's start.
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const Pair& c = pr[k];
      if (!c.mine) continue;
      const int a = (1 + p + c.gy + c.gx) & 1;
      const bool oka = a ? c.ok1 : c.ok0;
      const int dista = a ? c.dist1 : c.dist0;
      const int li = a ? odd + c.e : c.e;
      // The neighbours across inner edges for all 2K half-sweeps, loaded at
      // once: one round trip to the neighbouring blocks a step.
      const bool ryo = c.edge & 3, rxo = c.edge & (a ? 8 : 4);
      T ryv[L], rxv[L];
#pragma unroll
      for (int l = 1; l <= L; ++l) {
        const int o = slot_back(s0, l) * g.plane;
        ryv[l - 1] = ryo ? remote_y(nb, nry, g, c, a, o) : T(0);
        rxv[l - 1] = rxo ? remote_x(nb, g, c, a, o) : T(0);
      }
      T zp = bp[li];
#pragma unroll
      for (int l = 1; l <= L; ++l) {
        const int q = p - l, o = slot_back(s0, l) * g.plane;
        const T cen = ring[o + li];
        T v = cen;
        if (oka && l <= dista && q >= max(zlo + l, 1) && q <= nz - 2 &&
            (!smooth || (q != ex.p[0] && q != ex.p[1]))) {
          Nbrs<T> n = local_nbrs(ring, g, c, a, o);
          if (ryo) (c.edge & 1 ? n.ym : n.yp) = ryv[l - 1];
          if (rxo) (a ? n.xp : n.xm) = rxv[l - 1];
          T au = s.c[0] * cen;
          au = au + s.c[1] * ring[slot_back(s0, l + 1) * g.plane + li];
          au = au + s.c[2] * zp;
          au = au + s.c[3] * n.ym;
          au = au + s.c[4] * n.yp;
          au = au + s.c[5] * n.xm;
          au = au + s.c[6] * n.xp;
          const T corr = scale * (rring[o + li] - au);
          v = cen + corr;
          ring[o + li] = v;
        }
        zp = v;
      }
    }

    cp_async_wait<kAhead - 1>();  // plane p + 1 has arrived
    step_arrive(alone);

    // K8: plane p + 1's ingest, and the z-sums of plane p + 2, between the
    // arrive and the wait: no block reads plane p + 1 before its next
    // step's barrier, and this thread's columns only this thread before.
    if constexpr (up) ingest(p + 1, s0 + 1 < S ? s0 + 1 : 0);

    // Plane p - 2K is final: the block's nodes to out (this block's ring
    // only, which no block writes before the wait; a last row or column
    // past the tile from sol).
    const int qo = p - L;
    if (qo >= sp.z0 && qo < sp.z1) {
      const T* b = ring + slot_back(s0, L) * g.plane;
      const int64_t zoff = static_cast<int64_t>(qo) * ny * nx;
      T* o = out + zoff;
      const int y1 = min(oy.f1, g.ty0 + kTile), x1 = min(ox.f1, g.tx0 + kTile);
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const Pair& c = pr[k];
        if (!c.mine || c.gy < oy.f0 || c.gy >= y1) continue;
        if (c.in0 && c.gx >= ox.f0 && c.gx < x1) o[c.g0] = b[c.e];
        if (c.in1 && c.gx + 1 >= ox.f0 && c.gx + 1 < x1) o[c.g1] = b[odd + c.e];
      }
      if (ox.copy)
        for (int y = oy.f0 + threadIdx.x; y < oy.f1; y += blockDim.x)
          o[static_cast<int64_t>(y) * nx + nx - 1] = sol[zoff + static_cast<int64_t>(y) * nx + nx - 1];
      if (oy.copy)
        for (int x = ox.f0 + threadIdx.x; x < x1; x += blockDim.x)
          o[static_cast<int64_t>(ny - 1) * nx + x] = sol[zoff + static_cast<int64_t>(ny - 1) * nx + x];
    }

    // K7: the residual of plane qr = p - 2K - 1 on the thread's columns of
    // the box, added to the z-sums of the coarse planes it is a tap of; a
    // coarse plane whose last tap this is goes to its box, which the next
    // step's barrier publishes and the step after restricts.  No block
    // writes plane qr (nor this thread's column of qr - 1) before this
    // block's next step, so this sits between the arrive and the wait.
    const int qr = p - L - 1;
    if (down && qr >= sp.rz0 && qr <= sp.rz1) {
      const bool plane_ok = qr >= 1 && qr <= nz - 2;
      const int sb = slot_back(s0, L + 1);
      const T* zm = ring + slot_back(s0, L + 2) * g.plane;
      const T* zq = ring + slot_back(s0, L) * g.plane;
      const T* b = ring + sb * g.plane;
      const T* rq = rring + sb * g.plane;
      auto residual = [&](bool ok, const Pair& c, int a) {
        if (!ok) return T(0);
        const int li = a ? odd + c.e : c.e;
        const Nbrs<T> n = nbrs_at(ring, nb, nry, g, c, a, sb);
        T au = s.c[0] * b[li];
        au = au + s.c[1] * zm[li];
        au = au + s.c[2] * zq[li];
        au = au + s.c[3] * n.ym;
        au = au + s.c[4] * n.yp;
        au = au + s.c[5] * n.xm;
        au = au + s.c[6] * n.xp;
        return rq[li] - au;
      };
      const int k0 = (qr - t.lo[0]) & 1, c0 = (qr - t.lo[0] - k0) >> 1;
      const bool tap0 = k0 < t.n[0] && c0 >= sp.cz0 && c0 < sp.cz1;
      const bool tap2 = k0 == 0 && t.n[0] > 2 && c0 - 1 >= sp.cz0 && c0 - 1 < sp.cz1;
      const T w0 = k0 ? t.w[0][1] : t.w[0][0];
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const Pair& c = pr[k];
        const T v0 = residual(plane_ok && c.ok0 && box0[k], c, 0);
        const T v1 = residual(plane_ok && c.ok1 && box1[k], c, 1);
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
          T* dst = extra + (czw % kResSlots) * rb * rb + (pr[k].gy - g.ty0 + reach) * rb +
                   pr[k].gx - g.tx0 + reach;
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
    if (!alone) cluster_wait();
  }
  // No block may exit while another can still read its shared memory.
  if (!alone) {
    cluster_arrive();
    cluster_wait();
  }
}

// The launch's layout (every block's strides are its cluster corner's).
Geom launch_geom(int mode, int K, int reach, int ccy, int ccx) {
  return geom_for(mode, K, reach, ccy, ccx, 0, 0, 0, 0);
}

// Dynamic shared memory of one block: the rings of sol and rhs, then K8's
// coarse ring and two boxes of z-sums, or K7's boxes of z-sums (K6: none).
size_t cluster_smem(int mode, int K, int reach, int ccy, int ccx, size_t itemsize) {
  const Geom g = launch_geom(mode, K, reach, ccy, ccx);
  const size_t slots = 2 * (2 * K + 2 + (mode == kRestrict) + kAhead);
  const size_t extra = mode == kProlong    ? (kCoarseSlots + 2) * coarse_edge(g) * coarse_edge(g)
                       : mode == kRestrict ? kResSlots * (kTile + 2 * reach) * (kTile + 2 * reach)
                                           : 0;
  return (slots * g.plane + extra) * itemsize;
}

// Threads of one block: its pairs of window columns, pairs_per_thread to a
// thread, in whole warps.
int cluster_threads(int mode, int K, int reach, int ccy, int ccx) {
  const Geom g = launch_geom(mode, K, reach, ccy, ccx);
  const int np = pairs_per_thread(g);
  return ((g.rows * g.RXH + np - 1) / np + 31) / 32 * 32;
}

int tiles(int n, int tile) { return (n + tile - 1) / tile; }
int round_up(int n, int m) { return (n + m - 1) / m * m; }

template <typename T>
using LegFn = void (*)(T*, T*, const T*, const T*, const T*, int, int, int, int, int, int, Star<T>,
                       T, int, int, Taps<T>, Excl, int, int);

template <typename T, int MODE, int NP, bool ALONE = false>
LegFn<T> kernel_for(int K) {
  return K == 1 ? cluster_leg<T, 1, MODE, NP, ALONE>
       : K == 2 ? cluster_leg<T, 2, MODE, NP, ALONE> : cluster_leg<T, 3, MODE, NP, ALONE>;
}

// Two pairs a thread only for K7 (K8's widest window, a cluster of one's at
// K=3, is 968 pairs; K6's the same).  K6 on a cluster of one: ALONE.
template <typename T>
LegFn<T> kernel_for(int mode, int K, int np, bool alone) {
  if (mode == kSmooth)
    return alone ? kernel_for<T, kSmooth, 1, true>(K) : kernel_for<T, kSmooth, 1>(K);
  return mode == kProlong ? kernel_for<T, kProlong, 1>(K)
       : np == 1 ? kernel_for<T, kRestrict, 1>(K) : kernel_for<T, kRestrict, 2>(K);
}

bool valid_launch(int mode, int K, int ccy, int ccx) {
  return mode >= kSmooth && mode <= kRestrict && K >= 1 && K <= kMaxK && ccy >= 1 &&
         ccx >= 1 && ccx <= kMaxClusterX && ccy * ccx <= 8;
}

// The kernel of a launch shape with its shared memory allowed, or nullptr.
template <typename T>
LegFn<T> prepared(int mode, int K, int reach, int ccy, int ccx, size_t* smem, int* threads,
                  cudaError_t* err) {
  *err = cudaErrorInvalidValue;
  if (!valid_launch(mode, K, ccy, ccx)) return nullptr;
  *smem = cluster_smem(mode, K, reach, ccy, ccx, sizeof(T));
  *threads = cluster_threads(mode, K, reach, ccy, ccx);
  const int np = pairs_per_thread(launch_geom(mode, K, reach, ccy, ccx));
  if (*threads > (np == 1 ? kMaxThreads : kMaxThreads2)) return nullptr;
  LegFn<T> kernel = kernel_for<T>(mode, K, np, ccy * ccx == 1);
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
  return *err == cudaSuccess ? kernel : nullptr;
}

cudaLaunchConfig_t launch_config(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr, int ccy, int ccx) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ccx;
  attr->val.clusterDim.y = ccy;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Blocks one SM holds (what = 0) or clusters the card holds at once
// (what = 1, cudaOccupancyMaxActiveClusters), or -1.
template <typename T>
int occupancy(int mode, int K, int reach, int ccy, int ccx, int what) {
  size_t smem;
  int threads, n = -1;
  cudaError_t err;
  LegFn<T> kernel = prepared<T>(mode, K, reach, ccy, ccx, &smem, &threads, &err);
  if (!kernel) return -1;
  if (what == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  } else {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        launch_config(dim3(ccx, ccy, 1), threads, smem, nullptr, &attr, ccy, ccx);
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  }
  return err == cudaSuccess ? n : -1;
}

// The grid: tiles in x and y rounded up to whole clusters, z-chunks (K7:
// enough of each for the coarse array too).
dim3 grid_for(int nz, int ny, int nx, int nzc, int nyc, int nxc, int mode, int chunk, int ccy,
              int ccx) {
  const bool down = mode == kRestrict;
  dim3 grid(round_up(tiles_for(nx, nxc, down), ccx), round_up(tiles_for(ny, nyc, down), ccy),
            tiles(nz, chunk));
  if (down) grid.z = std::max<int>(grid.z, tiles(nzc, chunk / 2));
  return grid;
}

template <typename T>
cudaError_t launch(void* out, void* outc, const void* sol, const void* solc, const void* rhs,
                   int nz, int ny, int nx, int nzc, int nyc, int nxc, const double* coefs,
                   double scale, int K, int reach, int mode, int chunk, const double* taps,
                   const int* ntaps, const int* lo, const int* excl, int ccy, int ccx,
                   cudaStream_t stream) {
  if (chunk < 2 || chunk % 2) return cudaErrorInvalidValue;
  const Excl ex = make_excl(excl);
  if (mode != kSmooth)  // K7/K8 take no excl planes
    for (int d = 0; d < 6; ++d)
      if (ex.p[d] != -1) return cudaErrorInvalidValue;
  size_t smem;
  int threads;
  cudaError_t err;
  LegFn<T> kernel = prepared<T>(mode, K, reach, ccy, ccx, &smem, &threads, &err);
  if (!kernel) return err;
  const dim3 grid = grid_for(nz, ny, nx, nzc, nyc, nxc, mode, chunk, ccy, ccx);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(grid, threads, smem, stream, &attr, ccy, ccx);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<T*>(out), static_cast<T*>(outc),
                           static_cast<const T*>(sol), static_cast<const T*>(solc),
                           static_cast<const T*>(rhs), nz, ny, nx, nzc, nyc, nxc,
                           make_star<T>(coefs), static_cast<T>(scale), reach, chunk,
                           make_taps<T>(taps, ntaps, lo), ex, ccy, ccx);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes, as legs3d.cu's.  `out` (and K7's `outc`)
// are new arrays, never aliases of the inputs; `solc` is read by kProlong
// only, `outc` written by kRestrict only (pass any pointer otherwise).  The
// taps are the prolongation's for kProlong, the restriction's for
// kRestrict (unused by kSmooth); `excl` the six excl planes (kSmooth only:
// all -1 otherwise); `chunk` (even) is the fine z-planes of one block;
// (ccy, ccx) the cluster's blocks in y and x.  Returns the CUDA error of
// the launch (a cluster shape the card refuses is an error here, never a
// silent no-op).
extern "C" {

// The layout constants the wrapper mirrors (ops/cuda/stream3d.py), in order:
// kTile, kAhead, kMaxK, kMaxClusterX, kMaxThreads.
int exa_cluster_constant(int i) {
  const int c[] = {kTile, kAhead, kMaxK, kMaxClusterX, kMaxThreads};
  return i >= 0 && i < 5 ? c[i] : -1;
}

long long exa_cluster_smem(int mode, int K, int reach, int ccy, int ccx, int itemsize) {
  return static_cast<long long>(cluster_smem(mode, K, reach, ccy, ccx, itemsize));
}

int exa_cluster_threads(int mode, int K, int reach, int ccy, int ccx) {
  return cluster_threads(mode, K, reach, ccy, ccx);
}

void exa_cluster_grid(int nz, int ny, int nx, int nzc, int nyc, int nxc, int mode, int chunk,
                      int ccy, int ccx, int* grid) {
  const dim3 g = grid_for(nz, ny, nx, nzc, nyc, nxc, mode, chunk, ccy, ccx);
  grid[0] = g.x;
  grid[1] = g.y;
  grid[2] = g.z;
}

int exa_cluster_occupancy(int mode, int K, int reach, int ccy, int ccx, int is_double, int what) {
  return is_double ? occupancy<double>(mode, K, reach, ccy, ccx, what)
                   : occupancy<float>(mode, K, reach, ccy, ccx, what);
}

int exa_cluster_leg(void* out, void* outc, const void* sol, const void* solc, const void* rhs,
                    int nz, int ny, int nx, int nzc, int nyc, int nxc, const double* coefs,
                    double scale, int K, int reach, int mode, int chunk, const double* taps,
                    const int* ntaps, const int* lo, const int* excl, int ccy, int ccx,
                    int is_double, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_double ? launch<double>(out, outc, sol, solc, rhs, nz, ny, nx, nzc, nyc, nxc, coefs,
                                 scale, K, reach, mode, chunk, taps, ntaps, lo, excl, ccy, ccx, st)
                : launch<float>(out, outc, sol, solc, rhs, nz, ny, nx, nzc, nyc, nxc, coefs,
                                scale, K, reach, mode, chunk, taps, ntaps, lo, excl, ccy, ccx, st));
}

}  // extern "C"
