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
// lo).  Fields are float32, float64 or bfloat16; a bfloat16 leg keeps
// star3d.cuh's rounding contract (float32 rings, each stored value rounded
// once), so its sweeps are the plain version's bitwise and K1/K2 stay
// bitwise K3 + K4 and K5 + K3; its loads into the rings are synchronous.
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
// - Halo-extended fragments (the sharded backend, ops/cuda
//   make_sharded_fused_legs_3d; JAX: exastencils_tpu/ops/pallas/__init__.py:
//   218-228).  The fragment is smoothed whole, excl planes marking the
//   physical boundary; K2 prolongs with its taps' lo shifted by the ghost
//   width g in every dim (the whole fragment corrected, ghosts included,
//   as prolongation_matrix_full_ghosted does); K1 restricts through the
//   Coarse geometry below: aligned coarse indices keep a block's coarse
//   tile under its fine tile and the restriction's reach that of the
//   unshifted operator, and a write window keeps the coarse rows the JAX
//   kernel leaves zero (y/x ghost rows) zero.
// - K3 is one kSmooth launch per call (chained beyond kMaxLegK).  It
//   replaces 2K launches of a half-sweep kernel, each a pass over sol and
//   rhs (4.77 ms at 513^3 f32, K=3, on an H100).
//
// K11/K12, the variable-coefficient legs (wrappers
// ops/cuda/stream3d.smooth_res_restrict_faces, prolong_correct_smooth_faces;
// they replace no TPU kernel: the JAX package has no variable-coefficient
// model).  K1's and K2's maths, and the kSmooth chain beyond one launch, for
// -div(kappa grad u) as models/poisson.varcoeff_laplace_stencil stores it:
// a face array per axis, face_d n_d + 1 long along d, node i's minus
// coefficient face_d[i] and its plus coefficient face_d[i + 1].  The same
// kernel, leg_kernel, with the face arrays as one more parameter (its pack
// F, empty for K1-K3, whose parameters and code are as they were); float
// and double, dense only.
// - Bound: device-memory bytes, the legs' plus the three face arrays read
//   once, 112.0 B a fine node over a float64 V(3,3) cycle (portbench
//   varcoeff.py).  No centre array is read: the diagonal is the negative
//   sum of the six face values the update holds, in the stencil's order,
//   so bitwise the stored centre (ops/cuda/stream3d.face_arrays holds the
//   level to that at set-up).  The smoother's omega / diag is PyTorch's
//   reciprocal(diag) * omega, as make_smoother's plain update computes it.
// - Shared memory holds no coefficient: in float64 the rings of sol and
//   rhs already take 216-223 KB of a block's 227 (K1 at K=1, K2 at K=2),
//   so a ring per face array does not fit.  Each update reads its node's
//   six face values from device memory (L2: a block's face planes are read
//   again by the halo of its neighbours and by the K updates of each
//   node); the loads of a step's 2K half-sweeps do not wait on the sweeps,
//   so they are issued together, a node not updated reading a safe one.
//   The launch bounds are the launch's own threads, not the constant
//   kernels' 768/1024, so more registers hold the loads in flight.
// - Launches hold as many iterations as for K1/K2 (leg_chain): at 513^3
//   float64, K=3, chains of one iteration a launch took K11 from 13.52 to
//   14.36 ms and K12 from 9.94 to 10.88 on an H100 (PERF.md §6), each
//   launch streaming sol and rhs once more.

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

// K1's coarse geometry per dim (z, y, x).  Coarse node c' of the output
// array takes the fine nodes 2 c' + lo' + k of the window's taps; on a
// halo-extended fragment (the sharded path) lo' = lo - g, with g the
// fine ghost width.  The kernel works in aligned indices c = c' - off,
// off = ceil(g / 2), whose taps are 2 c + t.lo + k with t.lo = lo + g % 2
// (the wrapper passes it), so a block's coarse tile stays under its fine
// tile and the node restriction's reach stays 1.  It
// computes the aligned nodes [0, n) and writes those whose array index
// lies in [lo, hi]; the wrapper zero-fills the rest.  Dense: off 0,
// n = the coarse shape, [lo, hi] all of it; the dense K1 is compiled
// apart (leg_kernel's GHOSTED false) and reads none of it, so the dense
// main path keeps its launch as it was without this geometry.
struct Coarse {
  int off[3], n[3], lo[3], hi[3];
};

inline bool is_dense(const Coarse& cg, int nzc, int nyc, int nxc) {
  const int n[3] = {nzc, nyc, nxc};
  for (int d = 0; d < 3; ++d)
    if (cg.off[d] != 0 || cg.n[d] != n[d] || cg.lo[d] != 0 || cg.hi[d] != n[d] - 1) return false;
  return true;
}

inline Coarse make_coarse(const int* c) {
  Coarse g;
  for (int d = 0; d < 3; ++d) {
    g.off[d] = c[d];
    g.n[d] = c[3 + d];
    g.lo[d] = c[6 + d];
    g.hi[d] = c[9 + d];
  }
  return g;
}

// K1's window, wider by its halo, has more pairs of columns than a block
// has threads: each of its threads takes two.
__device__ __host__ constexpr int leg_pairs_per_thread(int mode) { return mode == kRestrict ? 2 : 1; }

// The window's halo around one block's tile: 2K nodes per side, K1 2K+1
// plus the restriction's reach.
__device__ __host__ constexpr int leg_halo(int mode, int K, int reach) {
  return mode == kRestrict ? 2 * K + 1 + reach : 2 * K;
}

// Threads of one block: its pairs of window columns, leg_pairs_per_thread
// to a thread, in whole warps.
__device__ __host__ constexpr int leg_threads_of(int mode, int K, int reach) {
  const int r = kLegTile + 2 * leg_halo(mode, K, reach);
  const int np = leg_pairs_per_thread(mode);
  return ((r * (r / 2) + np - 1) / np + 31) / 32 * 32;
}

// K11/K12's coefficients: a level's three face arrays (see the note above).
template <typename T>
struct Faces {
  const T* z;  // (nz + 1, ny, nx)
  const T* y;  // (nz, ny + 1, nx)
  const T* x;  // (nz, ny, nx + 1)
};

// The star of node (q, y, x), g = y * nx + x its offset within a plane of
// sol, from the face arrays: the off-centre entries in Star's order, the
// centre their negative sum in varcoeff_laplace_stencil's order.  A node
// that is not `used` reads node (0, 0, 0)'s values, which lie in bounds.
template <typename T>
__device__ __forceinline__ Star<T> face_star(bool used, int q, int y, int64_t g, int ny, int nx,
                                             const Faces<T>& f) {
  if (!used) {
    q = y = 0;
    g = 0;
  }
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t oz = q * plane + g;                           // face_z planes: ny * nx
  const int64_t oy = q * (plane + nx) + g;                    // face_y planes: (ny + 1) * nx
  const int64_t ox = q * (plane + ny) + g + y;                // face_x rows: nx + 1
  Star<T> s;
  s.c[1] = __ldg(f.z + oz);
  s.c[2] = __ldg(f.z + oz + plane);
  s.c[3] = __ldg(f.y + oy);
  s.c[4] = __ldg(f.y + oy + nx);
  s.c[5] = __ldg(f.x + ox);
  s.c[6] = __ldg(f.x + ox + 1);
  s.c[0] = -(((((s.c[1] + s.c[2]) + s.c[3]) + s.c[4]) + s.c[5]) + s.c[6]);
  return s;
}

// A u at a node from its star, summed in Star's order (the plain path's).
template <typename C>
__device__ __forceinline__ C star_apply(const Star<C>& k, C cen, C zm, C zp, C ym, C yp, C xm,
                                        C xp) {
  C au = k.c[0] * cen;
  au = au + k.c[1] * zm;
  au = au + k.c[2] * zp;
  au = au + k.c[3] * ym;
  au = au + k.c[4] * yp;
  au = au + k.c[5] * xm;
  au = au + k.c[6] * xp;
  return au;
}

// Threads a block of leg_kernel may have: K1-K3's fixed bounds, or (vc)
// K11/K12's own at the node restriction's reach of 1.
__device__ __host__ constexpr int leg_bound(int mode, int K, bool vc) {
  return vc ? leg_threads_of(mode, K, 1) : mode == kRestrict ? kMaxDownThreads : kMaxUpThreads;
}

// The block's window: the tile plus `halo` nodes per side, global origin
// (wy0, wx0).  A plane is stored colour-split, (x parity, row, x / 2): the
// pair (row ly, columns 2 jx and 2 jx + 1) is thread ly * RH + jx's, at
// offsets e and e + odd.
struct Geom {
  int halo, R, RH, odd, plane, wy0, wx0, ty0, tx0;
};

__device__ __host__ inline Geom geom_for(int mode, int K, int reach, int by, int bx) {
  Geom g;
  g.halo = leg_halo(mode, K, reach);
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
// innermost ones, then y, then x.  GHOSTED: in K1's aligned indices,
// written at array index + off inside the write window (Coarse).
template <bool GHOSTED, typename T>
__device__ void restrict_yx(T* __restrict__ outc, const compute_t<T>* zbox, int cz, int ny, int nx,
                            int nyc, int nxc, int reach, const Geom& g,
                            const Taps<compute_t<T>>& t, const Coarse& cg) {
  using C = compute_t<T>;
  const int rx = kLegTile + 2 * reach;
  constexpr int ct = kLegTile / 2;  // coarse tile edge
  const int by = g.ty0 - reach, bx = g.tx0 - reach;  // box origin
  const int cy0 = g.ty0 / 2, cx0 = g.tx0 / 2;
  int oz = cz;
  if constexpr (GHOSTED) {
    oz += cg.off[0];
    if (oz < cg.lo[0] || oz > cg.hi[0]) return;  // block-uniform
  }
  for (int i = threadIdx.x; i < ct * ct; i += blockDim.x) {
    const int cy = cy0 + i / ct, cx = cx0 + i % ct;
    int oy = cy, ox = cx;
    if constexpr (GHOSTED) {
      if (cy >= cg.n[1] || cx >= cg.n[2]) continue;
      oy += cg.off[1];
      ox += cg.off[2];
      if (oy < cg.lo[1] || oy > cg.hi[1] || ox < cg.lo[2] || ox > cg.hi[2]) continue;
    } else {
      if (cy >= nyc || cx >= nxc) continue;
    }
    C acc_x = C(0);
#pragma unroll
    for (int kx = 0; kx < kMaxTaps; ++kx) {
      const int x = 2 * cx + t.lo[2] + kx;
      if (kx >= t.n[2] || x < 0 || x >= nx) continue;
      C acc_y = C(0);
#pragma unroll
      for (int ky = 0; ky < kMaxTaps; ++ky) {
        const int y = 2 * cy + t.lo[1] + ky;
        if (ky >= t.n[1] || y < 0 || y >= ny) continue;
        acc_y = acc_y + t.w[1][ky] * zbox[(y - by) * rx + x - bx];
      }
      acc_x = acc_x + t.w[2][kx] * acc_y;
    }
    outc[(static_cast<int64_t>(oz) * nyc + oy) * nxc + ox] = narrow<T>(acc_x);
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
  // nzc: K1's aligned coarse planes (Coarse::n[0])
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

// One block of a leg.  K11/K12 (F = Faces<T>): each node's star from the
// face arrays `f`, `scale` omega, `s`, `ex` and `cg` unread (dense, no excl
// planes); K1-K3 (F empty): the launch's star `s`, `scale` omega over its
// centre.
template <typename T, int K, int MODE, bool GHOSTED, typename... F>
__global__ void __launch_bounds__(leg_bound(MODE, K, sizeof...(F) > 0))
leg_kernel(T* __restrict__ out, T* __restrict__ outc, const T* __restrict__ sol,
           const T* __restrict__ solc, const T* __restrict__ rhs, int nz, int ny, int nx,
           int nzc, int nyc, int nxc, Star<compute_t<T>> s, compute_t<T> scale, int reach,
           int chunk, Taps<compute_t<T>> t, Excl ex, Coarse cg, F... f) {
  constexpr bool VC = sizeof...(F) > 0;
  using C = compute_t<T>;  // the rings' type (star3d.cuh: the bfloat16 contract)
  constexpr int L = 2 * K;  // half-sweeps
  constexpr bool up = MODE == kProlong, down = MODE == kRestrict;
  constexpr int S = L + 2 + down + kLegAhead;  // ring slots, of sol and of rhs
  constexpr int NP = leg_pairs_per_thread(MODE);
  extern __shared__ __align__(16) unsigned char smem[];
  const Span sp = span_for(blockIdx.z, chunk, nz, GHOSTED ? cg.n[0] : nzc, down, t);
  if (sp.zf0 > sp.zf1) return;  // block-uniform: nothing to compute
  const Geom g = geom_for(MODE, K, reach, blockIdx.y, blockIdx.x);
  C* ring = reinterpret_cast<C*>(smem);
  C* rring = ring + S * g.plane;
  C* extra = rring + S * g.plane;  // K2: coarse ring; K1: boxes of z-sums
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
  TapPair<C> py[NP], px0[NP], px1[NP];
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
  C za[NP][2], zb[NP][2];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int iy = pr[k].ly - boff, ix = 2 * pr[k].jx - boff;
    const bool row = pr[k].mine && iy >= 0 && iy < rry;
    box0[k] = row && ix >= 0 && ix < rrx;
    box1[k] = row && ix + 1 >= 0 && ix + 1 < rrx;
    za[k][0] = za[k][1] = zb[k][0] = zb[k][1] = C(0);
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
      C* ds = ring + slot * g.plane;
      C* dr = rring + slot * g.plane;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const Pair& c = pr[k];
        if (!c.mine) continue;
        load_shared(ds + c.e, sol + zoff + c.g0, c.in0);
        load_shared(ds + odd + c.e, sol + zoff + c.g1, c.in1);
        load_shared(dr + c.e, rhs + zoff + c.g0, c.in0);
        load_shared(dr + odd + c.e, rhs + zoff + c.g1, c.in1);
      }
      if constexpr (up) {
        for (const int hi = min(floor_half(pp + 1 - t.lo[0]), nzc - 1); cz_next <= hi; ++cz_next) {
          const T* src = solc + static_cast<int64_t>(cz_next) * nyc * nxc;
          C* dst = extra + (cz_next % kCoarseSlots) * cbox;
          for (int i = threadIdx.x; i < cbox; i += blockDim.x) {
            const int cy = cy0 + i / crx, cx = cx0 + i % crx;
            const bool in = cy >= 0 && cy < nyc && cx >= 0 && cx < nxc;
            load_shared(dst + i, in ? src + static_cast<int64_t>(cy) * nxc + cx : src, in);
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
  C* zsum = extra + kCoarseSlots * cbox;
  auto coarse_z = [&](int q) {
    const TapPair<C> pz = tap_pair(q, nzc, t.w[0], t.n[0], t.lo[0]);
    const C* cza = extra + (pz.c0 & (kCoarseSlots - 1)) * cbox;  // read only where valid
    const C* czb = extra + ((pz.c0 - 1) & (kCoarseSlots - 1)) * cbox;
    C* dst = zsum + ((q - pstart) & 1) * cbox;
    for (int i = threadIdx.x; i < cbox; i += blockDim.x) {
      C acc = C(0);
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
    C* bp = ring + s0 * g.plane;

    // K2's ingest: plane p += P sol_c on the thread's inner, non-excl
    // nodes, summed as K5 sums (z innermost, from the z-sums of
    // the last step; then y, then x, taps in increasing order).  Only this
    // thread reads its columns of plane p before the step's end.
    if (up && p >= lz0 && p <= lz1 && p >= 1 && p <= nz - 2 && p != ex.p[0] && p != ex.p[1]) {
      const C* zs = zsum + ((p - pstart) & 1) * cbox;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int oy = (py[k].c0 - cy0) * crx;
        auto sum_y = [&](int o) {
          C acc = C(0);
          if (py[k].v0) acc = acc + py[k].w0 * zs[oy + o];
          if (py[k].v1) acc = acc + py[k].w1 * zs[oy - crx + o];
          return acc;
        };
        auto sum_x = [&](const TapPair<C>& px) {
          const int o = px.c0 - cx0;
          C acc = C(0);
          if (px.v0) acc = acc + px.w0 * sum_y(o);
          if (px.v1) acc = acc + px.w1 * sum_y(o - 1);
          return acc;
        };
        const int e = pr[k].e;
        if (pr[k].ok0) bp[e] = round_stored<T>(bp[e] + sum_x(px0[k]));
        if (pr[k].ok1) bp[odd + e] = round_stored<T>(bp[odd + e] + sum_x(px1[k]));
      }
    }
    // The next plane's z-sums, into the slot no thread reads this step
    // (its coarse planes came with plane p's copy group).
    if constexpr (up) coarse_z(p + 1);

    // K1: the coarse planes whose z-sums the last step completed (each
    // coarse plane by exactly one block: its chunk's).
    if constexpr (down) {
      for (const int qp = p - L - 2; czr < sp.cz1 && last_of(czr) == qp; ++czr)
        restrict_yx<GHOSTED>(outc, extra + (czr % kResSlots) * rry * rrx, czr, ny, nx, nyc, nxc,
                             reach, g, t, cg);
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
      int64_t ga = 0;  // VC: the active column's offset within a plane
      if constexpr (VC) ga = a ? c.g1 : c.g0;
      int sq = s0;  // slot of plane q + 1
      C zp = bp[li];
#pragma unroll
      for (int l = 1; l <= L; ++l) {
        const int q = p - l;
        const int sl = slot_back(sq, 1), sm = slot_back(sq, 2);
        C* b = ring + sl * g.plane;
        const C cen = b[li];
        C v = cen;
        const bool upd = oka && l <= dista && q >= max(zlo + l, 1) && q <= nz - 2 &&
                         q != ex.p[0] && q != ex.p[1];
        Star<C> node;  // VC: loaded where not updated too, so the step's loads issue together
        if constexpr (VC) node = face_star(upd, q, c.gy, ga, ny, nx, f...);
        if (upd) {
          C au, sc = scale;
          if constexpr (VC) {
            au = star_apply(node, cen, ring[sm * g.plane + li], zp, b[li - g.RH], b[li + g.RH],
                            b[xm], b[xp]);
            sc = (C(1) / node.c[0]) * scale;  // PyTorch's omega / diag
          } else {
            au = s.c[0] * cen;
            au = au + s.c[1] * ring[sm * g.plane + li];
            au = au + s.c[2] * zp;
            au = au + s.c[3] * b[li - g.RH];
            au = au + s.c[4] * b[li + g.RH];
            au = au + s.c[5] * b[xm];
            au = au + s.c[6] * b[xp];
          }
          const C corr = sc * (rring[sl * g.plane + li] - au);
          v = round_stored<T>(cen + corr);
          b[li] = v;
        }
        zp = v;
        sq = sl;
      }
    }

    // Plane p - 2K is final: the tile's nodes to out.
    const int qo = p - L;
    if (qo >= sp.z0 && qo < sp.z1) {
      const C* b = ring + slot_back(s0, L) * g.plane;
      T* o = out + static_cast<int64_t>(qo) * ny * nx;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const Pair& c = pr[k];
        if (!c.mine || c.ly < g.halo || c.ly >= g.halo + kLegTile) continue;
        const int lx = 2 * c.jx;
        if (c.in0 && lx >= g.halo && lx < g.halo + kLegTile) o[c.g0] = narrow<T>(b[c.e]);
        if (c.in1 && lx + 1 >= g.halo && lx + 1 < g.halo + kLegTile)
          o[c.g1] = narrow<T>(b[odd + c.e]);
      }
    }

    // K1: the residual of plane qr = p - 2K - 1 (its z+1 plane final this
    // step) on the thread's columns, added to the z-sums of the coarse
    // planes it is a tap of, in tap order; a coarse plane whose last tap
    // this is goes to its box.
    const int qr = p - L - 1;
    if (down && qr >= sp.rz0 && qr <= sp.rz1) {
      const bool plane_ok = qr >= 1 && qr <= nz - 2 && qr != ex.p[0] && qr != ex.p[1];
      const C* zm = ring + slot_back(s0, L + 2) * g.plane;
      const C* b = ring + slot_back(s0, L + 1) * g.plane;
      const C* zq = ring + slot_back(s0, L) * g.plane;
      const C* rq = rring + slot_back(s0, L + 1) * g.plane;
      auto residual = [&](bool ok, int li, int xm, int xp, int gy, int64_t gn) {
        Star<C> node;
        if constexpr (VC) node = face_star(ok, qr, gy, gn, ny, nx, f...);
        if (!ok) return C(0);
        C au;
        if constexpr (VC) {
          au = star_apply(node, b[li], zm[li], zq[li], b[li - g.RH], b[li + g.RH], b[xm], b[xp]);
        } else {
          au = s.c[0] * b[li];
          au = au + s.c[1] * zm[li];
          au = au + s.c[2] * zq[li];
          au = au + s.c[3] * b[li - g.RH];
          au = au + s.c[4] * b[li + g.RH];
          au = au + s.c[5] * b[xm];
          au = au + s.c[6] * b[xp];
        }
        return round_stored<T>(rq[li] - au);
      };
      const int k0 = (qr - t.lo[0]) & 1, c0 = (qr - t.lo[0] - k0) >> 1;
      const bool tap0 = k0 < t.n[0] && c0 >= sp.cz0 && c0 < sp.cz1;
      const bool tap2 = k0 == 0 && t.n[0] > 2 && c0 - 1 >= sp.cz0 && c0 - 1 < sp.cz1;
      const C w0 = k0 ? t.w[0][1] : t.w[0][0];
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const Pair& c = pr[k];
        const C v0 = residual(plane_ok && c.ok0 && box0[k], c.e, odd + c.e - 1, odd + c.e, c.gy,
                              c.g0);
        const C v1 = residual(plane_ok && c.ok1 && box1[k], odd + c.e, c.e, c.e + 1, c.gy, c.g1);
        auto add = [&](int cz, C w) {
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
          C* dst = extra + (czw % kResSlots) * rry * rrx + (pr[k].ly - boff) * rrx +
                   2 * pr[k].jx - boff;
          if (czw & 1) {
            if (box0[k]) dst[0] = za[k][1];
            if (box1[k]) dst[1] = zb[k][1];
            za[k][1] = zb[k][1] = C(0);
          } else {
            if (box0[k]) dst[0] = za[k][0];
            if (box1[k]) dst[1] = zb[k][0];
            za[k][0] = zb[k][0] = C(0);
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

int leg_threads(int mode, int K, int reach) { return leg_threads_of(mode, K, reach); }


int tiles(int n, int tile) { return (n + tile - 1) / tile; }

template <typename T, int MODE, bool GHOSTED = false>
auto leg_kernel_for(int K) {
  return K == 1   ? leg_kernel<T, 1, MODE, GHOSTED>
         : K == 2 ? leg_kernel<T, 2, MODE, GHOSTED>
                  : leg_kernel<T, 3, MODE, GHOSTED>;
}

// The kernel of one launch; `ghosted`: K1 on a halo-extended fragment.
template <typename T>
auto leg_kernel_for(int K, int mode, bool ghosted = false) {
  return mode == kProlong ? leg_kernel_for<T, kProlong>(K)
       : mode == kRestrict ? (ghosted ? leg_kernel_for<T, kRestrict, true>(K)
                                      : leg_kernel_for<T, kRestrict>(K))
                           : leg_kernel_for<T, kSmooth>(K);
}

template <typename T, int MODE>
auto leg_kernel_faces_for(int K) {
  return K == 1   ? leg_kernel<T, 1, MODE, false, Faces<T>>
         : K == 2 ? leg_kernel<T, 2, MODE, false, Faces<T>>
                  : leg_kernel<T, 3, MODE, false, Faces<T>>;
}

// K11/K12's kernel of one launch.
template <typename T>
auto leg_kernel_faces_for(int K, int mode) {
  return mode == kProlong ? leg_kernel_faces_for<T, kProlong>(K)
       : mode == kRestrict ? leg_kernel_faces_for<T, kRestrict>(K)
                           : leg_kernel_faces_for<T, kSmooth>(K);
}

// The grid of one launch: the fine tiles of each z-chunk, or K1's coarse
// tiles where they are more (nc: K1's aligned coarse shape).
dim3 leg_grid(int mode, int nz, int ny, int nx, const int* nc, int chunk) {
  dim3 grid(tiles(nx, kLegTile), tiles(ny, kLegTile), tiles(nz, chunk));
  if (mode == kRestrict) {
    grid.x = std::max<int>(grid.x, tiles(nc[2], kLegTile / 2));
    grid.y = std::max<int>(grid.y, tiles(nc[1], kLegTile / 2));
    grid.z = std::max<int>(grid.z, tiles(nc[0], chunk / 2));
  }
  return grid;
}

// Blocks of one launch resident on one SM (registers, shared memory and
// threads all counted; kRestrict: the dense kernel's), or -1.
template <typename T>
int leg_occupancy(int mode, int K, int reach) {
  if (K < 1 || K > kMaxLegK) return -1;
  const size_t smem = leg_smem(mode, K, reach, sizeof(compute_t<T>));
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
                       const int* excl, const int* coarse, cudaStream_t stream) {
  if (K < 1 || K > kMaxLegK || chunk < 2 || chunk % 2) return cudaErrorInvalidValue;
  const size_t smem = leg_smem(mode, K, reach, sizeof(compute_t<T>));
  const int threads = leg_threads(mode, K, reach);
  if (threads > (mode == kRestrict ? kMaxDownThreads : kMaxUpThreads)) return cudaErrorInvalidValue;
  if (mode < kSmooth || mode > kRestrict) return cudaErrorInvalidValue;
  const Coarse cg = make_coarse(coarse);
  auto kernel = leg_kernel_for<T>(K, mode, !is_dense(cg, nzc, nyc, nxc));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid = leg_grid(mode, nz, ny, nx, cg.n, chunk);
  using C = compute_t<T>;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<T*>(out), static_cast<T*>(outc), static_cast<const T*>(sol),
      static_cast<const T*>(solc), static_cast<const T*>(rhs), nz, ny, nx, nzc, nyc, nxc,
      make_star<C>(coefs), static_cast<C>(scale), reach, chunk, make_taps<C>(taps, ntaps, lo),
      make_excl(excl), cg);
  return cudaGetLastError();
}

// K11/K12 (T float or double): as launch_leg, dense, the face arrays in
// place of the star, omega in place of the scale; reach at most 1.
template <typename T>
cudaError_t launch_leg_faces(void* out, void* outc, const void* sol, const void* solc,
                             const void* rhs, const void* fz, const void* fy, const void* fx,
                             int nz, int ny, int nx, int nzc, int nyc, int nxc, double omega,
                             int K, int reach, int mode, int chunk, const double* taps,
                             const int* ntaps, const int* lo, cudaStream_t stream) {
  if (K < 1 || K > kMaxLegK || chunk < 2 || chunk % 2) return cudaErrorInvalidValue;
  if (mode < kSmooth || mode > kRestrict || reach < 0 || reach > 1) return cudaErrorInvalidValue;
  const size_t smem = leg_smem(mode, K, reach, sizeof(T));
  auto kernel = leg_kernel_faces_for<T>(K, mode);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nc[3] = {nzc, nyc, nxc};
  const Excl none = {{-1, -1, -1, -1, -1, -1}};
  kernel<<<leg_grid(mode, nz, ny, nx, nc, chunk), leg_threads(mode, K, reach), smem, stream>>>(
      static_cast<T*>(out), static_cast<T*>(outc), static_cast<const T*>(sol),
      static_cast<const T*>(solc), static_cast<const T*>(rhs), nz, ny, nx, nzc, nyc, nxc,
      Star<T>{}, static_cast<T>(omega), reach, chunk, make_taps<T>(taps, ntaps, lo), none,
      Coarse{},
      Faces<T>{static_cast<const T*>(fz), static_cast<const T*>(fy), static_cast<const T*>(fx)});
  return cudaGetLastError();
}

// Calls f(static_cast<T*>(nullptr)) for K11/K12's field types, float32 and
// float64; `bad` for any other dtype code.
template <typename R, typename F>
R with_face_dtype(int dtype, R bad, F f) {
  switch (dtype) {
    case kFloat32:
      return f(static_cast<float*>(nullptr));
    case kFloat64:
      return f(static_cast<double*>(nullptr));
    default:
      return bad;
  }
}

}  // namespace

// Plain C interface for ctypes, as stream3d.cu's.  `out` (and K1's `outc`)
// are new arrays, never aliases of the inputs; `solc` is read by kProlong
// only, `outc` written by kRestrict only (pass any pointer otherwise).  The
// transfer taps are the prolongation's for kProlong, the restriction's
// for kRestrict; `chunk` (even) is the fine z-planes of one block;
// `coarse` is K1's geometry (12 ints: Coarse's off, n, lo, hi per dim; read
// by kRestrict only, which takes the dense kernel where it is the dense
// geometry).  Returns the CUDA error of the launch.
extern "C" {

// The layout constants the wrapper mirrors (ops/cuda/stream3d.py), in order:
// kLegTile, kLegChunk, kLegAhead, kMaxLegK.
int exa_leg_constant(int i) {
  const int c[] = {kLegTile, kLegChunk, kLegAhead, kMaxLegK};
  return i >= 0 && i < 4 ? c[i] : -1;
}

// Shared memory of one block for fields of dtype code `dtype` (star3d.cuh
// DType), -1 for an unknown code.
long long exa_leg_smem(int mode, int K, int reach, int dtype) {
  return with_dtype(dtype, -1LL, [&](auto* z) {
    using T = std::remove_pointer_t<decltype(z)>;
    return static_cast<long long>(leg_smem(mode, K, reach, sizeof(compute_t<T>)));
  });
}

int exa_leg_occupancy(int mode, int K, int reach, int dtype) {
  return with_dtype(dtype, -1, [&](auto* z) {
    return leg_occupancy<std::remove_pointer_t<decltype(z)>>(mode, K, reach);
  });
}

// K11/K12: their threads (their shared memory is exa_leg_smem's), and one
// launch (exa_leg's arguments, with the face arrays fz, fy, fx and omega in
// place of the star, the scale, the excl planes and the coarse geometry).
int exa_leg_faces_threads(int mode, int K, int reach) { return leg_threads(mode, K, reach); }

int exa_leg_faces(void* out, void* outc, const void* sol, const void* solc, const void* rhs,
                  const void* fz, const void* fy, const void* fx, int nz, int ny, int nx, int nzc,
                  int nyc, int nxc, double omega, int K, int reach, int mode, int chunk,
                  const double* taps, const int* ntaps, const int* lo, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_face_dtype(dtype, static_cast<int>(cudaErrorInvalidValue), [&](auto* z) {
    return static_cast<int>(launch_leg_faces<std::remove_pointer_t<decltype(z)>>(
        out, outc, sol, solc, rhs, fz, fy, fx, nz, ny, nx, nzc, nyc, nxc, omega, K, reach, mode,
        chunk, taps, ntaps, lo, st));
  });
}

int exa_leg(void* out, void* outc, const void* sol, const void* solc, const void* rhs, int nz,
            int ny, int nx, int nzc, int nyc, int nxc, const double* coefs, double scale, int K,
            int reach, int mode, int chunk, const double* taps, const int* ntaps,
            const int* lo, const int* excl, const int* coarse, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, static_cast<int>(cudaErrorInvalidValue), [&](auto* z) {
    return static_cast<int>(launch_leg<std::remove_pointer_t<decltype(z)>>(
        out, outc, sol, solc, rhs, nz, ny, nx, nzc, nyc, nxc, coefs, scale, K, reach, mode, chunk,
        taps, ntaps, lo, excl, coarse, st));
  });
}

}  // extern "C"
