// Single-pass z-streaming wavefront kernels for 3D radius-1 star stencils
// on Hopper (sm_90a): the v1 single-plane schedules of the TPU package,
// each one launch per call, with its own wrapper, launch count and plain
// version in ops/cuda/stream3d.py:
//   K6 = exastencils_tpu/ops/pallas/stream3d.py:_rbgs_kernel
//        K RBGS iterations (rbgs_wavefront)
//   K7 = exastencils_tpu/ops/pallas/stream3d.py:_smooth_down_kernel
//        K RBGS iterations + residual + 2:1 restriction, the down leg
//        (smooth_res_restrict_wavefront)
//   K8 = exastencils_tpu/ops/pallas/stream3d.py:_up_smooth_kernel
//        prolongation + correction + K RBGS iterations, the up leg
//        (prolong_correct_smooth_wavefront)
//
// The schedule is the TPU kernels': z-planes stream through a ring, and
// when plane p arrives, red-iteration-k is applied to plane p-(2k-1) and
// black-iteration-k to plane p-2k, k = 1..K, in that lag order, so one
// pass equals K sequential sweeps (exastencils_tpu/ops/pallas/stream3d.py
// module docstring).  The arithmetic is K1-K5's (star3d.cuh): global
// (z+y+x)%2 parity, the reference term order, --fmad=false, so the
// smoothed iterate is bitwise that of the plain PyTorch path.
//
// What differs from the TPU kernels:
// - A 513^2 plane does not fit in shared memory, so each block owns one
//   kWaveTile^2 (y, x) output tile and streams a window of the tile plus a
//   halo through a ring of planes in shared memory; its z-loop takes the
//   place of the TPU's sequential grid axis.  Every half-sweep leaves one
//   more ring of the window stale, so the halo is 2K (K6, K8) or 2K+1 plus
//   the restriction's reach (K7), and half-sweep l skips the outer l
//   nodes, which no output reads.
// - Blocks run concurrently and in no order, so the result is written to a
//   new array: smoothing in place would hand a neighbour block, still
//   loading its halo, values that are already smoothed.  The TPU kernels
//   aliased sol.
// - rhs is read from device memory (through L1/L2) at update time, not
//   kept in a ring, so that a float64 window fits.
// - The transfers are K4/K5's direct stride-2 stencils, where the TPU
//   kernels used banded matrix products.  K7 keeps the residual of the
//   last 4 fine planes (its tile plus the taps' reach) in a ring and
//   restricts a coarse plane once its last fine plane is there, summing
//   z innermost as K1 does, so its coarse rhs equals K1's to the last bit.
//
// Bound (a first, simple design; faster variants are later work): the
// shared-memory traffic and the 2K+1 (K7: 2K+2) block barriers per plane, not device
// memory.  The window is (32+2h)^2 nodes for a 32^2 tile (h = 6 for K6/K8
// at K=3, ~1.9x the tile; h = 8 for K7, 2.25x), every half-sweep reads 7
// window values per node, stride-2 along x (2-way bank conflicts in f32),
// and one rhs value from L1/L2, and no load of plane p+1 overlaps the
// sweeps of plane p (no cp.async/TMA prefetch).  K8 also evaluates K5's
// 27 guarded prolongation taps for every window node.  A 513^3 grid is
// 17^2 = 289 blocks; with 62 KB (K6/K8) or 99 KB (K7) of shared memory in
// f32 at K=3, three or two fit per SM and all run in one wave; f64 needs
// 124 KB or 198 KB, one block per SM, ~2.2 waves.

#include <algorithm>

#include "star3d.cuh"

namespace {

using namespace exa;

constexpr int kWaveTile = 32;            // fine output tile edge in y and x
constexpr int kCoarseTile = kWaveTile / 2;  // K7's coarse output tile edge
constexpr int kWaveThreads = 256;

// The block's window: an (r, r) box of every z-plane with global origin
// (y0, x0); the block's output tile starts `halo` nodes inside it.
struct Window {
  int y0, x0, r, halo;
};

__device__ __forceinline__ Window window_at(int tile_y, int tile_x, int halo) {
  return Window{tile_y - halo, tile_x - halo, kWaveTile + 2 * halo, halo};
}

// Nodes of plane z in the window; 0 outside the array (never read).
template <typename T>
__device__ void load_plane(T* dst, const T* __restrict__ src, int z, int ny,
                           int nx, const Window& w) {
  const T* plane = src + static_cast<int64_t>(z) * ny * nx;
  for (int i = threadIdx.x; i < w.r * w.r; i += blockDim.x) {
    const int gy = w.y0 + i / w.r, gx = w.x0 + i % w.r;
    dst[i] = (gy >= 0 && gy < ny && gx >= 0 && gx < nx)
                 ? plane[static_cast<int64_t>(gy) * nx + gx] : T(0);
  }
}

// K8's ingest: plane z of sol + P sol_c on inner nodes (K5's arithmetic;
// the boundary keeps its values and bc is not reapplied).
template <typename T>
__device__ void ingest_plane(T* dst, const T* __restrict__ sol,
                             const T* __restrict__ solc, int z, int nz, int ny,
                             int nx, int nzc, int nyc, int nxc, const Taps<T>& t,
                             const Window& w) {
  const Excl none{{-1, -1, -1, -1, -1, -1}};
  const T* plane = sol + static_cast<int64_t>(z) * ny * nx;
  for (int i = threadIdx.x; i < w.r * w.r; i += blockDim.x) {
    const int gy = w.y0 + i / w.r, gx = w.x0 + i % w.r;
    T v = T(0);
    if (gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
      v = plane[static_cast<int64_t>(gy) * nx + gx];
      if (updatable(z, gy, gx, nz, ny, nx, none))
        v = v + prolong_at(solc, z, gy, gx, nzc, nyc, nxc, t);
    }
    dst[i] = v;
  }
}

// One colour of one RBGS iteration on ring plane q, skipping the outer
// `shrink` nodes of the window.  A colour reads only the other colour, so
// the in-place update in shared memory is race-free.
template <typename T>
__device__ void half_sweep_plane(T* ring, int nslots, int q, int color,
                                 int shrink, const T* __restrict__ rhs, int nz,
                                 int ny, int nx, const Window& w,
                                 const Star<T>& s, T scale, const Excl& e) {
  const int plane = w.r * w.r;
  const T* a = ring + ((q - 1) % nslots) * plane;
  T* b = ring + (q % nslots) * plane;
  const T* c = ring + ((q + 1) % nslots) * plane;
  const T* f = rhs + static_cast<int64_t>(q) * ny * nx;
  const int span = w.r - 2 * shrink;
  const int cols = (span + 1) / 2;  // nodes of one colour per row, at most
  for (int i = threadIdx.x; i < span * cols; i += blockDim.x) {
    const int ly = shrink + i / cols;
    const int gy = w.y0 + ly;
    // the first lx >= shrink with (q + gy + x0 + lx) % 2 == color
    const int lx = shrink + ((color - q - gy - w.x0 - shrink) & 1) + 2 * (i % cols);
    const int gx = w.x0 + lx;
    if (lx >= w.r - shrink || !updatable(q, gy, gx, nz, ny, nx, e)) continue;
    const int li = ly * w.r + lx;
    const T corr = scale * (f[static_cast<int64_t>(gy) * nx + gx] -
                            star_apply(a + li, b + li, c + li, w.r, s));
    b[li] = b[li] + corr;
  }
}

// The wavefront of step p: half-sweep `lag` on plane p - lag, red for odd
// lags, for lag = 1..2K in order, a barrier after each.
template <typename T>
__device__ void wavefront_step(T* ring, int nslots, int p, int K,
                               const T* __restrict__ rhs, int nz, int ny, int nx,
                               const Window& w, const Star<T>& s, T scale,
                               const Excl& e) {
  for (int lag = 1; lag <= 2 * K; ++lag) {
    const int q = p - lag;
    if (q < 1 || q > nz - 2 || q == e.p[0] || q == e.p[1]) continue;  // block-uniform
    half_sweep_plane(ring, nslots, q, (lag & 1) ? 0 : 1, lag, rhs, nz, ny, nx,
                     w, s, scale, e);
    __syncthreads();
  }
}

// The tile's nodes of ring plane `src` into plane z of out.
template <typename T>
__device__ void store_tile(T* __restrict__ out, const T* src, int z, int ny,
                           int nx, const Window& w) {
  for (int i = threadIdx.x; i < kWaveTile * kWaveTile; i += blockDim.x) {
    const int ty = i / kWaveTile, tx = i % kWaveTile;
    const int gy = w.y0 + w.halo + ty, gx = w.x0 + w.halo + tx;
    if (gy < ny && gx < nx)
      out[(static_cast<int64_t>(z) * ny + gy) * nx + gx] =
          src[(w.halo + ty) * w.r + w.halo + tx];
  }
}

// K6.  Ring of 2K+2 planes: step p holds planes p-2K-1 .. p.
template <typename T>
__global__ void __launch_bounds__(kWaveThreads)
rbgs_wavefront(T* __restrict__ out, const T* __restrict__ sol,
               const T* __restrict__ rhs, int nz, int ny, int nx, Star<T> s,
               T scale, int K, Excl e) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const Window w = window_at(blockIdx.y * kWaveTile, blockIdx.x * kWaveTile, 2 * K);
  const int nslots = 2 * K + 2, plane = w.r * w.r;
  for (int p = 0; p < nz + 2 * K; ++p) {
    if (p < nz) load_plane(ring + (p % nslots) * plane, sol, p, ny, nx, w);
    __syncthreads();
    wavefront_step(ring, nslots, p, K, rhs, nz, ny, nx, w, s, scale, e);
    const int qo = p - 2 * K;  // final after black-K
    if (qo >= 0) store_tile(out, ring + (qo % nslots) * plane, qo, ny, nx, w);
  }
}

// K8.  As K6, with each plane ingested as sol + P sol_c; no excl planes.
template <typename T>
__global__ void __launch_bounds__(kWaveThreads)
prolong_correct_smooth_wavefront(T* __restrict__ out, const T* __restrict__ sol,
                                 const T* __restrict__ solc,
                                 const T* __restrict__ rhs, int nz, int ny,
                                 int nx, int nzc, int nyc, int nxc, Star<T> s,
                                 T scale, int K, Taps<T> t) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const Excl none{{-1, -1, -1, -1, -1, -1}};
  const Window w = window_at(blockIdx.y * kWaveTile, blockIdx.x * kWaveTile, 2 * K);
  const int nslots = 2 * K + 2, plane = w.r * w.r;
  for (int p = 0; p < nz + 2 * K; ++p) {
    if (p < nz)
      ingest_plane(ring + (p % nslots) * plane, sol, solc, p, nz, ny, nx, nzc,
                   nyc, nxc, t, w);
    __syncthreads();
    wavefront_step(ring, nslots, p, K, rhs, nz, ny, nx, w, s, scale, none);
    const int qo = p - 2 * K;
    if (qo >= 0) store_tile(out, ring + (qo % nslots) * plane, qo, ny, nx, w);
  }
}

// The residual of ring plane q (zero on the boundary planes and ring) on
// K7's residual box: the block's fine tile plus `reach` nodes per side,
// which the coarse tile's restriction taps cover.
template <typename T>
__device__ void residual_plane(T* dst, const T* ring, int nslots, int q,
                               const T* __restrict__ rhs, int nz, int ny, int nx,
                               int reach, const Window& w, const Star<T>& s) {
  const Excl none{{-1, -1, -1, -1, -1, -1}};
  const int plane = w.r * w.r;
  const int rr = kWaveTile + 2 * reach, off = w.halo - reach;  // box origin in the window
  const T* a = ring + ((q + nslots - 1) % nslots) * plane;
  const T* b = ring + (q % nslots) * plane;
  const T* c = ring + ((q + 1) % nslots) * plane;
  const T* f = rhs + static_cast<int64_t>(q) * ny * nx;
  for (int i = threadIdx.x; i < rr * rr; i += blockDim.x) {
    const int ly = off + i / rr, lx = off + i % rr;
    const int gy = w.y0 + ly, gx = w.x0 + lx;
    T r = T(0);
    if (updatable(q, gy, gx, nz, ny, nx, none)) {
      const int li = ly * w.r + lx;
      r = f[static_cast<int64_t>(gy) * nx + gx] - star_apply(a + li, b + li, c + li, w.r, s);
    }
    dst[i] = r;
  }
}

// K7's restriction: every coarse plane whose last contributing fine plane
// (clamped to the array) is q, from the 4-deep ring of residual boxes.
// The sums are K1's residual_restrict's (z innermost, then y, then x;
// taps outside the array dropped), so the coarse rhs is the same to the
// last bit.
template <typename T>
__device__ void restrict_coarse_planes(T* __restrict__ outc, const T* rres, int q,
                                       int nz, int ny, int nx, int nzc, int nyc,
                                       int nxc, int cy0, int cx0, int reach,
                                       const Window& w, const Taps<T>& t) {
  const int rr = kWaveTile + 2 * reach;
  const int by = w.y0 + w.halo - reach, bx = w.x0 + w.halo - reach;  // box origin
  const int lo = t.lo[0], nw = t.n[0];
  for (int cz = max(0, (q - lo - nw + 1) / 2 - 1); cz < nzc; ++cz) {
    const int last = min(max(2 * cz + lo + nw - 1, 0), nz - 1);
    if (last > q) break;
    if (last < q) continue;
    for (int i = threadIdx.x; i < kCoarseTile * kCoarseTile; i += blockDim.x) {
      const int cy = cy0 + i / kCoarseTile, cx = cx0 + i % kCoarseTile;
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
          T acc_z = T(0);
#pragma unroll
          for (int kz = 0; kz < kMaxTaps; ++kz) {
            const int z = 2 * cz + lo + kz;  // in q-2 .. q for nw <= 3
            if (kz >= nw || z < 0 || z >= nz) continue;
            acc_z = acc_z + t.w[0][kz] * rres[((z & 3) * rr + y - by) * rr + x - bx];
          }
          acc_y = acc_y + t.w[1][ky] * acc_z;
        }
        acc_x = acc_x + t.w[2][kx] * acc_y;
      }
      outc[(static_cast<int64_t>(cz) * nyc + cy) * nxc + cx] = acc_x;
    }
  }
}

// K7.  Ring of 2K+3 planes: the residual of plane p-2K-1 also reads
// plane p-2K-2.  Fine tiles start at even indices (2 * the coarse tile),
// so coarse tiles partition the coarse array.
template <typename T>
__global__ void __launch_bounds__(kWaveThreads)
smooth_res_restrict_wavefront(T* __restrict__ out, T* __restrict__ outc,
                              const T* __restrict__ sol,
                              const T* __restrict__ rhs, int nz, int ny, int nx,
                              int nzc, int nyc, int nxc, Star<T> s, T scale,
                              int K, int reach, Taps<T> t) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const Excl none{{-1, -1, -1, -1, -1, -1}};
  const Window w = window_at(blockIdx.y * kWaveTile, blockIdx.x * kWaveTile,
                             2 * K + 1 + reach);
  const int nslots = 2 * K + 3, plane = w.r * w.r;
  const int rbox = (kWaveTile + 2 * reach) * (kWaveTile + 2 * reach);
  T* rres = ring + nslots * plane;  // 4 residual boxes
  const int cy0 = blockIdx.y * kCoarseTile, cx0 = blockIdx.x * kCoarseTile;
  for (int p = 0; p <= nz + 2 * K; ++p) {
    if (p < nz) load_plane(ring + (p % nslots) * plane, sol, p, ny, nx, w);
    __syncthreads();
    wavefront_step(ring, nslots, p, K, rhs, nz, ny, nx, w, s, scale, none);
    const int qr = p - 2 * K - 1;  // planes qr-1 .. qr+1 are final
    if (qr >= 0)
      residual_plane(rres + (qr & 3) * rbox, ring, nslots, qr, rhs, nz, ny, nx,
                     reach, w, s);
    const int qo = p - 2 * K;
    if (qo >= 0 && qo < nz) store_tile(out, ring + (qo % nslots) * plane, qo, ny, nx, w);
    __syncthreads();
    if (qr >= 0)
      restrict_coarse_planes(outc, rres, qr, nz, ny, nx, nzc, nyc, nxc, cy0, cx0,
                             reach, w, t);
  }
}

int tiles(int n, int tile) { return (n + tile - 1) / tile; }

// Dynamic shared memory of one block; kernel: 6, 7 or 8.
size_t wavefront_smem(int kernel, int K, int reach, size_t itemsize) {
  const size_t halo = kernel == 7 ? 2 * K + 1 + reach : 2 * K;
  const size_t r = kWaveTile + 2 * halo;
  const size_t nslots = kernel == 7 ? 2 * K + 3 : 2 * K + 2;
  const size_t box = kWaveTile + 2 * reach;
  const size_t rres = kernel == 7 ? 4 * box * box : 0;
  return (nslots * r * r + rres) * itemsize;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch_rbgs_wavefront(void* out, const void* sol, const void* rhs,
                                  int nz, int ny, int nx, const double* coefs,
                                  double scale, int K, const int* excl,
                                  cudaStream_t stream) {
  const size_t smem = wavefront_smem(6, K, 0, sizeof(T));
  const cudaError_t err = allow_smem(rbgs_wavefront<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles(nx, kWaveTile), tiles(ny, kWaveTile));
  rbgs_wavefront<T><<<grid, kWaveThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(sol),
      static_cast<const T*>(rhs), nz, ny, nx, make_star<T>(coefs),
      static_cast<T>(scale), K, make_excl(excl));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_smooth_res_restrict_wavefront(
    void* out, void* outc, const void* sol, const void* rhs, int nz, int ny,
    int nx, int nzc, int nyc, int nxc, const double* coefs, double scale, int K,
    int reach, const double* taps, const int* ntaps, const int* lo,
    cudaStream_t stream) {
  const size_t smem = wavefront_smem(7, K, reach, sizeof(T));
  const cudaError_t err = allow_smem(smooth_res_restrict_wavefront<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(std::max(tiles(nx, kWaveTile), tiles(nxc, kCoarseTile)),
                  std::max(tiles(ny, kWaveTile), tiles(nyc, kCoarseTile)));
  smooth_res_restrict_wavefront<T><<<grid, kWaveThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<T*>(outc), static_cast<const T*>(sol),
      static_cast<const T*>(rhs), nz, ny, nx, nzc, nyc, nxc,
      make_star<T>(coefs), static_cast<T>(scale), K, reach,
      make_taps<T>(taps, ntaps, lo));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_prolong_correct_smooth_wavefront(
    void* out, const void* sol, const void* solc, const void* rhs, int nz,
    int ny, int nx, int nzc, int nyc, int nxc, const double* coefs,
    double scale, int K, const double* taps, const int* ntaps, const int* lo,
    cudaStream_t stream) {
  const size_t smem = wavefront_smem(8, K, 0, sizeof(T));
  const cudaError_t err = allow_smem(prolong_correct_smooth_wavefront<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles(nx, kWaveTile), tiles(ny, kWaveTile));
  prolong_correct_smooth_wavefront<T><<<grid, kWaveThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(sol),
      static_cast<const T*>(solc), static_cast<const T*>(rhs), nz, ny, nx, nzc,
      nyc, nxc, make_star<T>(coefs), static_cast<T>(scale), K,
      make_taps<T>(taps, ntaps, lo));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes, as stream3d.cu's.  `out`/`outc` are new
// arrays, never aliases of the inputs.  Each entry launches on `stream`
// without synchronising and returns the CUDA error (a window too large
// for shared memory is refused here, before the launch).
extern "C" {

int exa_wavefront_tile() { return kWaveTile; }

int exa_rbgs_wavefront(void* out, const void* sol, const void* rhs, int nz,
                       int ny, int nx, const double* coefs, double scale, int K,
                       const int* excl, int is_double, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_double ? launch_rbgs_wavefront<double>(out, sol, rhs, nz, ny, nx, coefs, scale, K, excl, st)
                : launch_rbgs_wavefront<float>(out, sol, rhs, nz, ny, nx, coefs, scale, K, excl, st));
}

int exa_smooth_res_restrict_wavefront(void* out, void* outc, const void* sol,
                                      const void* rhs, int nz, int ny, int nx,
                                      int nzc, int nyc, int nxc,
                                      const double* coefs, double scale, int K,
                                      int reach, const double* taps,
                                      const int* ntaps, const int* lo,
                                      int is_double, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_double ? launch_smooth_res_restrict_wavefront<double>(
                      out, outc, sol, rhs, nz, ny, nx, nzc, nyc, nxc, coefs,
                      scale, K, reach, taps, ntaps, lo, st)
                : launch_smooth_res_restrict_wavefront<float>(
                      out, outc, sol, rhs, nz, ny, nx, nzc, nyc, nxc, coefs,
                      scale, K, reach, taps, ntaps, lo, st));
}

int exa_prolong_correct_smooth_wavefront(void* out, const void* sol,
                                         const void* solc, const void* rhs,
                                         int nz, int ny, int nx, int nzc,
                                         int nyc, int nxc, const double* coefs,
                                         double scale, int K, const double* taps,
                                         const int* ntaps, const int* lo,
                                         int is_double, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_double ? launch_prolong_correct_smooth_wavefront<double>(
                      out, sol, solc, rhs, nz, ny, nx, nzc, nyc, nxc, coefs,
                      scale, K, taps, ntaps, lo, st)
                : launch_prolong_correct_smooth_wavefront<float>(
                      out, sol, solc, rhs, nz, ny, nx, nzc, nyc, nxc, coefs,
                      scale, K, taps, ntaps, lo, st));
}

}  // extern "C"
