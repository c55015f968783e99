// The single-pass z-streaming wavefront smoother for 3D radius-1 star
// stencils on Hopper (sm_90a), the v1 single-plane schedule of the TPU
// package, one launch per call, with its wrapper, launch count and plain
// version in ops/cuda/stream3d.py:
//   K6 = exastencils_tpu/ops/pallas/stream3d.py:_rbgs_kernel
//        K RBGS iterations (rbgs_wavefront)
// (The v1 legs K7/K8 are cluster_legs3d.cu's.)
//
// The schedule is the TPU kernel's: z-planes stream through a ring, and
// when plane p arrives, red-iteration-k is applied to plane p-(2k-1) and
// black-iteration-k to plane p-2k, k = 1..K, in that lag order, so one
// pass equals K sequential sweeps (exastencils_tpu/ops/pallas/stream3d.py
// module docstring).  The arithmetic is K1-K5's (star3d.cuh): global
// (z+y+x)%2 parity, the reference term order, --fmad=false, so the
// smoothed iterate is bitwise that of the plain PyTorch path.
//
// What differs from the TPU kernel:
// - A 513^2 plane does not fit in shared memory, so each block owns one
//   kWaveTile^2 (y, x) output tile and streams a window of the tile plus a
//   halo through a ring of planes in shared memory; its z-loop takes the
//   place of the TPU's sequential grid axis.  Every half-sweep leaves one
//   more ring of the window stale, so the halo is 2K, and half-sweep l
//   skips the outer l nodes, which no output reads.
// - Blocks run concurrently and in no order, so the result is written to a
//   new array: smoothing in place would hand a neighbour block, still
//   loading its halo, values that are already smoothed.  The TPU kernel
//   aliased sol.
// - rhs is read from device memory (through L1/L2) at update time, not
//   kept in a ring, so that a float64 window fits.
//
// Bound (a first, simple design; faster variants are later work): the
// shared-memory traffic and the 2K+1 block barriers per plane, not device
// memory.  The window is (32+4K)^2 nodes for a 32^2 tile (~1.9x the tile
// at K=3), every half-sweep reads 7 window values per node, stride-2 along
// x (2-way bank conflicts in f32), and one rhs value from L1/L2, and no
// load of plane p+1 overlaps the sweeps of plane p (no cp.async/TMA
// prefetch).  A 513^3 grid is 17^2 = 289 blocks; with 62 KB of shared
// memory in f32 at K=3 three fit per SM and all run in one wave; f64
// needs 124 KB, one block per SM, ~2.2 waves.

#include <algorithm>

#include "star3d.cuh"

namespace {

using namespace exa;

constexpr int kWaveTile = 32;            // fine output tile edge in y and x
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

int tiles(int n, int tile) { return (n + tile - 1) / tile; }

// Dynamic shared memory of one block: a ring of 2K+2 windows.
size_t wavefront_smem(int K, size_t itemsize) {
  const size_t r = kWaveTile + 4 * K;
  return (2 * K + 2) * r * r * itemsize;
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
  const size_t smem = wavefront_smem(K, sizeof(T));
  const cudaError_t err = allow_smem(rbgs_wavefront<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles(nx, kWaveTile), tiles(ny, kWaveTile));
  rbgs_wavefront<T><<<grid, kWaveThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(sol),
      static_cast<const T*>(rhs), nz, ny, nx, make_star<T>(coefs),
      static_cast<T>(scale), K, make_excl(excl));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes, as stream3d.cu's.  `out` is a new array,
// never an alias of the inputs.  The entry launches on `stream` without
// synchronising and returns the CUDA error (a window too large for shared
// memory is refused here, before the launch).
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

}  // extern "C"
