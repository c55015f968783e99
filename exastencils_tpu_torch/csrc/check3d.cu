// The residual check of a 3D level on Hopper (sm_90a), one pass each, with
// their wrappers, launch counts and plain versions in ops/cuda/check3d.py:
//   K9  = residual_kernel: res = f - A u on the inner nodes of a node field,
//         a radius-1 star A, the Dirichlet ring set to zero or left as it is
//         (wrapper residual)
//   K10 = sum_squares_kernel + sum_partials_kernel: the sum of res * res over
//         the inner nodes, deterministic (wrapper inner_sum_squares)
// They replace no TPU kernel: the JAX package leaves an ExaSlang program's
// standalone residual and norm to XLA, which fuses them.  The port ran them
// as ~40 passes of plain PyTorch ops a check (interior mask from index
// compares, padding, seven shifted products, where, a copy for `apply bc`,
// a masked sum), 25.6 ms a cycle at 513^3 f32 on an H100, more than the
// multigrid cycle itself (PERF.md §5).  dsl/fastpath.py routes a program's
// CalcRes-shaped function bodies to K9 and its `+ : acc += res * res`
// reductions to K10.
//
// What is computed is the plain path's: K9 sums A's terms in the order
// centre, z-, z+, y-, y+, x-, x+ (ops/stencil_apply.apply_stencil, K4's
// order), then subtracts from f; built with --fmad=false it is bitwise the
// plain version.  K10 squares each value (rounded to the field's type, as
// the plain path stores res * res) and sums in double, whatever the field's
// type, so only its order differs from torch.sum's; block partials are
// summed by a second, one-block launch in a fixed order (no atomics): the
// same inputs on the same card give the same bits.  Fields are float32,
// float64 or bfloat16 under star3d.cuh's rounding contract (float32
// arithmetic, each stored value rounded once); K10 rounds its sum once to
// the field's type.
//
// Bound: device-memory bytes.  K9 must read u and f and write res once: 3N
// values, 1.620 GB at 513^3 f32, 0.484 ms at the H100's 3.35 TB/s (14 flops
// a node, a tenth of that).  K10 must read res once: 0.540 GB, 0.161 ms.
// This design:
//
// - K9: each block owns a kResTileY x kResTileX (y, x) tile of inner
//   columns and a short z-chunk of inner planes (the wrapper's: 32 bytes of
//   a column, 8 float32 planes), one thread a column, neighbouring x on
//   neighbouring threads.  Short chunks ran fastest: at 513^3 float32 on an
//   H100 0.62 ms at 8 planes, 0.72 at 16, 0.92 at 64 (PERF.md §6).  A thread walks its chunk in z keeping its
//   column's z-1, z, z+1 values in registers; the y and x neighbours of
//   plane z come through L1 (the tile's threads loaded most of them as
//   their own values a few steps earlier).  The loads of u and f are
//   issued two steps ahead of their use, so each thread keeps four
//   device-memory loads in flight while it computes.  The ring columns and
//   planes are zeroed by the threads next to them (the first chunk writes
//   plane 0, the last plane nz-1), or not written at all.
// - K10: each warp takes whole inner rows (z, y) in turn, its lanes
//   neighbouring x, four loads in flight a lane; warp and block sums by
//   shuffles and shared memory in a fixed tree.  The wrapper fixes the grid
//   from the card's SM count, so the partials, and the sum, do not change
//   from run to run.

#include "star3d.cuh"

namespace {

using namespace exa;

constexpr int kResTileY = 8;   // K9: inner columns of a tile, y
constexpr int kResTileX = 32;  //     and x (one warp a row)
constexpr int kSumThreads = 256;
constexpr int kSumUnroll = 4;  // K10: loads in flight a lane

// A double sum rounded once to the field's type.
template <typename T>
__device__ __forceinline__ T narrow_sum(double v) {
  return static_cast<T>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow_sum<__nv_bfloat16>(double v) {
  return __double2bfloat16(v);
}

// residual_kernel: K9.  res = f - A u on the inner nodes of the block's
// tile and chunk; with zero_ring the ring nodes of its columns and planes
// set to zero, else not written.
template <typename T>
__global__ void __launch_bounds__(kResTileY * kResTileX)
residual_kernel(T* __restrict__ res, const T* __restrict__ u, const T* __restrict__ f, int nz,
                int ny, int nx, int chunk, Star<compute_t<T>> s, int zero_ring) {
  using C = compute_t<T>;
  const int x = 1 + blockIdx.x * kResTileX + threadIdx.x;
  const int y = 1 + blockIdx.y * kResTileY + threadIdx.y;
  if (x > nx - 1 || y > ny - 1) return;
  const int z0 = 1 + blockIdx.z * chunk, z1 = min(z0 + chunk, nz - 1);  // inner planes
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t p = static_cast<int64_t>(y) * nx + x;
  const bool first = blockIdx.z == 0, last = z1 == nz - 1;
  const T zero = narrow<T>(C(0));

  if (zero_ring) {
    // Ring columns: this column if it lies on the ring, and the x = 0 and
    // y = 0 columns next to the first inner ones; ring planes: this
    // chunk's edge planes 0 and nz - 1.
    const bool inner = x <= nx - 2 && y <= ny - 2;
    const int za = first ? 0 : z0, zb = last ? nz : z1;
    for (int z = za; z < zb; ++z) {
      T* r = res + z * plane;
      const bool ring_plane = z == 0 || z == nz - 1;
      if (!inner || ring_plane) r[p] = zero;
      if (x == 1) r[p - 1] = zero;
      if (y == 1) r[p - nx] = zero;
      if (x == 1 && y == 1) r[p - nx - 1] = zero;
    }
    if (!inner) return;
  } else if (x > nx - 2 || y > ny - 2) {
    return;
  }

  // The column's z - 1, z and z + 1 values; u at z + 2 and z + 3 and f at
  // z + 1 and z + 2 are loaded two steps ahead of their use.
  const T* uc = u + p;
  const T* fc = f + p;
  C um = widen(uc[(z0 - 1) * plane]);
  C u0 = widen(uc[z0 * plane]);
  C up = widen(uc[(z0 + 1) * plane]);
  C fv = widen(fc[z0 * plane]);
  T un = z0 + 1 < z1 ? uc[(z0 + 2) * plane] : zero;
  T fn = z0 + 1 < z1 ? fc[(z0 + 1) * plane] : zero;
  for (int z = z0; z < z1; ++z) {
    const bool more = z + 2 < z1;
    const T un2 = more ? uc[(z + 3) * plane] : zero;
    const T fn2 = more ? fc[(z + 2) * plane] : zero;
    const T* b = uc + z * plane;
    const C ym = widen(b[-nx]), yp = widen(b[nx]), xm = widen(b[-1]), xp = widen(b[1]);
    C au = s.c[0] * u0;
    au = au + s.c[1] * um;
    au = au + s.c[2] * up;
    au = au + s.c[3] * ym;
    au = au + s.c[4] * yp;
    au = au + s.c[5] * xm;
    au = au + s.c[6] * xp;
    res[z * plane + p] = narrow<T>(fv - au);
    um = u0;
    u0 = up;
    up = widen(un);
    fv = widen(fn);
    un = un2;
    fn = fn2;
  }
}

// The block's sum of its threads' values, in a fixed order; valid in
// thread 0.  `sh` holds a value per warp.
__device__ __forceinline__ double block_sum(double v, double* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kSumThreads / 32 ? sh[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// sum_squares_kernel: K10's first launch.  partial[block] = the sum of
// res * res over the inner rows the block's warps take (row w, w + the
// grid's warps, ...), each square rounded to the field's type.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
sum_squares_kernel(const T* __restrict__ res, double* __restrict__ partial, int nz, int ny,
                   int nx) {
  __shared__ double sh[kSumThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warps = kSumThreads / 32;
  const int64_t rows = static_cast<int64_t>(nz - 2) * (ny - 2);
  double acc = 0.0;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * warps + (threadIdx.x >> 5); r < rows;
       r += static_cast<int64_t>(gridDim.x) * warps) {
    const int64_t z = 1 + r / (ny - 2), y = 1 + r % (ny - 2);
    const T* row = res + (z * ny + y) * nx;
    for (int x0 = 1 + lane; x0 <= nx - 2; x0 += 32 * kSumUnroll) {
      compute_t<T> v[kSumUnroll];
#pragma unroll
      for (int k = 0; k < kSumUnroll; ++k) {
        const int x = x0 + 32 * k;
        v[k] = x <= nx - 2 ? widen(row[x]) : compute_t<T>(0);
      }
#pragma unroll
      for (int k = 0; k < kSumUnroll; ++k) acc += static_cast<double>(round_stored<T>(v[k] * v[k]));
    }
  }
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

// sum_partials_kernel: K10's second launch, one block.  out = the sum of
// the n partials, each thread's share in index order, then the block tree.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
sum_partials_kernel(const double* __restrict__ partial, int n, T* __restrict__ out) {
  __shared__ double sh[kSumThreads / 32];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kSumThreads) acc += partial[i];
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) *out = narrow_sum<T>(acc);
}

template <typename T>
cudaError_t launch_residual(void* res, const void* u, const void* f, int nz, int ny, int nx,
                            const double* coefs, int zero_ring, int chunk, cudaStream_t stream) {
  if (chunk < 1 || nz < 3 || ny < 3 || nx < 3) return cudaErrorInvalidValue;
  const dim3 grid((nx - 2 + kResTileX) / kResTileX, (ny - 2 + kResTileY) / kResTileY,
                  (nz - 2 + chunk - 1) / chunk);
  residual_kernel<T><<<grid, dim3(kResTileX, kResTileY), 0, stream>>>(
      static_cast<T*>(res), static_cast<const T*>(u), static_cast<const T*>(f), nz, ny, nx, chunk,
      make_star<compute_t<T>>(coefs), zero_ring);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sum_squares(const void* res, double* partial, void* out, int nz, int ny,
                               int nx, int blocks, cudaStream_t stream) {
  if (blocks < 1 || nz < 3 || ny < 3 || nx < 3) return cudaErrorInvalidValue;
  sum_squares_kernel<T><<<blocks, kSumThreads, 0, stream>>>(static_cast<const T*>(res), partial,
                                                            nz, ny, nx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<T><<<1, kSumThreads, 0, stream>>>(partial, blocks, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers except
// coefs[7] (centre, z-, z+, y-, y+, x-, x+), a host array copied into the
// launch parameters; `chunk` is K9's inner z-planes of one block, `blocks`
// K10's first launch's blocks (and its partials, float64); `dtype` the
// fields' dtype code (star3d.cuh DType; an unknown one is
// cudaErrorInvalidValue).  Each entry launches on `stream` without
// synchronising and returns cudaGetLastError() after each launch.
extern "C" {

// The layout constants the wrapper mirrors (ops/cuda/check3d.py), in
// order: kResTileY, kResTileX, kSumThreads.
int exa_check_constant(int i) {
  const int c[] = {kResTileY, kResTileX, kSumThreads};
  return i >= 0 && i < 3 ? c[i] : -1;
}

int exa_residual(void* res, const void* u, const void* f, int nz, int ny, int nx,
                 const double* coefs, int zero_ring, int chunk, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, static_cast<int>(cudaErrorInvalidValue), [&](auto* z) {
    return static_cast<int>(launch_residual<std::remove_pointer_t<decltype(z)>>(
        res, u, f, nz, ny, nx, coefs, zero_ring, chunk, s));
  });
}

int exa_sum_squares(const void* res, void* partial, void* out, int nz, int ny, int nx, int blocks,
                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, static_cast<int>(cudaErrorInvalidValue), [&](auto* z) {
    return static_cast<int>(launch_sum_squares<std::remove_pointer_t<decltype(z)>>(
        res, static_cast<double*>(partial), out, nz, ny, nx, blocks, s));
  });
}

}  // extern "C"
