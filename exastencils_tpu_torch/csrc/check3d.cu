// The residual check of a 3D level on Hopper (sm_90a), one pass each, with
// their wrappers, launch counts and plain versions in ops/cuda/check3d.py:
//   K9  = residual_kernel: res = f - A u on the inner nodes of a node field,
//         a radius-1 star A, the Dirichlet ring set to zero or left as it is
//         (wrapper residual)
//   K10 = sum_squares_kernel + sum_partials_kernel: the sum of res * res over
//         the inner nodes, deterministic (wrapper inner_sum_squares)
//   K13 = res_norm_kernel + norm_partials_kernel: sqrt of the sum over the
//         inner nodes of (f - A u)^2, the residual never stored, for a
//         constant star or a variable-coefficient star's three face arrays
//         (wrapper res_norm)
// They replace no TPU kernel: the JAX package leaves an ExaSlang program's
// standalone residual and norm to XLA, which fuses them.  The port ran them
// as ~40 passes of plain PyTorch ops a check (interior mask from index
// compares, padding, seven shifted products, where, a copy for `apply bc`,
// a masked sum), 25.6 ms a cycle at 513^3 f32 on an H100, more than the
// multigrid cycle itself (PERF.md §5).  dsl/fastpath.py routes a program's
// CalcRes-shaped function bodies to K9 and its `+ : acc += res * res`
// reductions to K10.  K13 is the solver API's convergence check
// (solver/mg.Multigrid.res_norm, `norm_l2(bc_res(f - A u))`), which ran as
// ~40 plain passes too: 15.8 ms a call at 513^3 float64, half of a solve.
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
// - K13: K9's tiles, z-chunks (the wrapper's: 128 bytes of a column) and
//   loads two steps ahead, one thread a column; each residual value is
//   squared in the field's type, as the plain path stores r * r, and added
//   to the thread's double; the block's sum (block_sum) is its partial, and
//   norm_partials_kernel sums the partials as K10's second launch does and
//   takes the square root in the field's type.  The grid is fixed by the
//   shape and the chunk, so the order of the sum is too.  Bound: u and f
//   read once, 2.161 GB at 513^3 float64, 0.645 ms; with the face arrays
//   (face_z[z + 1] read by the thread, face_y[y + 1] and face_x[x + 1] its
//   neighbours' own values, through L1) three more level-sized arrays,
//   5.41 GB, 1.61 ms.  The centre is rebuilt from the six face values in
//   models/poisson.varcoeff_laplace_stencil's order, -(((((zm + zp) + ym) +
//   yp) + xm) + xp), as legs3d.cu's face_star does, so the stored centre
//   array is never read, and A's terms are summed in the order above: each
//   node's residual is bitwise the plain one.  float32 and float64 (the
//   DSL's bfloat16 checks stay plain too).
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
static_assert(kResTileY * kResTileX == kSumThreads, "K13 sums a tile's threads with block_sum");

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

// The sum of the n partials by one block, valid in thread 0: each thread's
// share in index order, then the block tree.
__device__ __forceinline__ double partials_sum(const double* __restrict__ partial, int n,
                                               double* sh) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kSumThreads) acc += partial[i];
  return block_sum(acc, sh);
}

// sum_partials_kernel: K10's second launch, one block.  out = the sum of
// the n partials.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
sum_partials_kernel(const double* __restrict__ partial, int n, T* __restrict__ out) {
  __shared__ double sh[kSumThreads / 32];
  const double acc = partials_sum(partial, n, sh);
  if (threadIdx.x == 0) *out = narrow_sum<T>(acc);
}

// K13's variable-coefficient operator: a level's three face arrays, laid
// out as legs3d.cu's Faces (K11/K12).
template <typename T>
struct Faces {
  const T* z;  // (nz + 1, ny, nx)
  const T* y;  // (nz, ny + 1, nx)
  const T* x;  // (nz, ny, nx + 1)
};

// res_norm_kernel: K13's first launch.  partial[block] = the sum over the
// inner nodes of the block's tile and chunk of (f - A u)^2, each square
// rounded to T; A the star s, or with kFaces the star of fa at each node.
// One thread a column, threadIdx.x = y * kResTileX + x within the tile.
template <typename T, bool kFaces>
__global__ void __launch_bounds__(kSumThreads)
res_norm_kernel(const T* __restrict__ u, const T* __restrict__ f, Star<T> s, Faces<T> fa,
                double* __restrict__ partial, int nz, int ny, int nx, int chunk) {
  __shared__ double sh[kSumThreads / 32];
  const int x = 1 + blockIdx.x * kResTileX + threadIdx.x % kResTileX;
  const int y = 1 + blockIdx.y * kResTileY + threadIdx.x / kResTileX;
  const int z0 = 1 + blockIdx.z * chunk, z1 = min(z0 + chunk, nz - 1);  // inner planes
  double acc = 0.0;
  if (x <= nx - 2 && y <= ny - 2) {
    const int64_t plane = static_cast<int64_t>(ny) * nx;
    const int64_t p = static_cast<int64_t>(y) * nx + x;
    const T zero = T(0);
    // As K9: u at z + 2 and z + 3 and f at z + 1 and z + 2 loaded two
    // steps ahead of their use
    const T* uc = u + p;
    const T* fc = f + p;
    T um = uc[(z0 - 1) * plane], u0 = uc[z0 * plane], up = uc[(z0 + 1) * plane];
    T fv = fc[z0 * plane];
    T un = z0 + 1 < z1 ? uc[(z0 + 2) * plane] : zero;
    T fn = z0 + 1 < z1 ? fc[(z0 + 1) * plane] : zero;
    // The column's face values, one step ahead: face_z planes hold ny * nx
    // values, face_y planes (ny + 1) * nx, face_x rows nx + 1 (legs3d.cu's
    // face_star); face_z[z + 1], the z+ entry of plane z, is the z- entry
    // of plane z + 1
    const T* kz = fa.z + p;
    const T* ky = fa.y + p;
    const T* kx = fa.x + p + y;
    const int64_t yplane = plane + nx, xplane = plane + ny;
    T czm = zero, czp = zero, cym = zero, cyp = zero, cxm = zero, cxp = zero;
    if constexpr (kFaces) {
      czm = kz[z0 * plane];
      czp = kz[(z0 + 1) * plane];
      cym = ky[z0 * yplane];
      cyp = ky[z0 * yplane + nx];
      cxm = kx[z0 * xplane];
      cxp = kx[z0 * xplane + 1];
    }
    for (int z = z0; z < z1; ++z) {
      const bool more = z + 2 < z1;
      const T un2 = more ? uc[(z + 3) * plane] : zero;
      const T fn2 = more ? fc[(z + 2) * plane] : zero;
      const T* b = uc + z * plane;
      const T ym = b[-nx], yp = b[nx], xm = b[-1], xp = b[1];
      Star<T> k = s;
      if constexpr (kFaces) {
        const bool next = z + 1 < z1;
        const T nzp = next ? kz[(z + 2) * plane] : zero;
        const T nym = next ? ky[(z + 1) * yplane] : zero;
        const T nyp = next ? ky[(z + 1) * yplane + nx] : zero;
        const T nxm = next ? kx[(z + 1) * xplane] : zero;
        const T nxp = next ? kx[(z + 1) * xplane + 1] : zero;
        k.c[1] = czm;
        k.c[2] = czp;
        k.c[3] = cym;
        k.c[4] = cyp;
        k.c[5] = cxm;
        k.c[6] = cxp;
        k.c[0] = -(((((czm + czp) + cym) + cyp) + cxm) + cxp);
        czm = czp;
        czp = nzp;
        cym = nym;
        cyp = nyp;
        cxm = nxm;
        cxp = nxp;
      }
      T au = k.c[0] * u0;
      au = au + k.c[1] * um;
      au = au + k.c[2] * up;
      au = au + k.c[3] * ym;
      au = au + k.c[4] * yp;
      au = au + k.c[5] * xm;
      au = au + k.c[6] * xp;
      const T r = fv - au;
      acc += static_cast<double>(r * r);
      um = u0;
      u0 = up;
      up = un;
      fv = fn;
      un = un2;
      fn = fn2;
    }
  }
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0)
    partial[(static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] =
        acc;
}

// norm_partials_kernel: K13's second launch, one block.  out = the square
// root of the sum of the n partials, the sum rounded once to T and its root
// taken in T, as the plain torch.sqrt of a sum in T.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
norm_partials_kernel(const double* __restrict__ partial, int n, T* __restrict__ out) {
  __shared__ double sh[kSumThreads / 32];
  const double acc = partials_sum(partial, n, sh);
  if (threadIdx.x == 0) *out = sqrt(static_cast<T>(acc));
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

// K13's grid: a block a (kResTileY, kResTileX) tile of inner columns and a
// z-chunk of `chunk` inner planes; the wrapper sizes the partials to it.
inline dim3 res_norm_grid(int nz, int ny, int nx, int chunk) {
  return dim3((nx - 2 + kResTileX - 1) / kResTileX, (ny - 2 + kResTileY - 1) / kResTileY,
              (nz - 2 + chunk - 1) / chunk);
}

template <typename T>
cudaError_t launch_res_norm(const void* u, const void* f, const void* fz, const void* fy,
                            const void* fx, double* partial, void* out, int nz, int ny, int nx,
                            const double* coefs, int chunk, int blocks, cudaStream_t stream) {
  if (chunk < 1 || nz < 3 || ny < 3 || nx < 3) return cudaErrorInvalidValue;
  const bool faces = fz != nullptr;
  if (faces ? (fy == nullptr || fx == nullptr) : coefs == nullptr) return cudaErrorInvalidValue;
  const dim3 grid = res_norm_grid(nz, ny, nx, chunk);
  if (static_cast<int64_t>(grid.x) * grid.y * grid.z != blocks) return cudaErrorInvalidValue;
  const T* ut = static_cast<const T*>(u);
  const T* ft = static_cast<const T*>(f);
  if (faces)
    res_norm_kernel<T, true><<<grid, kSumThreads, 0, stream>>>(
        ut, ft, Star<T>{},
        Faces<T>{static_cast<const T*>(fz), static_cast<const T*>(fy), static_cast<const T*>(fx)},
        partial, nz, ny, nx, chunk);
  else
    res_norm_kernel<T, false><<<grid, kSumThreads, 0, stream>>>(
        ut, ft, make_star<T>(coefs), Faces<T>{}, partial, nz, ny, nx, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  norm_partials_kernel<T><<<1, kSumThreads, 0, stream>>>(partial, blocks, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers except
// coefs[7] (centre, z-, z+, y-, y+, x-, x+), a host array copied into the
// launch parameters; `chunk` is K9's or K13's inner z-planes of one block,
// `blocks` K10's or K13's first launch's blocks (and its partials,
// float64; K13's must be its grid's); `dtype` the fields' dtype code
// (star3d.cuh DType; an unknown one, and bfloat16 for K13, is
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

// K13: out = the l2 norm of f - A u over the inner nodes; A the star of
// coefs where face_z is null, else of the face arrays face_z, face_y,
// face_x (K11/K12's layout; coefs unused).
int exa_res_norm(const void* u, const void* f, const void* face_z, const void* face_y,
                 const void* face_x, void* partial, void* out, int nz, int ny, int nx,
                 const double* coefs, int chunk, int blocks, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(partial);
  switch (dtype) {
    case kFloat32:
      return static_cast<int>(launch_res_norm<float>(u, f, face_z, face_y, face_x, part, out, nz,
                                                     ny, nx, coefs, chunk, blocks, s));
    case kFloat64:
      return static_cast<int>(launch_res_norm<double>(u, f, face_z, face_y, face_x, part, out, nz,
                                                      ny, nx, coefs, chunk, blocks, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
