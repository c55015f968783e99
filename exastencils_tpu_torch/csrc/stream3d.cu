// The fused transfers for 3D radius-1 star stencils on Hopper (sm_90a),
// one launch each, with their wrappers, launch counts and plain versions in
// ops/cuda/stream3d.py:
//   K4 = exastencils_tpu/ops/pallas/stream3d.py:_down_kernel
//        residual + restriction (the down-leg tail where the legs decline,
//        e.g. Jacobi): one residual_restrict with no excl planes
//        (res_restrict)
//   K5 = exastencils_tpu/ops/pallas/stream3d.py:_up_kernel
//        prolongation + correction (the up-leg head): one prolong_correct
//        with no excl planes (prolong_correct)
// (K1-K3 are legs3d.cu's, K6-K8 cluster_legs3d.cu's.)  What bounds each
// kernel and what its design does about it is noted above the kernel.
//
// What the TPU kernels compute is kept exactly: the residual rhs - A sol
// with A's terms summed in the order centre, z-, z+, y-, y+, x-, x+
// (exastencils_tpu/ops/stencil_apply.apply_stencil), zero on boundary and
// excl planes; the Dirichlet ring and the excl planes never written;
// transfer taps outside the array dropped.  Built with --fmad=false, the
// residual arithmetic is bitwise that of the plain PyTorch path; only the
// order of the transfer sums differs from its banded matmuls.  K4/K5 were
// one pass each on the TPU, and are one launch each here; their y/x
// transfer is a direct stride-2 stencil where the TPU kernels used banded
// matrix products.

#include "star3d.cuh"

namespace {

using namespace exa;

constexpr int kBlock = 128;

template <typename T>
__device__ __forceinline__ T residual_at(const T* __restrict__ sol,
                                         const T* __restrict__ rhs, int z, int y,
                                         int x, int nz, int ny, int nx,
                                         const Star<T>& s, const Excl& e) {
  if (!updatable(z, y, x, nz, ny, nx, e)) return T(0);
  const int64_t sy = nx;
  const int64_t sz = static_cast<int64_t>(ny) * nx;
  const int64_t i = z * sz + y * sy + x;
  return rhs[i] - star_apply(sol + i - sz, sol + i, sol + i + sz, sy, s);
}

// residual_restrict: K4.  out[cz,cy,cx] = sum of
// wz*wy*wx * r(2c+lo+k) with r = rhs - A sol computed on the fly (zero on
// boundary and excl planes); the residual is never stored.
// Bound: meant to be device-memory bytes, reading sol and rhs once (~2
// array passes; the 27/8 redundant residual evaluations per fine point hit
// L1/L2), but the stride-2 loads and guarded taps keep it well below the
// stream rate (698 GB/s at 513^3 f32 on an H100).
// Design: one thread per coarse node, cx fastest; a direct stride-2
// stencil replaces the TPU kernel's banded MXU matmuls (ops/transfer.py).
// Sums run z innermost, then y, then x: the contraction order of the
// plain path's apply_separable.
template <typename T>
__global__ void residual_restrict(const T* __restrict__ sol,
                                  const T* __restrict__ rhs, T* __restrict__ out,
                                  int nz, int ny, int nx, int nzc, int nyc,
                                  int nxc, Star<T> s, Taps<T> t, Excl e) {
  const int cx = blockIdx.x * blockDim.x + threadIdx.x;
  const int cy = blockIdx.y;
  const int cz = blockIdx.z;
  if (cx >= nxc) return;
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
        const int z = 2 * cz + t.lo[0] + kz;
        if (kz >= t.n[0] || z < 0 || z >= nz) continue;
        acc_z = acc_z + t.w[0][kz] * residual_at(sol, rhs, z, y, x, nz, ny, nx, s, e);
      }
      acc_y = acc_y + t.w[1][ky] * acc_z;
    }
    acc_x = acc_x + t.w[2][kx] * acc_y;
  }
  out[(static_cast<int64_t>(cz) * nyc + cy) * nxc + cx] = acc_x;
}

// prolong_correct: K5.  sol += P sol_c on inner, non-excl
// nodes; each fine node sums its parity-matching coarse nodes (at most
// two per dim for windows of up to 3 taps).
// Bound: meant to be device-memory bytes (read and write sol once, read
// sol_c, 1/8 of an array), but 27 guarded taps with parity arithmetic per
// node make it instruction-bound (371 GB/s at 513^3 f32 on an H100).
// Design: one thread per fine node, x fastest, coalesced.
template <typename T>
__global__ void prolong_correct(T* __restrict__ sol, const T* __restrict__ solc,
                                int nz, int ny, int nx, int nzc, int nyc,
                                int nxc, Taps<T> t, Excl e) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int z = blockIdx.z;
  if (x >= nx || !updatable(z, y, x, nz, ny, nx, e)) return;
  const int64_t i = (static_cast<int64_t>(z) * ny + y) * nx + x;
  sol[i] = sol[i] + prolong_at(solc, z, y, x, nzc, nyc, nxc, t);
}

dim3 grid_for(int nx, int ny, int nz) {
  return dim3((nx + kBlock - 1) / kBlock, ny, nz);
}

template <typename T>
void launch_residual_restrict(const void* sol, const void* rhs, void* out,
                              int nz, int ny, int nx, int nzc, int nyc, int nxc,
                              const double* coefs, const double* taps,
                              const int* ntaps, const int* lo, const int* excl,
                              cudaStream_t stream) {
  residual_restrict<T><<<grid_for(nxc, nyc, nzc), kBlock, 0, stream>>>(
      static_cast<const T*>(sol), static_cast<const T*>(rhs),
      static_cast<T*>(out), nz, ny, nx, nzc, nyc, nxc, make_star<T>(coefs),
      make_taps<T>(taps, ntaps, lo), make_excl(excl));
}

template <typename T>
void launch_prolong_correct(void* sol, const void* solc, int nz, int ny, int nx,
                            int nzc, int nyc, int nxc, const double* taps,
                            const int* ntaps, const int* lo, const int* excl,
                            cudaStream_t stream) {
  prolong_correct<T><<<grid_for(nx, ny, nz), kBlock, 0, stream>>>(
      static_cast<T*>(sol), static_cast<const T*>(solc), nz, ny, nx, nzc, nyc,
      nxc, make_taps<T>(taps, ntaps, lo), make_excl(excl));
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers except
// coefs[7], taps[3*kMaxTaps], ntaps[3], lo[3] and excl[6], which are host
// arrays copied into the launch parameters.  Each entry launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" {

int exa_max_taps() { return kMaxTaps; }

const char* exa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int exa_residual_restrict(const void* sol, const void* rhs, void* out, int nz,
                          int ny, int nx, int nzc, int nyc, int nxc,
                          const double* coefs, const double* taps,
                          const int* ntaps, const int* lo, const int* excl,
                          int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    launch_residual_restrict<double>(sol, rhs, out, nz, ny, nx, nzc, nyc, nxc,
                                     coefs, taps, ntaps, lo, excl, s);
  else
    launch_residual_restrict<float>(sol, rhs, out, nz, ny, nx, nzc, nyc, nxc,
                                    coefs, taps, ntaps, lo, excl, s);
  return static_cast<int>(cudaGetLastError());
}

int exa_prolong_correct(void* sol, const void* solc, int nz, int ny, int nx,
                        int nzc, int nyc, int nxc, const double* taps,
                        const int* ntaps, const int* lo, const int* excl,
                        int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    launch_prolong_correct<double>(sol, solc, nz, ny, nx, nzc, nyc, nxc, taps,
                                   ntaps, lo, excl, s);
  else
    launch_prolong_correct<float>(sol, solc, nz, ny, nx, nzc, nyc, nxc, taps,
                                  ntaps, lo, excl, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
