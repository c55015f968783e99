// Device helpers shared by the 3D radius-1 star-stencil kernels
// (stream3d.cu, legs3d.cu, cluster_legs3d.cu):
// launch-parameter structs, the updatable
// test, the stencil application in the reference term order and the
// prolongation tap sum.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace exa {

// Transfer taps per dim.  The loops over them are unrolled to this bound so
// that the weights are read from the parameter bank: a loop with a runtime
// bound indexes the Taps struct dynamically, which copies it to local memory
// in every thread (on an H100 the transfers then ran at 216-356 GB/s).
constexpr int kMaxTaps = 3;

template <typename T>
struct Star {
  T c[7];  // centre, z-, z+, y-, y+, x-, x+
};

struct Excl {
  int p[6];  // z lo, z hi, y lo, y hi, x lo, x hi; -1 = none
};

template <typename T>
struct Taps {
  T w[3][kMaxTaps];  // per dim (z, y, x)
  int n[3];
  int lo[3];
};

__device__ __forceinline__ bool updatable(int z, int y, int x, int nz, int ny,
                                          int nx, const Excl& e) {
  return z >= 1 && z <= nz - 2 && y >= 1 && y <= ny - 2 && x >= 1 &&
         x <= nx - 2 && z != e.p[0] && z != e.p[1] && y != e.p[2] &&
         y != e.p[3] && x != e.p[4] && x != e.p[5];
}

// A*u at one inner node, one rounding per operation in the reference order
// (exastencils_tpu/ops/stencil_apply.apply_stencil).  zm, b, zp point at
// the node in planes z-1, z, z+1; sy is the row stride within a plane.
template <typename T>
__device__ __forceinline__ T star_apply(const T* zm, const T* b, const T* zp,
                                        int64_t sy, const Star<T>& s) {
  T out = s.c[0] * b[0];
  out = out + s.c[1] * zm[0];
  out = out + s.c[2] * zp[0];
  out = out + s.c[3] * b[-sy];
  out = out + s.c[4] * b[sy];
  out = out + s.c[5] * b[-1];
  out = out + s.c[6] * b[1];
  return out;
}

// (P sol_c) at fine node (z, y, x): each fine node sums its parity-matching
// coarse nodes (at most two per dim for windows of up to 3 taps), z
// innermost, then y, then x.
template <typename T>
__device__ __forceinline__ T prolong_at(const T* __restrict__ solc, int z, int y,
                                        int x, int nzc, int nyc, int nxc,
                                        const Taps<T>& t) {
  T acc_x = T(0);
#pragma unroll
  for (int kx = 0; kx < kMaxTaps; ++kx) {
    const int numx = x - t.lo[2] - kx;
    const int cx = numx / 2;
    if (kx >= t.n[2] || numx % 2 != 0 || cx < 0 || cx >= nxc) continue;
    T acc_y = T(0);
#pragma unroll
    for (int ky = 0; ky < kMaxTaps; ++ky) {
      const int numy = y - t.lo[1] - ky;
      const int cy = numy / 2;
      if (ky >= t.n[1] || numy % 2 != 0 || cy < 0 || cy >= nyc) continue;
      T acc_z = T(0);
#pragma unroll
      for (int kz = 0; kz < kMaxTaps; ++kz) {
        const int numz = z - t.lo[0] - kz;
        const int cz = numz / 2;
        if (kz >= t.n[0] || numz % 2 != 0 || cz < 0 || cz >= nzc) continue;
        acc_z = acc_z + t.w[0][kz] * solc[(static_cast<int64_t>(cz) * nyc + cy) * nxc + cx];
      }
      acc_y = acc_y + t.w[1][ky] * acc_z;
    }
    acc_x = acc_x + t.w[2][kx] * acc_y;
  }
  return acc_x;
}

template <typename T>
inline Star<T> make_star(const double* coefs) {
  Star<T> s;
  for (int k = 0; k < 7; ++k) s.c[k] = static_cast<T>(coefs[k]);
  return s;
}

template <typename T>
inline Taps<T> make_taps(const double* w, const int* n, const int* lo) {
  Taps<T> t;
  for (int d = 0; d < 3; ++d) {
    t.n[d] = n[d];
    t.lo[d] = lo[d];
    for (int k = 0; k < kMaxTaps; ++k) t.w[d][k] = static_cast<T>(w[d * kMaxTaps + k]);
  }
  return t;
}

inline Excl make_excl(const int* excl) {
  Excl e;
  for (int k = 0; k < 6; ++k) e.p[k] = excl[k];
  return e;
}

}  // namespace exa
