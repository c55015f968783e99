// Device helpers shared by the 3D radius-1 star-stencil kernels
// (stream3d.cu, legs3d.cu, cluster_legs3d.cu):
// launch-parameter structs, the coarse taps of one fine index, the
// asynchronous copies into shared memory, and the field types.
//
// Field types: float32, float64 and bfloat16 (dtype codes 0, 1, 2 in every
// exa_* entry, which rejects any other).  The bfloat16 rounding contract,
// which the plain versions in ops/cuda/stream3d.py keep too:
// - storage is bfloat16 (T = __nv_bfloat16);
// - inside one node update (the star stencil, the residual, a transfer tap
//   sum) the arithmetic is float32 (compute_t<T>), built with --fmad=false
//   as the float32 kernels are;
// - a value is rounded to bfloat16 (to nearest even, as torch's
//   .to(torch.bfloat16)) once, where the kernel stores it: each
//   half-sweep's new value, each residual value, each coarse value and each
//   corrected fine value.  The z-sums of a transfer stay float32.
// The shared-memory rings hold the compute type: a value stored there is
// rounded and widened back (round_stored), a value from device memory
// widened on the way in (load_shared: a synchronous load, since cp.async
// copies 4, 8 or 16 bytes and a 4-byte pair of bfloat16 nodes straddles the
// two colours of a colour-split plane, unaligned at odd row lengths).  So a
// bfloat16 launch takes float32's shared memory and chains.  For float and
// double the compute type is the storage type and every conversion is the
// identity: those kernels compute what they did before bfloat16 existed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace exa {

enum DType { kFloat32 = 0, kFloat64 = 1, kBFloat16 = 2 };

template <typename T>
struct Compute {
  using type = T;
};
template <>
struct Compute<__nv_bfloat16> {
  using type = float;
};
template <typename T>
using compute_t = typename Compute<T>::type;

// Calls f(static_cast<T*>(nullptr)) for the storage type T of dtype code
// `dtype` and returns its result; `bad` for an unknown code.
template <typename R, typename F>
R with_dtype(int dtype, R bad, F f) {
  switch (dtype) {
    case kFloat32:
      return f(static_cast<float*>(nullptr));
    case kFloat64:
      return f(static_cast<double*>(nullptr));
    case kBFloat16:
      return f(static_cast<__nv_bfloat16*>(nullptr));
    default:
      return bad;
  }
}

// A stored value in the compute type (exact).
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

// A compute-type value in the storage type: rounded to nearest even for
// bfloat16, unchanged otherwise.
template <typename T>
__device__ __forceinline__ T narrow(compute_t<T> v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A value rounded where it is stored, kept in the compute type.
template <typename T>
__device__ __forceinline__ compute_t<T> round_stored(compute_t<T> v) {
  return widen(narrow<T>(v));
}

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

__device__ __host__ __forceinline__ int floor_half(int a) { return a >= 0 ? a / 2 : -((1 - a) / 2); }

// One value from device memory into shared memory, asynchronously; an
// invalid source fills the destination with zeros and reads nothing.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)), "r"(valid ? static_cast<int>(sizeof(T)) : 0));
}

// One value of a field into a compute-type slot of shared memory:
// cp_async where the two types agree, else a synchronous load, widened (an
// invalid source gives zero).
template <typename T>
__device__ __forceinline__ void load_shared(compute_t<T>* dst, const T* src, bool valid) {
  if constexpr (std::is_same_v<T, compute_t<T>>)
    cp_async(dst, src, valid);
  else
    *dst = valid ? widen(*src) : compute_t<T>(0);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The (at most two, for kMaxTaps = 3) coarse nodes that fine index f
// prolongs from along one dim: taps k0 and k0 + 2 with k0 = (f - lo) % 2,
// in increasing tap order (c0: tap k0's coarse index; tap k0 + 2's is
// c0 - 1).  Weights are picked by select, never by a runtime index into
// Taps (see kMaxTaps).
template <typename T>
struct TapPair {
  int c0;
  bool v0, v1;
  T w0, w1;
};

template <typename T>
__device__ __forceinline__ TapPair<T> tap_pair(int f, int nc, const T* w, int n, int lo) {
  TapPair<T> p;
  const int k0 = (f - lo) & 1;
  p.c0 = (f - lo - k0) >> 1;
  p.v0 = k0 < n && p.c0 >= 0 && p.c0 < nc;
  p.v1 = k0 == 0 && n > 2 && p.c0 >= 1 && p.c0 - 1 < nc;
  p.w0 = k0 ? w[1] : w[0];
  p.w1 = w[2];
  return p;
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
