// Coded combine of gradient coding for Hopper (sm_90a):
//   out[d] = sum_k w[k] * parts[k, d], accumulated in f32, stored in the parts' dtype.
// It is the GC encode (k = s+1 chunk gradients per worker), the survivor-weighted
// decode (k = survivors) and the M-SGC group task (k = lam+1).
//
// Replaces the TPU kernel src/repro/kernels/gc_coding/gc_coding.py::_combine_kernel.
//
// Bound: device-memory bytes.  The function reads parts once (k * D values) and
// writes out once (D values); it does 2 operations per value read, far below
// the card's operations-per-byte line.
//
// Design: each thread owns one run of VEC elements of D (16 bytes when the row
// length and the pointers allow it, else 8, 4 or 2 bytes, else one element) and
// loops over the k rows, so each row is streamed once with coalesced loads and
// the k-way sum stays in registers.  The weights are staged in shared memory,
// kWTile at a time, so any k is taken.  The TPU kernel pads D to a multiple of
// 128 and tiles it by block_d; here the last block masks the ragged tail
// instead, and nothing is padded or copied.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWTile = kThreads;  // weights staged per pass, one per thread

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
coded_combine_kernel(const T* __restrict__ parts, const float* __restrict__ w,
                     T* __restrict__ out, int k, long long d) {
  __shared__ float ws[kWTile];
  const long long nvec = d / VEC;
  const long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool ok = v < nvec;  // no early return: every thread stages weights
  const T* col = parts + v * VEC;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  for (int j0 = 0; j0 < k; j0 += kWTile) {
    const int nj = min(kWTile, k - j0);
    __syncthreads();  // the previous tile of weights is consumed
    if (threadIdx.x < nj) ws[threadIdx.x] = w[j0 + threadIdx.x];
    __syncthreads();
    if (!ok) continue;
#pragma unroll 4
    for (int j = 0; j < nj; ++j) {
      const Pack<T, VEC> a =
          *reinterpret_cast<const Pack<T, VEC>*>(col + (long long)(j0 + j) * d);
      const float wj = ws[j];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wj, to_f32(a.v[e]), acc[e]);
    }
  }
  if (!ok) return;
  Pack<T, VEC> o;
#pragma unroll
  for (int e = 0; e < VEC; ++e) o.v[e] = from_f32<T>(acc[e]);
  *reinterpret_cast<Pack<T, VEC>*>(out + v * VEC) = o;
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* parts, const float* w, void* out, int k, long long d,
                       cudaStream_t stream) {
  const long long nvec = d / VEC;
  const long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  coded_combine_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(parts), w, static_cast<T*>(out), k, d);
  return cudaGetLastError();
}

// The widest run of VEC elements (at most 16 bytes) that divides d and keeps
// every row start and the output aligned to the run's size.
template <typename T>
cudaError_t launch(const void* parts, const float* w, void* out, int k, long long d,
                   cudaStream_t stream) {
  auto fits = [&](int vec) {
    const uintptr_t bytes = vec * sizeof(T);
    return d % vec == 0 && reinterpret_cast<uintptr_t>(parts) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(out) % bytes == 0;
  };
  if constexpr (sizeof(T) == 2) {
    if (fits(8)) return launch_vec<T, 8>(parts, w, out, k, d, stream);
  }
  if (fits(4)) return launch_vec<T, 4>(parts, w, out, k, d, stream);
  if (fits(2)) return launch_vec<T, 2>(parts, w, out, k, d, stream);
  return launch_vec<T, 1>(parts, w, out, k, d, stream);
}

}  // namespace

// parts: (k, d) contiguous; w: (k,) f32 contiguous; out: (d,) contiguous, parts' dtype.
// Returns the launch's cudaError_t (0 on success).
extern "C" int gc_coded_combine(const void* parts, const float* w, void* out, int k,
                                long long d, int dtype, int device, void* stream) {
  if (d == 0) return cudaSuccess;
  if (k <= 0) return cudaErrorInvalidValue;
  if (cudaError_t err = cudaSetDevice(device)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(parts, w, out, k, d, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(parts, w, out, k, d, s);
  return cudaErrorInvalidValue;
}
