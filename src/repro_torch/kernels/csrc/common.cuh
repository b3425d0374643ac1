// Shared helpers of the port's CUDA kernels: dtype codes and f32 conversions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Dtype codes passed from Python (repro_torch/kernels/_build.py DTYPE_CODES).
enum DtypeCode : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC elements of T moved as one aligned load or store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// How the f32 attention kernels (flash_attention.cu, flash_attention_bwd.cu)
// split a row of DH columns: kThreads neighbouring threads, a power of two so
// that their partial dot products meet by xor shuffles, each owning kRuns runs
// of 4 columns, run r of thread `sub` at columns (r * kThreads + sub) * 4.  Head
// dims that are multiples of 32 take DH / 32 threads of 8 runs; 80 takes 4
// threads of 5 runs.
template <int DH>
struct RowSplit {
  static constexpr int kThreads = DH % 32 == 0 ? DH / 32 : 4;
  static constexpr int kRuns = DH / (4 * kThreads);
  static_assert(DH == 4 * kThreads * kRuns, "a row must split into whole runs of 4");
};
