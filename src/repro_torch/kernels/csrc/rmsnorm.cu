// Fused RMSNorm forward for Hopper (sm_90a):
//   y = x * rsqrt(mean(x^2, -1) + eps) * gamma, reduced in f32, stored in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py::_rmsnorm_kernel.
//
// Bound: device-memory bytes.  The function reads x once and writes y once
// (gamma is d values, shared by every row); at about one multiply-add per
// byte it sits far below the card's operations-per-byte line.
//
// Design: one warp per row, four rows per block.  Each lane moves 16 bytes per
// load (4 f32 or 8 bf16) when d and the row starts allow it, sums squares in
// f32, and the warp reduces with shuffles, so no shared memory and no second
// launch.  The second pass re-reads the row, which the first pass has just
// brought into L1/L2, so device memory still sees x once.  Any row count is
// taken: the last block masks rows past the end (the TPU kernel instead
// halves its row tile until it divides the row count).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 4;

template <typename T, typename G, int VEC>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
rmsnorm_kernel(const T* __restrict__ x, const G* __restrict__ gamma, T* __restrict__ y,
               int rows, int d, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together: row is per warp
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;

  float ss = 0.f;
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    const Pack<T, VEC> a = *reinterpret_cast<const Pack<T, VEC>*>(xr + c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f32(a.v[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / (float)d + eps);

  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    const Pack<T, VEC> a = *reinterpret_cast<const Pack<T, VEC>*>(xr + c);
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      out.v[j] = from_f32<T>(to_f32(a.v[j]) * r * to_f32(gamma[c + j]));
    *reinterpret_cast<Pack<T, VEC>*>(yr + c) = out;
  }
}

template <typename T, typename G>
cudaError_t launch(const void* x, const void* g, void* y, int rows, int d, float eps,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(32 * kRowsPerBlock);
  const bool aligned = d % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (aligned)
    rmsnorm_kernel<T, G, kVec><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const G*>(g), static_cast<T*>(y), rows, d, eps);
  else
    rmsnorm_kernel<T, G, 1><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const G*>(g), static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: (rows, d) contiguous, same dtype; gamma: (d,) contiguous.
// Returns the launch's cudaError_t (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* gamma, void* y, int rows, int d,
                           float eps, int x_dtype, int g_dtype, int device, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (cudaError_t err = cudaSetDevice(device)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32 && g_dtype == kFloat32)
    return launch<float, float>(x, gamma, y, rows, d, eps, s);
  if (x_dtype == kFloat32 && g_dtype == kBFloat16)
    return launch<float, __nv_bfloat16>(x, gamma, y, rows, d, eps, s);
  if (x_dtype == kBFloat16 && g_dtype == kFloat32)
    return launch<__nv_bfloat16, float>(x, gamma, y, rows, d, eps, s);
  if (x_dtype == kBFloat16 && g_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, y, rows, d, eps, s);
  return cudaErrorInvalidValue;
}
