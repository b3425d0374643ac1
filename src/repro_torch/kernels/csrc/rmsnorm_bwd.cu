// RMSNorm backward for Hopper (sm_90a).  With r = rsqrt(mean(x^2) + eps) per row
// and y = x * r * gamma:
//   dx     = r * gamma * dy - x * r^3 * sum(x * gamma * dy) / d
//   dgamma = sum over rows of dy * x * r
// Every reduction is in f32, whatever the dtype of x, gamma and dy.
//
// Replaces the backward of the TPU kernel
// src/repro/kernels/rmsnorm/rmsnorm.py::_rmsnorm_kernel, which has none: the
// JAX package differentiates its jnp reference instead.
//
// Bound: device-memory bytes.  The function reads x and dy and writes dx
// (gamma and dgamma are d values each); a few operations per byte.
//
// Design, three launches:
// * rmsnorm_bwd_dx: one warp per row, four rows per block, as the forward.  One
//   pass sums x^2 and x*gamma*dy together (16-byte loads when d allows), the
//   warp reduces them with shuffles, and a second pass over the row (now in
//   L1/L2) writes dx.  The row's r goes to a small f32 buffer.
// * rmsnorm_bwd_dgamma_partial: a block owns 32 columns and one slab of rows;
//   its 8 warps walk the slab's rows (each warp reading 32 neighbouring columns
//   of one row, coalesced) and meet in shared memory.  One partial sum per
//   (slab, column) goes to a scratch buffer.
// * rmsnorm_bwd_dgamma_final: sums the slabs' partials of each column in a
//   fixed order.  No float atomics anywhere, so the result is deterministic.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kColTile = 32;   // columns per block of the dgamma partial
constexpr int kRowWarps = 8;   // warps per block of the dgamma partial

template <typename T, typename G, int VEC>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
rmsnorm_bwd_dx_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                      const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ rstd,
                      int rows, int d, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + (size_t)row * d;
  const T* dyr = dy + (size_t)row * d;
  T* dxr = dx + (size_t)row * d;

  float ss = 0.f, sgd = 0.f;
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    const Pack<T, VEC> a = *reinterpret_cast<const Pack<T, VEC>*>(xr + c);
    const Pack<T, VEC> g = *reinterpret_cast<const Pack<T, VEC>*>(dyr + c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xv = to_f32(a.v[j]);
      ss += xv * xv;
      sgd += xv * to_f32(gamma[c + j]) * to_f32(g.v[j]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
    sgd += __shfl_xor_sync(0xffffffffu, sgd, o);
  }
  const float r = rsqrtf(ss / (float)d + eps);
  const float coef = r * r * r * sgd / (float)d;
  if (lane == 0) rstd[row] = r;

  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    const Pack<T, VEC> a = *reinterpret_cast<const Pack<T, VEC>*>(xr + c);
    const Pack<T, VEC> g = *reinterpret_cast<const Pack<T, VEC>*>(dyr + c);
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      out.v[j] = from_f32<T>(r * to_f32(gamma[c + j]) * to_f32(g.v[j]) - to_f32(a.v[j]) * coef);
    *reinterpret_cast<Pack<T, VEC>*>(dxr + c) = out;
  }
}

// partial[slab, c] = sum over the slab's rows of dy * x * r
template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
rmsnorm_bwd_dgamma_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                  const float* __restrict__ rstd, float* __restrict__ partial,
                                  int rows, int d, int rows_per_slab) {
  __shared__ float acc_s[kRowWarps][kColTile];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * kColTile + lane;
  const int slab = blockIdx.y;
  const int r0 = slab * rows_per_slab;
  const int r1 = min(rows, r0 + rows_per_slab);
  float acc = 0.f;
  if (c < d) {
    for (int r = r0 + warp; r < r1; r += kRowWarps) {
      const size_t i = (size_t)r * d + c;
      acc += to_f32(dy[i]) * to_f32(x[i]) * rstd[r];
    }
  }
  acc_s[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < d) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) s += acc_s[w][lane];
    partial[(size_t)slab * d + c] = s;
  }
}

template <typename G>
__global__ void rmsnorm_bwd_dgamma_final_kernel(const float* __restrict__ partial,
                                                G* __restrict__ dgamma, int slabs, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int k = 0; k < slabs; ++k) s += partial[(size_t)k * d + c];
  dgamma[c] = from_f32<G>(s);
}

template <typename T, typename G>
cudaError_t launch(const void* x, const void* g, const void* dy, void* dx, void* dg,
                   float* rstd, float* partial, int rows, int d, int slabs, float eps,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const bool aligned = d % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const G* gt = static_cast<const G*>(g);
  if (rows == 0) {
    // no rows: dx is empty and the partials below come out 0
  } else if (aligned) {
    rmsnorm_bwd_dx_kernel<T, G, kVec><<<grid, 32 * kRowsPerBlock, 0, stream>>>(
        xt, gt, dyt, static_cast<T*>(dx), rstd, rows, d, eps);
  } else {
    rmsnorm_bwd_dx_kernel<T, G, 1><<<grid, 32 * kRowsPerBlock, 0, stream>>>(
        xt, gt, dyt, static_cast<T*>(dx), rstd, rows, d, eps);
  }
  if (cudaError_t err = cudaGetLastError()) return err;

  const int rows_per_slab = rows == 0 ? 0 : (rows + slabs - 1) / slabs;
  const dim3 pgrid((d + kColTile - 1) / kColTile, slabs);
  rmsnorm_bwd_dgamma_partial_kernel<T><<<pgrid, 32 * kRowWarps, 0, stream>>>(
      xt, dyt, rstd, partial, rows, d, rows_per_slab);
  if (cudaError_t err = cudaGetLastError()) return err;

  rmsnorm_bwd_dgamma_final_kernel<G><<<(d + 255) / 256, 256, 0, stream>>>(
      partial, static_cast<G*>(dg), slabs, d);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx: (rows, d) contiguous, one dtype; gamma, dgamma: (d,) contiguous, one
// dtype; rstd: (rows,) f32 scratch; partial: (slabs, d) f32 scratch.  Each of the
// slabs sums ceil(rows / slabs) rows.  Returns the first launch error (0 on success).
extern "C" int rmsnorm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                           void* dgamma, float* rstd, float* partial, int rows, int d,
                           int slabs, float eps, int x_dtype, int g_dtype, int device,
                           void* stream) {
  if (d == 0) return cudaSuccess;
  if (slabs <= 0) return cudaErrorInvalidValue;
  if (cudaError_t err = cudaSetDevice(device)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32 && g_dtype == kFloat32)
    return launch<float, float>(x, gamma, dy, dx, dgamma, rstd, partial, rows, d, slabs, eps, s);
  if (x_dtype == kFloat32 && g_dtype == kBFloat16)
    return launch<float, __nv_bfloat16>(x, gamma, dy, dx, dgamma, rstd, partial, rows, d,
                                        slabs, eps, s);
  if (x_dtype == kBFloat16 && g_dtype == kFloat32)
    return launch<__nv_bfloat16, float>(x, gamma, dy, dx, dgamma, rstd, partial, rows, d,
                                        slabs, eps, s);
  if (x_dtype == kBFloat16 && g_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, dy, dx, dgamma, rstd, partial, rows,
                                                d, slabs, eps, s);
  return cudaErrorInvalidValue;
}
