// Mamba2 SSD intra-chunk block for Hopper (sm_90a), all arithmetic in f32:
//   scores[q, u] = C_q . B_u
//   w[q, u, h]   = scores[q, u] * exp(cum[q, h] - cum[u, h])   for u <= q, else 0
//   y[q, h, :]   = sum_u w[q, u, h] * dt[u, h] * x[u, h, :]
// per (batch*chunk), with y stored in f32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py::_intra_kernel.
//
// Bound: at the serving shape of mamba2-1.3b (64 batch-chunks of Q = 64, 64
// heads of 64, d_state 128, x/B/C in bf16) the function reads 35 MB and writes
// a 67 MB f32 y, and does about 1.2 GFLOP over the causal half of each Q x Q
// tile: 31 us of device-memory bytes against 17 us of f32 CUDA-core work, so
// it is bound by bytes (the f32 output is two thirds of them).
//
// Design:
// * The TPU kernel runs one (batch*chunk) per grid step and loops over all
//   heads, keeping the Q x Q score tile in VMEM.  Here a block owns one
//   batch-chunk and a group of heads (the wrapper sizes the group so that
//   about four blocks per SM are in flight): it computes the score tile C.B^T
//   once into shared memory, staging C and B 32 state columns at a time, and
//   reuses it for every head of its group.
// * Per head the block builds w in shared memory and multiplies it by x*dt
//   (also staged as f32); each thread accumulates a 4 x 4 tile of y in
//   registers, reading w and x*dt 16 bytes at a time.
// * Mask before multiplying: for u > q, exp(cum_q - cum_u) has a positive
//   exponent and can overflow to inf, and inf * 0 is NaN.  Such entries are
//   never exponentiated: w is written as 0 there (the TPU kernel selects with
//   jnp.where).  The product loop stops at the tile's last row, so u > q is
//   skipped, and score tiles wholly above the diagonal are never computed.
// * Any Q <= 128, head_dim <= 128 and d_state <= 512; rows and columns are
//   padded to multiples of 4 with zeros in shared memory, and only real ones
//   are stored.  Inputs are read through their element strides, so the model's
//   slices of its projection pass without a copy.  Shared memory is sized at
//   launch (about 53 KB at Q = 64, head_dim 64).
// * Later work: bf16 tensor cores (mma.sync / wgmma) for both products, TMA
//   loads, and storing y in the model dtype to halve the bytes.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStateChunk = 32;            // state columns of C and B staged at a time
constexpr int kStageLd = kStateChunk + 1;  // padded row of the staging tiles
constexpr int kMaxQ = 128;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxState = 512;

struct SsdArgs {
  int Q, nh, hd, st, heads_per_block;
  long long xs[4];    // x (bc, Q, nh, hd)
  long long dts[3];   // dt (bc, Q, nh)
  long long cums[3];  // cum (bc, Q, nh)
  long long bs[3];    // B (bc, Q, st)
  long long cs[3];    // C (bc, Q, st)
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Shared-memory floats: S, then (staging C and B | w and x*dt), then cum and dt.
__host__ inline size_t smem_floats(int Q, int hd) {
  const int qp = round4(Q), ld = qp + 4, hdx = round4(hd) + 4;
  const size_t stage = 2 * (size_t)qp * kStageLd;
  const size_t heads = (size_t)qp * ld + (size_t)qp * hdx;
  return (size_t)qp * ld + (stage > heads ? stage : heads) + 2 * (size_t)qp;
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ y, SsdArgs a) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int Q = a.Q, qp = round4(Q), ld = qp + 4;
  const int hdp = round4(a.hd), hdx = hdp + 4;
  float* S = smem;                          // (qp, ld) scores C.B^T
  float* R = S + (size_t)qp * ld;           // union region
  float* Cs = R;                            // (qp, kStageLd) staged C columns
  float* Bs = R + (size_t)qp * kStageLd;    // (qp, kStageLd) staged B columns
  float* W = R;                             // (qp, ld) w of one head
  float* X = R + (size_t)qp * ld;           // (qp, hdx) x*dt of one head
  const size_t stage = 2 * (size_t)qp * kStageLd, heads = (size_t)qp * ld + (size_t)qp * hdx;
  float* cumh = R + (stage > heads ? stage : heads);  // (qp,)
  float* dth = cumh + qp;                             // (qp,)

  const int tid = threadIdx.x;
  const long long bc = blockIdx.x;
  const int qt = qp / 4;  // 4-row tiles

  // -- scores: S[q][u] = sum_s C[q, s] B[u, s], tiles on or below the diagonal
  for (int i = tid; i < qp * ld; i += kThreads) S[i] = 0.f;
  for (int s0 = 0; s0 < a.st; s0 += kStateChunk) {
    __syncthreads();  // S zeroed / the previous chunk's products done
    for (int i = tid; i < qp * kStateChunk; i += kThreads) {
      const int q = i / kStateChunk, s = i % kStateChunk;
      const bool in = q < Q && s0 + s < a.st;
      Cs[q * kStageLd + s] =
          in ? to_f32(Cm[bc * a.cs[0] + q * a.cs[1] + (s0 + s) * a.cs[2]]) : 0.f;
      Bs[q * kStageLd + s] =
          in ? to_f32(Bm[bc * a.bs[0] + q * a.bs[1] + (s0 + s) * a.bs[2]]) : 0.f;
    }
    __syncthreads();
    for (int t = tid; t < qt * qt; t += kThreads) {
      const int tr = t / qt, tc = t % qt;
      if (tc > tr) continue;  // every u of the tile is past every q
      float acc[4][4] = {};
      for (int s = 0; s < kStateChunk; ++s) {
        float cq[4], bu[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cq[i] = Cs[(4 * tr + i) * kStageLd + s];
          bu[i] = Bs[(4 * tc + i) * kStageLd + s];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cq[i], bu[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) S[(4 * tr + i) * ld + 4 * tc + j] += acc[i][j];
    }
  }

  // -- per head of the block's group: w, then y = w @ (x*dt)
  const int h_begin = blockIdx.y * a.heads_per_block;
  const int h_end = min(h_begin + a.heads_per_block, a.nh);
  const int dtiles = hdp / 4;
  const bool vec_store = a.hd % 4 == 0;
  for (int h = h_begin; h < h_end; ++h) {
    __syncthreads();  // S complete / the previous head's products done
    for (int q = tid; q < qp; q += kThreads) {
      const bool in = q < Q;
      cumh[q] = in ? cum[bc * a.cums[0] + q * a.cums[1] + h * a.cums[2]] : 0.f;
      dth[q] = in ? dt[bc * a.dts[0] + q * a.dts[1] + h * a.dts[2]] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < qp * qp; i += kThreads) {
      const int q = i / qp, u = i % qp;
      // masked entries are written, never exponentiated
      W[q * ld + u] = (q < Q && u <= q) ? S[q * ld + u] * expf(cumh[q] - cumh[u]) : 0.f;
    }
    for (int i = tid; i < qp * hdp; i += kThreads) {
      const int u = i / hdp, d = i % hdp;
      X[u * hdx + d] = (u < Q && d < a.hd)
          ? to_f32(x[bc * a.xs[0] + u * a.xs[1] + h * a.xs[2] + d * a.xs[3]]) * dth[u]
          : 0.f;
    }
    __syncthreads();
    for (int t = tid; t < qt * dtiles; t += kThreads) {
      const int tr = t / dtiles, tc = t % dtiles;
      const int q0 = 4 * tr, d0 = 4 * tc;
      float acc[4][4] = {};
      for (int u0 = 0; u0 <= q0; u0 += 4) {  // w is 0 past the diagonal: u > q0 + 3 skipped
        float4 wr[4], xr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wr[i] = *reinterpret_cast<const float4*>(W + (q0 + i) * ld + u0);
          xr[i] = *reinterpret_cast<const float4*>(X + (u0 + i) * hdx + d0);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fma4(acc[i], wr[i].x, xr[0]);
          fma4(acc[i], wr[i].y, xr[1]);
          fma4(acc[i], wr[i].z, xr[2]);
          fma4(acc[i], wr[i].w, xr[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + i;
        if (q >= Q) break;
        float* yr = y + (((size_t)bc * Q + q) * a.nh + h) * a.hd;
        if (vec_store) {
          *reinterpret_cast<float4*>(yr + d0) = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                                            acc[i][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (d0 + j < a.hd) yr[d0 + j] = acc[i][j];
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* cum, const void* B,
                   const void* C, float* y, int bc, const SsdArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_floats(a.Q, a.hd) * sizeof(float);
  if (cudaError_t err = cudaFuncSetAttribute(
          ssd_intra_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes))
    return err;
  const dim3 grid(bc, (a.nh + a.heads_per_block - 1) / a.heads_per_block);
  ssd_intra_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, cum, static_cast<const T*>(B), static_cast<const T*>(C), y,
      a);
  return cudaGetLastError();
}

}  // namespace

// x (bc, Q, nh, hd), B and C (bc, Q, st) in `dtype`; dt and cum (bc, Q, nh) f32;
// all read through the 16 element strides in `strides` (x 4, dt 3, cum 3, B 3,
// C 3).  y (bc, Q, nh, hd) f32, contiguous.  Returns the launch's cudaError_t.
extern "C" int ssd_intra_chunk(const void* x, const float* dt, const float* cum, const void* B,
                               const void* C, float* y, int bc, int Q, int nh, int hd, int st,
                               int heads_per_block, const long long* strides, int dtype,
                               int device, void* stream) {
  if (bc == 0 || Q == 0 || nh == 0 || hd == 0) return cudaSuccess;
  if (Q < 0 || Q > kMaxQ || hd < 0 || hd > kMaxHeadDim || st < 1 || st > kMaxState ||
      nh < 0 || heads_per_block < 1)
    return cudaErrorInvalidValue;
  if (cudaError_t err = cudaSetDevice(device)) return err;
  SsdArgs a{Q, nh, hd, st, heads_per_block, {}, {}, {}, {}, {}};
  for (int i = 0; i < 4; ++i) a.xs[i] = strides[i];
  for (int i = 0; i < 3; ++i) {
    a.dts[i] = strides[4 + i];
    a.cums[i] = strides[7 + i];
    a.bs[i] = strides[10 + i];
    a.cs[i] = strides[13 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(x, dt, cum, B, C, y, bc, a, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, dt, cum, B, C, y, bc, a, s);
  return cudaErrorInvalidValue;
}
