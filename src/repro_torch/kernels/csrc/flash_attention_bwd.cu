// Blocked (flash) GQA attention backward for Hopper (sm_90a), FA2-style, in f32.
//
// Given q, k, v, the forward's output o, its row log-sum-exp lse and dO:
//   p = exp(scale * q.k - lse)            (0 where masked)
//   D = rowsum(dO * o)
//   dV = p^T dO,  dP = dO v^T,  dS = p * (dP - D),
//   dQ = scale * dS k,  dK = scale * dS^T q.
//
// Replaces the backward of the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::_attn_kernel, which has
// none: the JAX package differentiates its jnp path instead (ROADMAP C-2).
//
// Bound: at the training shapes of the slice (128 sequences of 64 tokens, 14
// q-heads and 2 kv-heads of 64, bf16) the function moves ~30 MB and does ~2.5
// GFLOP of products, so against the tensor-core peak it is bound by device-memory
// bytes.  Like the forward, this first kernel does its products on the CUDA
// cores in f32, so the FMA rate and the shared-memory reads bound it in
// practice; mma.sync/wgmma is later work.
//
// Design, two launches:
// * attn_bwd_dq: one block per (batch, q-head, 64-row q tile), with the
//   forward's thread layout: a query row belongs to DH/32 neighbouring threads,
//   each owning 32 of its elements in runs of 4.  The block computes D for its
//   rows (and stores it for the second launch), then walks the kv tiles of 32
//   keys that the causal / window band and valid_k leave, staged in shared
//   memory as f32, recomputing p from lse key by key and accumulating dQ in
//   registers.
// * attn_bwd_dkdv: one block per (batch, kv-head, 64-key tile); a key row is
//   owned the same way and keeps its k, v, dK and dV in registers.  The block
//   walks every q-head of its GQA group and the q tiles of 32 rows in the band,
//   staging q, dO, lse and D in shared memory.  The group's sum lands in one
//   block, so no atomics are needed and the result is deterministic.
// * Both take (batch, head, seq) strides with a contiguous last dim, as the
//   forward does, and skip tiles that lie wholly outside the band.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;   // dq: query rows per block
constexpr int kBlockK = 32;   // dq: keys per staged kv tile
constexpr int kBlockKV = 64;  // dkdv: keys per block
constexpr int kTileQ = 32;    // dkdv: query rows per staged q tile
constexpr int kRuns = 8;      // runs of 4 elements a thread owns: 8 * 4 = 32

struct Strides {
  long long b, h, s;
};

struct BwdArgs {
  int hq, hkv, sq, sk, causal, window, valid_k;
  float scale;
  Strides q, k, v, o, dout, dq, dk, dv;
};

__device__ __forceinline__ bool allowed(const BwdArgs& a, int qpos, int kpos) {
  bool ok = qpos < a.sq && kpos < a.valid_k;
  if (a.causal) ok = ok && qpos >= kpos;
  if (a.window > 0) ok = ok && qpos - kpos < a.window;
  return ok;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kBlockQ * (DH / 32))
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ o, const T* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   T* __restrict__ dq, const BwdArgs a) {
  constexpr int TPR = DH / 32;  // threads per query row
  __shared__ __align__(16) float ks[kBlockK][DH];
  __shared__ __align__(16) float vs[kBlockK][DH];

  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kh = h / (a.hq / a.hkv);
  const int q0 = qt * kBlockQ;
  const int qpos = q0 + tid / TPR;
  const bool row_ok = qpos < a.sq;

  float qr[kRuns][4], dor[kRuns][4], acc[kRuns][4];
  const T* qp = q + bi * a.q.b + h * a.q.h + (long long)qpos * a.q.s;
  const T* op = o + bi * a.o.b + h * a.o.h + (long long)qpos * a.o.s;
  const T* dp = dout + bi * a.dout.b + h * a.dout.h + (long long)qpos * a.dout.s;
  float dsum = 0.f;
#pragma unroll
  for (int r = 0; r < kRuns; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = (r * TPR + sub) * 4 + e;
      qr[r][e] = row_ok ? to_f32(qp[c]) : 0.f;
      dor[r][e] = row_ok ? to_f32(dp[c]) : 0.f;
      dsum += row_ok ? dor[r][e] * to_f32(op[c]) : 0.f;
      acc[r][e] = 0.f;
    }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
  const long long row = ((long long)bi * a.hq + h) * a.sq + qpos;
  const float row_lse = row_ok ? lse[row] : INFINITY;
  if (row_ok && sub == 0) delta[row] = dsum;

  // kv tiles that can hold an unmasked key for some row of this q tile
  const int q_last = min(q0 + kBlockQ, a.sq) - 1;
  int kv_end = a.valid_k;
  if (a.causal) kv_end = min(kv_end, q_last + 1);
  int kv_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kv_begin = kv_begin / kBlockK * kBlockK;

  const T* kb = k + bi * a.k.b + kh * a.k.h;
  const T* vb = v + bi * a.v.b + kh * a.v.h;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBlockK * DH; i += blockDim.x) {
      const int j = i / DH, c = i % DH, kp = k0 + j;
      const bool ok = kp < kv_end;
      ks[j][c] = ok ? to_f32(kb[kp * a.k.s + c]) : 0.f;
      vs[j][c] = ok ? to_f32(vb[kp * a.v.s + c]) : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < kBlockK; ++j) {
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int r = 0; r < kRuns; ++r) {
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[j][(r * TPR + sub) * 4]);
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[j][(r * TPR + sub) * 4]);
        s += qr[r][0] * k4.x + qr[r][1] * k4.y + qr[r][2] * k4.z + qr[r][3] * k4.w;
        dpv += dor[r][0] * v4.x + dor[r][1] * v4.y + dor[r][2] * v4.z + dor[r][3] * v4.w;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        dpv += __shfl_xor_sync(0xffffffffu, dpv, off);
      }
      const float p = allowed(a, qpos, k0 + j) ? expf(s * a.scale - row_lse) : 0.f;
      const float ds = p * (dpv - dsum);
#pragma unroll
      for (int r = 0; r < kRuns; ++r) {
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[j][(r * TPR + sub) * 4]);
        acc[r][0] += ds * k4.x;
        acc[r][1] += ds * k4.y;
        acc[r][2] += ds * k4.z;
        acc[r][3] += ds * k4.w;
      }
    }
  }

  if (!row_ok) return;
  T* out = dq + bi * a.dq.b + h * a.dq.h + (long long)qpos * a.dq.s;
#pragma unroll
  for (int r = 0; r < kRuns; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[(r * TPR + sub) * 4 + e] = from_f32<T>(acc[r][e] * a.scale);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kBlockKV * (DH / 32))
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     const BwdArgs a) {
  constexpr int TPR = DH / 32;  // threads per key row
  __shared__ __align__(16) float qs[kTileQ][DH];
  __shared__ __align__(16) float dos[kTileQ][DH];
  __shared__ float ls[kTileQ], dls[kTileQ];

  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int kh = blockIdx.y;
  const int bi = blockIdx.z;
  const int group = a.hq / a.hkv;
  const int k0 = blockIdx.x * kBlockKV;
  const int kpos = k0 + tid / TPR;
  const bool key_ok = kpos < a.sk;

  float kr[kRuns][4], vr[kRuns][4], dka[kRuns][4], dva[kRuns][4];
  const T* kp = k + bi * a.k.b + kh * a.k.h + (long long)kpos * a.k.s;
  const T* vp = v + bi * a.v.b + kh * a.v.h + (long long)kpos * a.v.s;
#pragma unroll
  for (int r = 0; r < kRuns; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = (r * TPR + sub) * 4 + e;
      kr[r][e] = key_ok ? to_f32(kp[c]) : 0.f;
      vr[r][e] = key_ok ? to_f32(vp[c]) : 0.f;
      dka[r][e] = 0.f;
      dva[r][e] = 0.f;
    }

  // query rows that can see some key of this tile
  const int k_last = min(k0 + kBlockKV, a.valid_k) - 1;
  int q_begin = a.causal ? k0 : 0;
  int q_end = k_last < k0 ? 0 : a.sq;  // the whole tile is past valid_k
  if (a.window > 0) q_end = min(q_end, k_last + a.window);
  q_begin = q_begin / kTileQ * kTileQ;

  for (int g = 0; g < group; ++g) {
    const int h = kh * group + g;
    const T* qb = q + bi * a.q.b + h * a.q.h;
    const T* db = dout + bi * a.dout.b + h * a.dout.h;
    const long long rows = ((long long)bi * a.hq + h) * a.sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kTileQ) {
      __syncthreads();  // the previous tile is consumed
      for (int i = tid; i < kTileQ * DH; i += blockDim.x) {
        const int j = i / DH, c = i % DH, qp = q0 + j;
        const bool ok = qp < a.sq;
        qs[j][c] = ok ? to_f32(qb[qp * a.q.s + c]) : 0.f;
        dos[j][c] = ok ? to_f32(db[qp * a.dout.s + c]) : 0.f;
      }
      for (int j = tid; j < kTileQ; j += blockDim.x) {
        const bool ok = q0 + j < a.sq;
        ls[j] = ok ? lse[rows + q0 + j] : INFINITY;
        dls[j] = ok ? delta[rows + q0 + j] : 0.f;
      }
      __syncthreads();

      for (int i = 0; i < kTileQ; ++i) {
        float s = 0.f, dpv = 0.f;
#pragma unroll
        for (int r = 0; r < kRuns; ++r) {
          const float4 q4 = *reinterpret_cast<const float4*>(&qs[i][(r * TPR + sub) * 4]);
          const float4 d4 = *reinterpret_cast<const float4*>(&dos[i][(r * TPR + sub) * 4]);
          s += kr[r][0] * q4.x + kr[r][1] * q4.y + kr[r][2] * q4.z + kr[r][3] * q4.w;
          dpv += vr[r][0] * d4.x + vr[r][1] * d4.y + vr[r][2] * d4.z + vr[r][3] * d4.w;
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
          dpv += __shfl_xor_sync(0xffffffffu, dpv, off);
        }
        const float p = allowed(a, q0 + i, kpos) ? expf(s * a.scale - ls[i]) : 0.f;
        const float ds = p * (dpv - dls[i]);
#pragma unroll
        for (int r = 0; r < kRuns; ++r) {
          const float4 q4 = *reinterpret_cast<const float4*>(&qs[i][(r * TPR + sub) * 4]);
          const float4 d4 = *reinterpret_cast<const float4*>(&dos[i][(r * TPR + sub) * 4]);
          dva[r][0] += p * d4.x;
          dva[r][1] += p * d4.y;
          dva[r][2] += p * d4.z;
          dva[r][3] += p * d4.w;
          dka[r][0] += ds * q4.x;
          dka[r][1] += ds * q4.y;
          dka[r][2] += ds * q4.z;
          dka[r][3] += ds * q4.w;
        }
      }
    }
  }

  if (!key_ok) return;
  T* dkp = dk + bi * a.dk.b + kh * a.dk.h + (long long)kpos * a.dk.s;
  T* dvp = dv + bi * a.dv.b + kh * a.dv.h + (long long)kpos * a.dv.s;
#pragma unroll
  for (int r = 0; r < kRuns; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = (r * TPR + sub) * 4 + e;
      dkp[c] = from_f32<T>(dka[r][e] * a.scale);
      dvp[c] = from_f32<T>(dva[r][e]);
    }
}

template <typename T, int DH>
cudaError_t launch_dh(const void* const* ptrs, float* delta, int b, const BwdArgs& a,
                      cudaStream_t stream) {
  const T* q = static_cast<const T*>(ptrs[0]);
  const T* k = static_cast<const T*>(ptrs[1]);
  const T* v = static_cast<const T*>(ptrs[2]);
  const T* o = static_cast<const T*>(ptrs[3]);
  const T* dout = static_cast<const T*>(ptrs[4]);
  const float* lse = static_cast<const float*>(ptrs[5]);
  T* dq = static_cast<T*>(const_cast<void*>(ptrs[6]));
  T* dk = static_cast<T*>(const_cast<void*>(ptrs[7]));
  T* dv = static_cast<T*>(const_cast<void*>(ptrs[8]));
  constexpr int TPR = DH / 32;
  if (a.sq > 0) {  // the dkdv launch reads the D that this one writes
    const dim3 grid_q((a.sq + kBlockQ - 1) / kBlockQ, a.hq, b);
    attn_bwd_dq_kernel<T, DH><<<grid_q, kBlockQ * TPR, 0, stream>>>(q, k, v, o, dout, lse,
                                                                    delta, dq, a);
    if (cudaError_t err = cudaGetLastError()) return err;
  }
  if (a.sk == 0) return cudaSuccess;
  const dim3 grid_kv((a.sk + kBlockKV - 1) / kBlockKV, a.hkv, b);
  attn_bwd_dkdv_kernel<T, DH><<<grid_kv, kBlockKV * TPR, 0, stream>>>(q, k, v, dout, lse, delta,
                                                                     dk, dv, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* const* ptrs, float* delta, int b, int dh, const BwdArgs& a,
                   cudaStream_t stream) {
  switch (dh) {
    case 32: return launch_dh<T, 32>(ptrs, delta, b, a, stream);
    case 64: return launch_dh<T, 64>(ptrs, delta, b, a, stream);
    case 128: return launch_dh<T, 128>(ptrs, delta, b, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ptrs: q, k, v, o, dout, lse, dq, dk, dv.  q, o, dout, dq: (b, hq, sq, dh);
// k, v, dk, dv: (b, hkv, sk, dh); each given by its (batch, head, seq) strides in
// elements, in that order, in `strides` (8 x 3 values), with a contiguous last
// dim.  lse: (b, hq, sq) f32 from the forward; delta: (b, hq, sq) f32 scratch.
// Returns the first launch error (0 on success).
extern "C" int flash_attention_bwd(const void* const* ptrs, float* delta, const long long* strides,
                                   int b, int hq, int hkv, int sq, int sk, int dh, int causal,
                                   int window, int valid_k, float scale, int dtype, int device,
                                   void* stream) {
  if (b == 0) return cudaSuccess;
  if (cudaError_t err = cudaSetDevice(device)) return err;
  if (hkv <= 0 || hq % hkv != 0 || valid_k > sk) return cudaErrorInvalidValue;
  BwdArgs a{hq, hkv, sq, sk, causal, window, valid_k, scale};
  Strides* st[8] = {&a.q, &a.k, &a.v, &a.o, &a.dout, &a.dq, &a.dk, &a.dv};
  for (int i = 0; i < 8; ++i) *st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(ptrs, delta, b, dh, a, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(ptrs, delta, b, dh, a, s);
  return cudaErrorInvalidValue;
}
