// Blocked (flash) GQA attention forward for Hopper (sm_90a), online softmax in f32.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::_attn_kernel (forward only).
//
// Bound: at the serving shapes (b=8, 14 q-heads, 2 kv-heads, s=500, dh=64, bf16)
// the function moves ~16 MB and does ~3.6 GFLOP of products, so against the
// tensor-core peak it is bound by device-memory bytes.  This first kernel does
// its products on the CUDA cores in f32, so in practice the FMA rate and the
// shared-memory reads that feed it bound it; wgmma/TMA is later work.
//
// Design:
// * The TPU kernel walks kv blocks as a sequential grid axis and carries
//   (m, l, acc) in VMEM scratch between grid steps.  CUDA blocks share nothing,
//   so one block owns one (batch, q-head, 64-row q tile) and loops over kv tiles
//   of 32 keys itself, keeping m, l and acc in registers.
// * Each query row belongs to DH/32 neighbouring threads; a thread owns 32 of
//   the row's DH elements, in runs of 4 so that it reads K and V from shared
//   memory 16 bytes at a time.  The partial dot products meet through shuffles.
// * K and V tiles are staged in shared memory as f32, read once per block from
//   the (b, hkv, sk, dh) cache: q-head h reads kv-head h / (hq / hkv), so the
//   GQA repeat is never materialised.
// * kv tiles wholly outside the causal / sliding-window band, or past valid_k,
//   are skipped (the TPU kernel computes and masks them).  Within a tile, keys
//   are masked per row; a fully masked row returns 0.
// * q, k, v and o are addressed through (batch, head, seq) strides with a
//   contiguous last dim, so callers pass head-transposed views without copies.
// * q tiles are issued last-first, so the longest causal tiles start first.
// * When a gradient is wanted, each row's log-sum-exp of its scaled scores goes
//   to an f32 (b, hq, sq) buffer for the backward (flash_attention_bwd.cu);
//   a fully masked row stores +inf, so that its probabilities come out 0.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 32;  // keys per kv tile

struct Strides {
  long long b, h, s;
};

struct AttnArgs {
  int hq, hkv, sq, sk, causal, window, valid_k;
  float scale;
  Strides q, k, v, o;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kBlockQ * (DH / 32))
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, const AttnArgs a) {
  constexpr int TPR = DH / 32;  // threads per query row
  constexpr int RUNS = 8;       // runs of 4 elements a thread owns: 8 * 4 = 32
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

  // element e of run r of this thread: column (r * TPR + sub) * 4 + e
  float qr[RUNS][4], acc[RUNS][4];
  const T* qp = q + bi * a.q.b + h * a.q.h + (long long)qpos * a.q.s;
#pragma unroll
  for (int r = 0; r < RUNS; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[r][e] = row_ok ? to_f32(qp[(r * TPR + sub) * 4 + e]) : 0.f;
      acc[r][e] = 0.f;
    }
  float m = -INFINITY, l = 0.f;

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

    float s[kBlockK];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int r = 0; r < RUNS; ++r) {
        const float4 kv4 = *reinterpret_cast<const float4*>(&ks[j][(r * TPR + sub) * 4]);
        dot += qr[r][0] * kv4.x + qr[r][1] * kv4.y + qr[r][2] * kv4.z + qr[r][3] * kv4.w;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kp = k0 + j;
      bool valid = row_ok && kp < a.valid_k;
      if (a.causal) valid = valid && qpos >= kp;
      if (a.window > 0) valid = valid && qpos - kp < a.window;
      s[j] = valid ? dot * a.scale : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }

    const float m_new = fmaxf(m, m_tile);
    if (m_new == -INFINITY) continue;  // every key so far masked for this row
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int r = 0; r < RUNS; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - m_new);  // masked keys: exp(-inf) = 0
      l += p;
#pragma unroll
      for (int r = 0; r < RUNS; ++r) {
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[j][(r * TPR + sub) * 4]);
        acc[r][0] += p * v4.x;
        acc[r][1] += p * v4.y;
        acc[r][2] += p * v4.z;
        acc[r][3] += p * v4.w;
      }
    }
    m = m_new;
  }

  if (!row_ok) return;
  if (lse) lse[((long long)bi * a.hq + h) * a.sq + qpos] = l == 0.f ? INFINITY : m + logf(l);
  T* op = o + bi * a.o.b + h * a.o.h + (long long)qpos * a.o.s;
  const float safe_l = l == 0.f ? 1.f : l;  // fully masked rows: acc is 0
#pragma unroll
  for (int r = 0; r < RUNS; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) op[(r * TPR + sub) * 4 + e] = from_f32<T>(acc[r][e] / safe_l);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                   int dh, const AttnArgs& a, cudaStream_t stream) {
  const dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, a.hq, b);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  switch (dh) {
    case 32: attn_fwd_kernel<T, 32><<<grid, kBlockQ * 1, 0, stream>>>(qt, kt, vt, ot, lse, a); break;
    case 64: attn_fwd_kernel<T, 64><<<grid, kBlockQ * 2, 0, stream>>>(qt, kt, vt, ot, lse, a); break;
    case 128: attn_fwd_kernel<T, 128><<<grid, kBlockQ * 4, 0, stream>>>(qt, kt, vt, ot, lse, a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q: (b, hq, sq, dh), k/v: (b, hkv, sk, dh), o: like q; each given by its
// (batch, head, seq) strides in elements with a contiguous last dim.  Keys at
// positions >= valid_k are masked.  lse: (b, hq, sq) f32 contiguous, or null when
// no gradient is wanted.  Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int b, int hq, int hkv, int sq, int sk, int dh,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, int valid_k, float scale, int dtype, int device, void* stream) {
  if (b == 0 || sq == 0) return cudaSuccess;
  if (cudaError_t err = cudaSetDevice(device)) return err;
  if (hkv <= 0 || hq % hkv != 0 || valid_k > sk) return cudaErrorInvalidValue;
  const AttnArgs a{hq, hkv, sq, sk, causal, window, valid_k, scale,
                   {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
                   {o_sb, o_sh, o_ss}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(q, k, v, o, lse, b, dh, a, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(q, k, v, o, lse, b, dh, a, s);
  return cudaErrorInvalidValue;
}
