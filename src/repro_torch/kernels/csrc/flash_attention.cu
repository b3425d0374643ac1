// Blocked (flash) GQA attention forward for Hopper (sm_90a), online softmax in f32.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::_attn_kernel (forward only).
//
// Bound: at the serving prefill of qwen2-0.5b (q (8, 14, 500, 64), kv (8, 2,
// 500, 64), causal, bf16) the function reads q, k and v and writes o, 16.4 MB:
// 4.9 us at 3.35 TB/s.  Its products over the causal half, 3.6 GFLOP, take 3.6 us
// even at the 989 TFLOP/s bf16 tensor-core peak, so it is bound by bytes.  At
// the coded training step's q (128, 14, 64, 64) with lse it moves 21.4 MB (6.4
// us) for 1.0 GFLOP.  At zamba2-2.7b's shared attention (q, k, v (8, 32, 500,
// 80), causal) it moves 81.9 MB (24.5 us) for 10.3 GFLOP (10.4 us): bytes again.
// At paligemma-3b's prefill (q (8, 8, 500, 256), kv (8, 1, 500, 256), causal) it
// moves 36.9 MB (11.0 us) for 8.2 GFLOP (8.3 us), and at hubert-xlarge's
// non-causal encoder (q, k, v (8, 16, 500, 80)) 41.0 MB (12.2 us) for 10.2 GFLOP
// (10.4 us): bytes bind both, the first only just.
//
// Two kernels, chosen by dtype:
// * bf16 (attn_fwd_bf16_kernel), the served and trained dtype, on the tensor
//   cores with mma.sync.m16n8k16 (helpers in mma.cuh).  The first port did every
//   product as f32 FMAs on the CUDA cores (67 TFLOP/s at most) fed from f32
//   tiles in shared memory, and took 0.333 ms at the serving shape, 15.8x
//   SDPA's time; the CUDA-core rate and the shared-memory traffic were what
//   bound it, not the tensor cores'.
//   - One block per (batch, q-head, 64-row q tile), 4 warps of 16 query rows.
//     The q tile is the grid's slowest axis, issued last-first, so every
//     longest causal tile starts before any shorter one and the short ones
//     fill the tail (the f32 kernel puts the q tile on the fastest axis).
//     The TPU kernel walks kv blocks as a sequential grid axis with (m, l, acc)
//     in VMEM scratch; here the block loops over kv tiles itself with m, l and
//     acc in registers.
//   - The q tile goes through shared memory once into A fragments that stay in
//     registers.  K and V tiles of 64 keys are staged in bf16 in a two-stage
//     cp.async ring, so the next tile loads during this tile's math; the ring
//     and the q tile take 46 KB at dh 64, 55 KB at dh 80 and 87 KB at dh 128
//     (dynamic shared memory).  Rows are padded by 16 bytes, so ldmatrix has
//     no bank conflicts.
//   - Head dim 256 (paligemma-3b) does not fit that plan.  The O accumulator
//     alone is 16 x 256 f32 a warp, 128 registers a thread; resident q
//     fragments would add 64 (16 k-chunks x 4) and S over 64 keys 32, 224
//     before addresses and softmax state, past what ptxas can hold unspilled,
//     and the ring of 64-key tiles with the q tile would take 165 KB, one
//     block an SM.  So at 256 (FwdPlan): the q fragments are read from the
//     shared q tile at each use (ldmatrix, as the dh-128 backward does), and kv
//     tiles are 32 keys, which halves S to 16 registers and the ring to 66 KB;
//     with the 33 KB q tile a block takes 99 KB, so two blocks (8 warps) fit
//     an SM.  O stays whole in each warp's registers: splitting its columns
//     over two warps would compute S twice or pass P through shared memory.
//     ptxas for sm_90a (chip_smoke.py [build], on an NVIDIA H100 80GB HBM3 at
//     700 W): 244 registers, 0 bytes spilled, 128 HMMA instructions; no spill
//     is a condition of that run.
//   - S = Q.K^T by mma.sync with K read by ldmatrix; the online softmax runs in
//     f32 on the accumulator fragments (row max and sum across the lane quad by
//     two shuffles, exp2 with scale*log2(e) folded in).  P is rounded to bf16
//     in registers and fed straight back as the A operand of O += P.V, V read by
//     ldmatrix.trans: P never goes through shared memory.
//   - Per-element masks (causal diagonal, window edge, valid_k, the last q
//     tile's rows) apply only on tiles that cross an edge; kv tiles wholly
//     outside the band are skipped (the TPU kernel computes and masks them).
//     A fully masked row keeps m = -inf guards, returns 0 and lse +inf.
//   - Epilogue: O / l in f32, stored as bf16 through the warp's rows of the q
//     tile with 16-byte stores.
//   - Why mma.sync and not wgmma yet: the function is bound by bytes at these
//     shapes, and mma.sync already lifts the CUDA-core limit; wgmma with TMA and
//     warp specialisation reaches the last third of the tensor-core rate, which
//     pays only where products dominate (long sequences, dh 128 at large batch).
// * f32 (attn_fwd_kernel), the dtype of the logits checks, as the JAX kernel
//   contracts f32 inputs in f32: f32 FMAs on the CUDA cores, kv tiles of 32
//   keys staged as f32 in dynamic shared memory (64 KB at dh 256, past the
//   48 KB a static array may take), blocks of 64 query rows (32 at dh 256),
//   a query row owned by a few neighbouring
//   threads, each holding runs of 4 of its elements and meeting the others by
//   shuffles (RowSplit in common.cuh: dh/32 threads of 32 elements, or 4 of 20
//   at dh 80).
//
// Both take q, k, v and o through (batch, head, seq) strides with a contiguous
// last dim, so callers pass head-transposed views without copies; q-head h reads
// kv-head h / (hq / hkv), so the GQA repeat is never materialised.  The bf16
// kernel moves 16 bytes per cp.async, so the wrapper checks 16-byte aligned
// pointers and strides.  When a gradient is wanted, each row's log-sum-exp of
// its scaled scores goes to an f32 (b, hq, sq) buffer for the backward
// (flash_attention_bwd.cu); a fully masked row stores +inf, so that its
// probabilities come out 0.

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

// query rows per block: 64, or 32 at dh 256, whose 8 threads a row would
// otherwise make blocks of 512 threads, capped at 128 registers a thread
template <int DH>
constexpr int kBlockQ = DH <= 128 ? 64 : 32;
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
__global__ void __launch_bounds__(kBlockQ<DH> * RowSplit<DH>::kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, const AttnArgs a) {
  constexpr int TPR = RowSplit<DH>::kThreads;  // threads per query row
  constexpr int RUNS = RowSplit<DH>::kRuns;    // runs of 4 elements a thread owns
  extern __shared__ __align__(16) float kv_smem[];
  float (*ks)[DH] = reinterpret_cast<float (*)[DH]>(kv_smem);
  float (*vs)[DH] = reinterpret_cast<float (*)[DH]>(kv_smem + kBlockK * DH);

  const int tid = threadIdx.x;
  const int sub = tid % TPR;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kh = h / (a.hq / a.hkv);
  const int q0 = qt * kBlockQ<DH>;
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
  const int q_last = min(q0 + kBlockQ<DH>, a.sq) - 1;
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

template <typename T, int DH>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                      const AttnArgs& a, cudaStream_t stream) {
  constexpr int smem = 2 * kBlockK * DH * (int)sizeof(float);  // the K and V tiles
  if (cudaError_t err = cudaFuncSetAttribute(
          attn_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return err;
  const dim3 grid((a.sq + kBlockQ<DH> - 1) / kBlockQ<DH>, a.hq, b);
  attn_fwd_kernel<T, DH><<<grid, kBlockQ<DH> * RowSplit<DH>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                   int dh, const AttnArgs& a, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch_dh<T, 32>(q, k, v, o, lse, b, a, stream);
    case 64: return launch_dh<T, 64>(q, k, v, o, lse, b, a, stream);
    case 80: return launch_dh<T, 80>(q, k, v, o, lse, b, a, stream);
    case 128: return launch_dh<T, 128>(q, k, v, o, lse, b, a, stream);
    case 256: return launch_dh<T, 256>(q, k, v, o, lse, b, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// -- bf16 on the tensor cores --------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileQ = 16 * kWarps;  // query rows per block, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;

// Keys per staged kv tile, and whether a warp's q fragments stay in registers:
// 64 and yes up to dh 128; 32 and no at 256, where O takes 128 registers.
template <int DH>
struct FwdPlan {
  static constexpr int kTileK = DH <= 128 ? 64 : 32;
  static constexpr bool kQResident = DH <= 128;
  static constexpr int kSmemBytes =  // the q tile and two stages of (K, V)
      (kTileQ + 2 * 2 * kTileK) * mma::Tile<DH>::kStride * (int)sizeof(bf16);
};

template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     const AttnArgs a) {
  constexpr int S = mma::Tile<DH>::kStride;
  constexpr int kTileK = FwdPlan<DH>::kTileK;
  constexpr int KC = DH / 16;     // k-chunks of a q.k product
  constexpr int NT = kTileK / 8;  // n-tiles of 8 keys
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = qs + kTileQ * S;  // stage i: K at ring + i * 2 * kTileK * S, then V

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, bi = blockIdx.y;
  const int kh = h / (a.hq / a.hkv);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTileQ;
  const mma::Band band{a.sq, a.valid_k, a.causal, a.window};
  int kv_begin, kv_end;
  const int n_tiles = band.key_tiles(q0, kTileQ, kTileK, &kv_begin, &kv_end);

  const bf16* kb = k + bi * a.k.b + kh * a.k.h;
  const bf16* vb = v + bi * a.v.b + kh * a.v.h;
  auto load_kv = [&](int i) {
    bf16* ks = ring + (i & 1) * 2 * kTileK * S;
    const int k0 = kv_begin + i * kTileK;
    mma::load_tile<kTileK, DH, kThreads>(ks, kb, a.k.s, k0, kv_end, tid);
    mma::load_tile<kTileK, DH, kThreads>(ks + kTileK * S, vb, a.v.s, k0, kv_end, tid);
  };
  mma::load_tile<kTileQ, DH, kThreads>(qs, q + bi * a.q.b + h * a.q.h, a.q.s, q0, a.sq, tid);
  mma::cp_async_commit();
  if (n_tiles > 0) load_kv(0);
  mma::cp_async_commit();
  mma::cp_async_wait<1>();  // the q tile has landed; the first kv tile may not have
  __syncthreads();
  mma::AFrags<DH, FwdPlan<DH>::kQResident> qf;
  qf.init(qs + warp * 16 * S, lane);

  // this thread's two rows (g and g + 8 of the warp's 16): running max of the
  // raw scores, sum of exp, and the O accumulator's 16 x DH tile
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float sl2 = a.scale * kLog2e;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_kv(i + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // tile i has landed
    __syncthreads();
    const bf16* ks = ring + (i & 1) * 2 * kTileK * S;
    const int k0 = kv_begin + i * kTileK;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    mma::mma_abt<NT, KC, DH>(s, qf, ks, lane);
    if (band.crosses(q0, kTileQ, k0, kTileK)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!band.visible(e < 2 ? row0 : row1, k0 + n * 8 + 2 * t + (e & 1)))
            s[n][e] = -INFINITY;
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // across the quad that shares the rows
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every key so far masked: exponents from 0, so exp2(-inf) = 0, not NaN
    const float base0 = mx0 == -INFINITY ? 0.f : mx0 * sl2;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1 * sl2;
    const float alpha0 = exp2f(m0 * sl2 - base0), alpha1 = exp2f(m1 * sl2 - base1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(fmaf(s[n][0], sl2, -base0));
      s[n][1] = exp2f(fmaf(s[n][1], sl2, -base0));
      s[n][2] = exp2f(fmaf(s[n][2], sl2, -base1));
      s[n][3] = exp2f(fmaf(s[n][3], sl2, -base1));
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + sum0;  // this lane's part; the quad's parts meet at the end
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }
    mma::mma_pv<NT / 2, DH>(acc, s, ks + kTileK * S, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (lse && t == 0) {
    const long long rows = ((long long)bi * a.hq + h) * a.sq;
    if (row0 < a.sq) lse[rows + row0] = l0 == 0.f ? INFINITY : m0 * a.scale + logf(l0);
    if (row1 < a.sq) lse[rows + row1] = l1 == 0.f ? INFINITY : m1 * a.scale + logf(l1);
  }
  // fully masked rows: acc is 0 and so is the output
  mma::store_rows<DH>(acc, l0 == 0.f ? 0.f : 1.f / l0, l1 == 0.f ? 0.f : 1.f / l1,
                      qs + warp * 16 * S, o + bi * a.o.b + h * a.o.h, a.o.s, q0 + warp * 16,
                      a.sq, lane);
}

template <int DH>
cudaError_t launch_bf16_dh(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                           int b, const AttnArgs& a, cudaStream_t stream) {
  constexpr int smem = FwdPlan<DH>::kSmemBytes;
  if (cudaError_t err = cudaFuncSetAttribute(
          attn_fwd_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return err;
  // q tiles on the slowest axis, last first: every (head, batch)'s longest
  // causal tile is issued before any shorter one
  const dim3 grid(a.hq, b, (a.sq + kTileQ - 1) / kTileQ);
  attn_fwd_bf16_kernel<DH><<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, a);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                        int dh, const AttnArgs& a, cudaStream_t stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  bf16* ot = static_cast<bf16*>(o);
  switch (dh) {
    case 32: return launch_bf16_dh<32>(qt, kt, vt, ot, lse, b, a, stream);
    case 64: return launch_bf16_dh<64>(qt, kt, vt, ot, lse, b, a, stream);
    case 80: return launch_bf16_dh<80>(qt, kt, vt, ot, lse, b, a, stream);
    case 128: return launch_bf16_dh<128>(qt, kt, vt, ot, lse, b, a, stream);
    case 256: return launch_bf16_dh<256>(qt, kt, vt, ot, lse, b, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, hq, sq, dh), k/v: (b, hkv, sk, dh), o: like q; each given by its
// (batch, head, seq) strides in elements with a contiguous last dim (in bf16,
// 16-byte aligned rows: pointers and strides the caller has checked).  Keys at
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
  if (dtype == kBFloat16) return launch_bf16(q, k, v, o, lse, b, dh, a, s);
  return cudaErrorInvalidValue;
}
