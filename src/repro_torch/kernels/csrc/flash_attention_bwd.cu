// Blocked (flash) GQA attention backward for Hopper (sm_90a), FA2-style.
//
// Given q, k, v, the forward's output o, its row log-sum-exp lse and dO:
//   p = exp(scale * q.k - lse)            (0 where masked)
//   D = rowsum(dO * o) = rowsum(p * dP)
//   dV = p^T dO,  dP = dO v^T,  dS = p * (dP - D),
//   dQ = scale * dS k,  dK = scale * dS^T q.
//
// Replaces the backward of the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::_attn_kernel, which has
// none: the JAX package differentiates its jnp path instead (ROADMAP C-2).
//
// Bound: at the coded training step of qwen2-0.5b (q (128, 14, 64, 64), kv
// (128, 2, 64, 64), causal, bf16) the function reads q, k, v, o, dO and lse
// and writes dQ, dK and dV, 67.6 MB: 20.2 us at 3.35 TB/s.  Its five products
// over the causal half, 2.5 GFLOP, take 2.6 us at the bf16 tensor-core peak, so
// it is bound by bytes.
//
// Two launches, deterministic, no atomics; two kernel pairs, chosen by dtype:
// * bf16 (attn_bwd_dq_bf16_kernel, attn_bwd_dkdv_bf16_kernel), the trained
//   dtype, on the tensor cores with mma.sync.m16n8k16 (mma.cuh), in the forward's
//   tile design.  The first port did every product as f32 FMAs on the CUDA
//   cores fed from f32 tiles in shared memory, 0.571 ms at the training shape,
//   4.2x autograd of SDPA.
//   - Tiles sit on the grid's slowest axis, the longest causal ones first, as
//     in the forward.
//   - dq: one block per (batch, q-head, 64-row q tile), 4 warps of 16 rows.  Q
//     and dO stay in registers as A fragments (in shared memory at dh 128,
//     where the registers go to the accumulators); K and V tiles of 64 keys
//     come through a two-stage cp.async ring.  S = Q K^T, then P = exp2(S *
//     scale * log2(e) - lse * log2(e)), masked, and dP = dO V^T; dS = P * (dP
//     - D) is rounded to bf16 in registers and is the A operand of dQ += dS K
//     (K read by ldmatrix.trans).  dQ * scale is stored once.
//   - D = rowsum(dO * o) = rowsum(P * dP) is taken from the f32 P and dP, not
//     from the stored bf16 o: where one key dominates a row's softmax (q = k =
//     v), dP - D cancels on that key, and o's rounding alone put dQ beyond
//     3e-2 of the f32 gradient.  With one key tile (the training shape, 64
//     keys) the tile's registers give D and then dS; with more, a first pass
//     over the key tiles forms D (S and dP computed twice).  The dq launch
//     stores D for the dkdv launch; the forward writes nothing extra.
//   - dkdv: one block per (batch, kv-head, 64-key tile), 4 warps of 16 keys.
//     K and V stay resident (A fragments in registers; in shared memory at dh
//     128).  The block walks every q-head of its GQA group and the band's q
//     tiles, with Q, dO, lse and D in a cp.async ring: S^T = K Q^T, P^T, dV +=
//     P^T dO with P^T a bf16 A fragment from registers, dP^T = V dO^T, dS^T =
//     P^T * (dP^T - D) and dK += dS^T Q.  The group's sum lands in one block's
//     f32 registers, stored once.
//   - Masks apply per element only on tiles that cross an edge; tiles wholly
//     outside the band are skipped.  Rows of a fully masked query have lse +inf
//     from the forward, so their P is 0.  Shared memory: 56 KB (dq) and 56 KB
//     (dkdv) at dh 64, 67 KB at dh 80, dynamic.  Above dh 64 (80 and 128) the
//     resident operands' fragments are read from shared memory at each use.
//     mma.sync rather than wgmma: the bound is bytes at these shapes (see
//     flash_attention.cu).
// * f32 (attn_bwd_dq_kernel, attn_bwd_dkdv_kernel), the dtype of the gradient
//   checks: f32 FMAs on the CUDA cores with the f32 forward's thread layout (a
//   row owned by RowSplit<dh>::kThreads neighbouring threads, tiles of 32 keys
//   or queries staged as f32).
// * All take (batch, head, seq) strides with a contiguous last dim; the bf16
//   kernels move 16 bytes per cp.async, so the wrapper checks 16-byte aligned
//   pointers and strides.

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBlockQ = 64;   // dq: query rows per block
constexpr int kBlockK = 32;   // dq: keys per staged kv tile
constexpr int kBlockKV = 64;  // dkdv: keys per block
constexpr int kTileQ = 32;    // dkdv: query rows per staged q tile

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
__global__ void __launch_bounds__(kBlockQ * RowSplit<DH>::kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ o, const T* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   T* __restrict__ dq, const BwdArgs a) {
  constexpr int TPR = RowSplit<DH>::kThreads;  // threads per query row
  constexpr int kRuns = RowSplit<DH>::kRuns;   // runs of 4 elements a thread owns
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
__global__ void __launch_bounds__(kBlockKV * RowSplit<DH>::kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     const BwdArgs a) {
  constexpr int TPR = RowSplit<DH>::kThreads;  // threads per key row
  constexpr int kRuns = RowSplit<DH>::kRuns;
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
  constexpr int TPR = RowSplit<DH>::kThreads;
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
    case 80: return launch_dh<T, 80>(ptrs, delta, b, a, stream);
    case 128: return launch_dh<T, 128>(ptrs, delta, b, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// -- bf16 on the tensor cores --------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // dq: query rows per block; dkdv: per staged q tile
constexpr int kKeys = 16 * kWarps;  // dkdv: keys per block; dq: per staged kv tile
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
constexpr int bf16_smem_bytes() {
  // dq: Q, dO and two stages of (K, V);
  // dkdv: K, V and two stages of (Q, dO), then two stages of (lse, D)
  return 6 * 64 * mma::Tile<DH>::kStride * (int)sizeof(bf16) + 4 * 64 * (int)sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ delta,
                        bf16* __restrict__ dq, const BwdArgs a) {
  constexpr int S = mma::Tile<DH>::kStride;
  constexpr int KC = DH / 16;
  constexpr int NT = kKeys / 8;
  constexpr bool kResident = DH <= 64;  // Q and dO fragments in registers
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kRows * S;
  bf16* ring = dos + kRows * S;  // stage i: K at ring + i * 2 * kKeys * S, then V

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, bi = blockIdx.y;
  const int kh = h / (a.hq / a.hkv);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // the longest causal tiles first
  const mma::Band band{a.sq, a.valid_k, a.causal, a.window};
  int kv_begin, kv_end;
  const int n_tiles = band.key_tiles(q0, kRows, kKeys, &kv_begin, &kv_end);
  // D = rowsum(P * dP) needs every key tile before the first dS: one tile
  // serves both from the same registers, more take a first pass for D
  const int steps = n_tiles <= 1 ? n_tiles : 2 * n_tiles;

  const bf16* db = dout + bi * a.dout.b + h * a.dout.h;
  const bf16* kb = k + bi * a.k.b + kh * a.k.h;
  const bf16* vb = v + bi * a.v.b + kh * a.v.h;
  auto load_kv = [&](int j) {  // step j reads key tile j % n_tiles into stage j & 1
    bf16* ks = ring + (j & 1) * 2 * kKeys * S;
    const int k0 = kv_begin + (j % n_tiles) * kKeys;
    mma::load_tile<kKeys, DH, kThreads>(ks, kb, a.k.s, k0, kv_end, tid);
    mma::load_tile<kKeys, DH, kThreads>(ks + kKeys * S, vb, a.v.s, k0, kv_end, tid);
  };
  mma::load_tile<kRows, DH, kThreads>(qs, q + bi * a.q.b + h * a.q.h, a.q.s, q0, a.sq, tid);
  mma::load_tile<kRows, DH, kThreads>(dos, db, a.dout.s, q0, a.sq, tid);
  mma::cp_async_commit();
  if (steps > 0) load_kv(0);
  mma::cp_async_commit();
  mma::cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  mma::AFrags<DH, kResident> qf, dof;
  qf.init(qs + warp * 16 * S, lane);
  dof.init(dos + warp * 16 * S, lane);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const long long rows = ((long long)bi * a.hq + h) * a.sq;
  const float sl2 = a.scale * kLog2e;
  // rows past sq: lse +inf, so P = 0
  const float lse0 = row0 < a.sq ? lse[rows + row0] * kLog2e : INFINITY;
  const float lse1 = row1 < a.sq ? lse[rows + row1] * kLog2e : INFINITY;
  float d0 = 0.f, d1 = 0.f;  // this lane's part of D until the first pass ends, then D
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < steps; ++j) {
    if (j + 1 < steps) load_kv(j + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // step j's tile has landed
    __syncthreads();
    const bf16* ks = ring + (j & 1) * 2 * kKeys * S;
    const int k0 = kv_begin + (j % n_tiles) * kKeys;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma::mma_abt<NT, KC, DH>(s, qf, ks, lane);           // S = Q K^T
    mma::mma_abt<NT, KC, DH>(dp, dof, ks + kKeys * S, lane);  // dP = dO V^T
    const bool edge = band.crosses(q0, kRows, k0, kKeys);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], sl2, -(e < 2 ? lse0 : lse1)));
        if (edge && !band.visible(e < 2 ? row0 : row1, k0 + n * 8 + 2 * t + (e & 1))) p = 0.f;
        s[n][e] = p;
      }
    if (j < n_tiles) {  // first pass: D += P * dP over this tile's keys
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        d0 = fmaf(s[n][0], dp[n][0], fmaf(s[n][1], dp[n][1], d0));
        d1 = fmaf(s[n][2], dp[n][2], fmaf(s[n][3], dp[n][3], d1));
      }
      if (j == n_tiles - 1) {  // across the quad that shares the rows
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          d0 += __shfl_xor_sync(0xffffffffu, d0, off);
          d1 += __shfl_xor_sync(0xffffffffu, d1, off);
        }
      }
    }
    if (steps == 1 || j >= n_tiles) {  // second pass: dQ += dS K, dS = P (dP - D)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - (e < 2 ? d0 : d1);
      mma::mma_pv<NT / 2, DH>(acc, s, ks, lane);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  if (t == 0) {  // D of every row, 0 where no key is seen, for the dK/dV launch
    if (row0 < a.sq) delta[rows + row0] = d0;
    if (row1 < a.sq) delta[rows + row1] = d1;
  }
  mma::store_rows<DH>(acc, a.scale, a.scale, qs + warp * 16 * S, dq + bi * a.dq.b + h * a.dq.h,
                      a.dq.s, q0 + warp * 16, a.sq, lane);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, const BwdArgs a) {
  constexpr int S = mma::Tile<DH>::kStride;
  constexpr int KC = DH / 16;
  constexpr int NT = kRows / 8;
  constexpr bool kResident = DH <= 64;  // K and V fragments in registers
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kKeys * S;
  bf16* ring = vs + kKeys * S;  // stage i: Q at ring + i * 2 * kRows * S, then dO
  float* fring = reinterpret_cast<float*>(ring + 4 * kRows * S);  // stage i: lse, then D

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kh = blockIdx.x, bi = blockIdx.y;
  const int group = a.hq / a.hkv;
  const int k0 = blockIdx.z * kKeys;  // the first key tiles, which most queries see, first
  const mma::Band band{a.sq, a.valid_k, a.causal, a.window};
  int q_begin = 0;
  const int n_q = band.query_tiles(k0, kKeys, kRows, &q_begin);
  const int total = group * n_q;  // (q-head, q tile) steps

  auto load_q = [&](int it) {
    const int h = kh * group + it / n_q, qs0 = q_begin + (it % n_q) * kRows;
    bf16* qst = ring + (it & 1) * 2 * kRows * S;
    mma::load_tile<kRows, DH, kThreads>(qst, q + bi * a.q.b + h * a.q.h, a.q.s, qs0, a.sq, tid);
    mma::load_tile<kRows, DH, kThreads>(qst + kRows * S, dout + bi * a.dout.b + h * a.dout.h,
                                        a.dout.s, qs0, a.sq, tid);
    float* fst = fring + (it & 1) * 2 * kRows;
    const long long rows = ((long long)bi * a.hq + h) * a.sq + qs0;
    for (int r = tid; r < kRows; r += kThreads) {
      const bool ok = qs0 + r < a.sq;
      mma::cp_async_4(fst + r, lse + (ok ? rows + r : 0), ok);
      mma::cp_async_4(fst + kRows + r, delta + (ok ? rows + r : 0), ok);
    }
  };
  mma::load_tile<kKeys, DH, kThreads>(ks, k + bi * a.k.b + kh * a.k.h, a.k.s, k0, a.sk, tid);
  mma::load_tile<kKeys, DH, kThreads>(vs, v + bi * a.v.b + kh * a.v.h, a.v.s, k0, a.sk, tid);
  mma::cp_async_commit();
  if (total > 0) load_q(0);
  mma::cp_async_commit();
  mma::cp_async_wait<1>();  // K and V have landed
  __syncthreads();
  mma::AFrags<DH, kResident> kf, vf;
  kf.init(ks + warp * 16 * S, lane);
  vf.init(vs + warp * 16 * S, lane);
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
  const float sl2 = a.scale * kLog2e;
  float dka[DH / 8][4], dva[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) load_q(it + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // step it has landed
    __syncthreads();
    const bf16* qst = ring + (it & 1) * 2 * kRows * S;
    const bf16* dost = qst + kRows * S;
    const float* fst = fring + (it & 1) * 2 * kRows;
    const int qs0 = q_begin + (it % n_q) * kRows;
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    mma::mma_abt<NT, KC, DH>(s, kf, qst, lane);  // S^T = K Q^T: rows keys, columns queries
    const bool edge = band.crosses(qs0, kRows, k0, kKeys);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        float p = exp2f(fmaf(s[n][e], sl2, -fst[c] * kLog2e));
        if (edge && !band.visible(qs0 + c, e < 2 ? key0 : key1)) p = 0.f;
        s[n][e] = p;
      }
    mma::mma_pv<NT / 2, DH>(dva, s, dost, lane);  // dV += P^T dO
    float dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
    mma::mma_abt<NT, KC, DH>(dp, vf, dost, lane);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] *= dp[n][e] - fst[kRows + n * 8 + 2 * t + (e & 1)];  // dS^T
    mma::mma_pv<NT / 2, DH>(dka, s, qst, lane);  // dK += dS^T Q
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  mma::store_rows<DH>(dka, a.scale, a.scale, ks + warp * 16 * S, dk + bi * a.dk.b + kh * a.dk.h,
                      a.dk.s, k0 + warp * 16, a.sk, lane);
  mma::store_rows<DH>(dva, 1.f, 1.f, vs + warp * 16 * S, dv + bi * a.dv.b + kh * a.dv.h, a.dv.s,
                      k0 + warp * 16, a.sk, lane);
}

template <int DH>
cudaError_t launch_bf16_dh(const void* const* ptrs, float* delta, int b, const BwdArgs& a,
                           cudaStream_t stream) {
  const bf16* q = static_cast<const bf16*>(ptrs[0]);
  const bf16* k = static_cast<const bf16*>(ptrs[1]);
  const bf16* v = static_cast<const bf16*>(ptrs[2]);
  const bf16* dout = static_cast<const bf16*>(ptrs[4]);  // ptrs[3], o, is not read: D comes from P
  const float* lse = static_cast<const float*>(ptrs[5]);
  bf16* dq = static_cast<bf16*>(const_cast<void*>(ptrs[6]));
  bf16* dk = static_cast<bf16*>(const_cast<void*>(ptrs[7]));
  bf16* dv = static_cast<bf16*>(const_cast<void*>(ptrs[8]));
  constexpr int smem = bf16_smem_bytes<DH>();
  if (a.sq > 0) {  // the dkdv launch reads the D that this one writes
    if (cudaError_t err = cudaFuncSetAttribute(
            attn_bwd_dq_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
      return err;
    const dim3 grid_q(a.hq, b, (a.sq + kRows - 1) / kRows);
    attn_bwd_dq_bf16_kernel<DH><<<grid_q, kThreads, smem, stream>>>(q, k, v, dout, lse, delta, dq,
                                                                    a);
    if (cudaError_t err = cudaGetLastError()) return err;
  }
  if (a.sk == 0) return cudaSuccess;
  if (cudaError_t err = cudaFuncSetAttribute(
          attn_bwd_dkdv_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return err;
  const dim3 grid_kv(a.hkv, b, (a.sk + kKeys - 1) / kKeys);
  attn_bwd_dkdv_bf16_kernel<DH><<<grid_kv, kThreads, smem, stream>>>(q, k, v, dout, lse, delta,
                                                                     dk, dv, a);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* const* ptrs, float* delta, int b, int dh, const BwdArgs& a,
                        cudaStream_t stream) {
  switch (dh) {
    case 32: return launch_bf16_dh<32>(ptrs, delta, b, a, stream);
    case 64: return launch_bf16_dh<64>(ptrs, delta, b, a, stream);
    case 80: return launch_bf16_dh<80>(ptrs, delta, b, a, stream);
    case 128: return launch_bf16_dh<128>(ptrs, delta, b, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ptrs: q, k, v, o, dout, lse, dq, dk, dv.  q, o, dout, dq: (b, hq, sq, dh);
// k, v, dk, dv: (b, hkv, sk, dh); each given by its (batch, head, seq) strides in
// elements, in that order, in `strides` (8 x 3 values), with a contiguous last
// dim (in bf16, 16-byte aligned rows: pointers and strides the caller has
// checked).  lse: (b, hq, sq) f32 from the forward; delta: (b, hq, sq) f32 scratch.
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
  if (dtype == kBFloat16) return launch_bf16(ptrs, delta, b, dh, a, s);
  return cudaErrorInvalidValue;
}
