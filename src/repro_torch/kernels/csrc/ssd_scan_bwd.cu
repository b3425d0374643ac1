// Backward of the fused Mamba2 SSD chunk scan (ssd_scan.cu's ssd_chunk_scan)
// for Hopper (sm_90a).  Per batch-chunk bc and head h, with
//   S[q, u] = C_q . B_u,  decay[q, u] = exp(cum_q - cum_u) for u <= q (else 0),
//   W = S * decay,  E_q = exp(cum_q),  y = W (dt x) + E_q C_q . h_prev + D x
// over the rows q < s of the sequence, and dy (b, s, nh, hd):
//   dx      = dt (W^T dy) + D dy            ddt  = sum_d x (W^T dy)
//   dW      = dy (dt x)^T, masked           dS   = sum_h dW * decay
//   dB      = dS^T C                        dC   = dS B + sum_h E G,  G = dy . h_prev
//   dcum    = rowsum(dW * W) - colsum(dW * W) + E sum_s C G
//   dh_prev = sum_q E dy (x) C              dD   = sum over bc, q, d of dy x
// dx, dB and dC in the inputs' dtype, the rest f32; every sum in f32.
//
// The TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py::_intra_kernel has no
// backward (the JAX package trains through its jnp path); this is the
// backward of the port's fused entry, which replaces that kernel on the card.
//
// Bound, at mamba2-1.3b's coded training shape (512 batch-chunks of Q 64, 64
// heads of 64, d_state 128, x, B, C and dy in bf16): it reads x, dy (268 MB
// each) and h_prev (1.07 GB f32) and writes dx (268 MB) and dh_prev (1.07 GB
// f32), ~3.0 GB with the small tensors: 0.9 ms at 3.35 TB/s.  Its products,
// ~78 GFLOP, take 0.08 ms at the bf16 tensor-core peak, so it is bound by
// bytes; on the CUDA cores in f32, as here, they take 1.2 ms at 67 TFLOP/s.
//
// A first kernel, right and simple: f32 FMAs on the CUDA cores, operands
// staged in shared memory as f32, each thread a 4 x 4 tile of an output.
// Three launches, in stream order:
// * inter (grid: bc x 64-column tiles of the state x groups of heads): per
//   head, G = dy . h_prev and dh_prev = (E dy)^T C over the tile's columns;
//   E G is summed over the group's heads in registers and written once (the
//   group's part of dC), and each row's E sum_s C G (the tile's part of
//   dcum) once per head.
// * intra (grid: bc x groups of heads): S is computed once a block into
//   registers, each thread owning up to three causal 4 x 4 tiles of it; per
//   head, dW and W on the same tiles, dW * W to shared memory for dcum's row
//   and column sums, then W for dx = dt W^T dy + D dy and ddt; dS summed over
//   the group's heads in registers and written once.  Masked entries are
//   selected to 0 and never exponentiated: above the diagonal the exponent is
//   positive and can overflow, and inf * 0 is NaN.
// * finish (grid: bc + 1): dS summed over the intra groups, dB = dS^T C and
//   dC = dS B + the inter groups' parts; the last block sums dD over bc.
// Rows q >= s get dy = 0, so every output row there is exactly 0.  No float
// atomics: every cross-block sum goes through f32 partials in the workspace
// and is added in a fixed order, so two calls give the same bits.  The
// workspace (the wrapper's, f32): dcum's inter part (bc, tiles, Q, nh), dC's
// (groups, bc, Q, st), dS (groups, bc, Q, Q) and dD (bc, nh).
//
// Inputs are read element by element through their strides (the model passes
// slices of its conv output); dy (b, s, nh, hd), h_prev (bc, nh, hd, st) and D
// contiguous; outputs contiguous.  Any Q <= 128, head_dim <= 128 and d_state
// <= 512: the largest tiles need 222 KB of shared memory.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStTile = 64;               // state columns of an inter block
constexpr int kLdT = kStTile + 4;         // padded rows of its C and h_prev tiles
constexpr int kStChunk = 32;              // state columns staged at a time (S, finish)
constexpr int kLdChunk = kStChunk + 1;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

struct BwdArgs {
  int bc, Q, nh, hd, st, nc, s;
  int tiles;                    // kStTile-column tiles of the state
  int g_inter, hpb_inter;       // inter: head groups and heads a group
  int g_intra, hpb_intra;       // intra: the same
  long long xs[4];              // x (bc, Q, nh, hd)
  long long dts[3];             // dt (bc, Q, nh)
  long long cums[3];            // cum (bc, Q, nh)
  long long bs[3];              // B (bc, Q, st)
  long long cs[3];              // C (bc, Q, st)
};

struct BwdPtrs {
  const void* x;
  const float* dt;
  const float* cum;
  const void* B;
  const void* C;
  const float* h_prev;
  const float* D;
  const void* dy;
  void* dx;
  float* ddt;
  float* dcum;
  void* dB;
  void* dC;
  float* dh_prev;
  float* dD;
  float* ws_dcum;   // (bc, tiles, Q, nh)
  float* ws_dc;     // (g_inter, bc, Q, st)
  float* ws_ds;     // (g_intra, bc, Q, Q)
  float* ws_dd;     // (bc, nh)
};

// Where batch-chunk bc's rows are in dy (b, s, nh, hd): row q < rows at
// ((first + q) * nh + h) * hd for head h.
struct DyRows {
  long long first;
  int rows;

  __device__ DyRows(const BwdArgs& a, long long bc)
      : first((bc / a.nc) * a.s + (bc % a.nc) * a.Q),
        rows(min(a.Q, (int)(a.s - (bc % a.nc) * a.Q))) {}
};

template <typename T>
__device__ __forceinline__ float elem(const void* p, long long i) {
  return to_f32(static_cast<const T*>(p)[i]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// dy of head h into a (qp, ld) f32 tile, row-major (transposed = false) or
// column-major (true: element (q, d) at d * ld + q), 0 past the sequence's
// rows and head_dim.
template <typename TY>
__device__ void load_dy(float* dst, int ld, bool transposed, const BwdArgs& a, const BwdPtrs& p,
                        const DyRows& rows, int h, int qp, int hdp) {
  for (int i = threadIdx.x; i < qp * hdp; i += kThreads) {
    const int q = i / hdp, d = i % hdp;
    const float v = q < rows.rows && d < a.hd
                        ? elem<TY>(p.dy, ((rows.first + q) * a.nh + h) * a.hd + d) : 0.f;
    dst[transposed ? d * ld + q : q * ld + d] = v;
  }
}

// columns [s0, s0 + kStChunk) of C and B into (qp, kLdChunk) f32 tiles, 0 past
// Q and d_state
template <typename TX>
__device__ void stage_cb(float* Cs, float* Bs, const BwdPtrs& p, const BwdArgs& a,
                         long long bc, int s0, int qp) {
  for (int i = threadIdx.x; i < qp * kStChunk; i += kThreads) {
    const int q = i / kStChunk, c = i % kStChunk;
    const bool in = q < a.Q && s0 + c < a.st;
    const long long c_at = bc * a.cs[0] + q * a.cs[1] + (s0 + c) * a.cs[2];
    const long long b_at = bc * a.bs[0] + q * a.bs[1] + (s0 + c) * a.bs[2];
    Cs[q * kLdChunk + c] = in ? elem<TX>(p.C, c_at) : 0.f;
    Bs[q * kLdChunk + c] = in ? elem<TX>(p.B, b_at) : 0.f;
  }
}

// -- inter: G = dy . h_prev and dh_prev = (E dy)^T C over a tile of the state ---

__host__ __device__ inline size_t inter_smem_floats(int Q, int hd) {
  const int qp = round4(Q), hdp = round4(hd);
  return (size_t)qp * kLdT + (size_t)qp * (hdp + 4) + (size_t)hdp * kLdT + qp;
}

template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_inter_kernel(const BwdPtrs p, const BwdArgs a) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int qp = round4(a.Q), hdp = round4(a.hd), hdx = hdp + 4;
  float* Cs = smem;                          // (qp, kLdT): C[q, tile columns]
  float* Ys = Cs + (size_t)qp * kLdT;        // (qp, hdx): dy of the head
  float* Hs = Ys + (size_t)qp * hdx;         // (hdp, kLdT): h_prev[h, d, tile columns]
  float* Es = Hs + (size_t)hdp * kLdT;       // (qp,): exp(cum)

  const int tid = threadIdx.x, tile = blockIdx.y;
  const long long bc = blockIdx.x;
  const int g = blockIdx.z;
  const int s_base = tile * kStTile;
  const DyRows rows(a, bc);
  const int h_begin = g * a.hpb_inter, h_end = min(h_begin + a.hpb_inter, a.nh);

  for (int i = tid; i < qp * kStTile; i += kThreads) {
    const int q = i / kStTile, c = i % kStTile;
    Cs[q * kLdT + c] = q < a.Q && s_base + c < a.st
                           ? elem<TX>(p.C, bc * a.cs[0] + q * a.cs[1] + (s_base + c) * a.cs[2])
                           : 0.f;
  }

  // thread -> 4 x 4 tiles: rows (of q for G, of d for dh_prev) 4 * (r + 16 m),
  // columns 4 * c of the tile; the 16 threads of a row group are one half-warp
  const int r = tid >> 4, c0 = 4 * (tid & 15);
  float dc[2][4][4] = {};   // sum over the group's heads of E G
  for (int h = h_begin; h < h_end; ++h) {
    __syncthreads();  // C staged / the previous head's tiles read
    load_dy<TY>(Ys, hdx, false, a, p, rows, h, qp, hdp);
    for (int q = tid; q < qp; q += kThreads)
      Es[q] = q < a.Q ? expf(p.cum[bc * a.cums[0] + q * a.cums[1] + h * a.cums[2]]) : 0.f;
    const float* hb = p.h_prev + (bc * a.nh + h) * (long long)a.hd * a.st;
    for (int i = tid; i < hdp * kStTile; i += kThreads) {
      const int d = i / kStTile, c = i % kStTile;
      Hs[d * kLdT + c] = d < a.hd && s_base + c < a.st ? hb[(long long)d * a.st + s_base + c] : 0.f;
    }
    __syncthreads();

    // (every thread of a warp takes each m, for the butterfly; rows past qp read
    // rows 0 ... and are dropped)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (64 * m >= qp) break;
      const bool act = 4 * (r + 16 * m) < qp;
      const int q0 = act ? 4 * (r + 16 * m) : 0;
      float gt[4][4] = {};
      for (int d = 0; d < hdp; d += 4) {
        float4 yv[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          yv[i] = ld4(Ys + (q0 + i) * hdx + d);
          hv[i] = ld4(Hs + (d + i) * kLdT + c0);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float y = at(yv[i], k);
            gt[i][0] = fmaf(y, hv[k].x, gt[i][0]);
            gt[i][1] = fmaf(y, hv[k].y, gt[i][1]);
            gt[i][2] = fmaf(y, hv[k].z, gt[i][2]);
            gt[i][3] = fmaf(y, hv[k].w, gt[i][3]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + i;
        const float e = Es[q];
        const float4 cv = ld4(Cs + q * kLdT + c0);
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (act) dc[m][i][j] = fmaf(e, gt[i][j], dc[m][i][j]);
          part = fmaf(at(cv, j), gt[i][j], part);
        }
        // the row's sum over the tile's columns: a butterfly within the half-warp
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
        if (act && (tid & 15) == 0 && q < a.Q)
          p.ws_dcum[((bc * a.tiles + tile) * a.Q + q) * a.nh + h] = e * part;
      }
    }

    float* dh = p.dh_prev + (bc * a.nh + h) * (long long)a.hd * a.st;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int d0 = 4 * (r + 16 * m);
      if (d0 >= hdp) break;
      float acc[4][4] = {};
      for (int q = 0; q < qp; ++q) {
        const float e = Es[q];
        const float4 yv = ld4(Ys + q * hdx + d0);
        const float4 cv = ld4(Cs + q * kLdT + c0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float y = e * at(yv, i);
          acc[i][0] = fmaf(y, cv.x, acc[i][0]);
          acc[i][1] = fmaf(y, cv.y, acc[i][1]);
          acc[i][2] = fmaf(y, cv.z, acc[i][2]);
          acc[i][3] = fmaf(y, cv.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (d0 + i >= a.hd) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int sc = s_base + c0 + j;
          if (sc < a.st) dh[(long long)(d0 + i) * a.st + sc] = acc[i][j];
        }
      }
    }
  }

  float* out = p.ws_dc + ((long long)g * a.bc + bc) * a.Q * a.st;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int q0 = 4 * (r + 16 * m);
    if (q0 >= qp) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (q0 + i >= a.Q) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sc = s_base + c0 + j;
        if (sc < a.st) out[(long long)(q0 + i) * a.st + sc] = dc[m][i][j];
      }
    }
  }
}

// -- intra: the Q x Q block, dx, ddt, dcum and the group's dS -------------------

// Shared-memory floats: x and dy of a head (hdp rows of ld = qp + 4, d-major),
// the (qp, ld) tile of dW * W and then W, cum, dt and the row and column sums of
// dW * W (qp each), ddt's partials (qp x hdp / 4) and dD's (one a warp).  The
// staging of C and B columns for S (2 x qp x kLdChunk) reuses the x and dy
// region.
__host__ __device__ inline size_t intra_smem_floats(int Q, int hd) {
  const int qp = round4(Q), hdp = round4(hd), ld = qp + 4;
  const size_t xy = 2 * (size_t)hdp * ld, stage = 2 * (size_t)qp * kLdChunk;
  return (xy > stage ? xy : stage) + (size_t)qp * ld + 4 * (size_t)qp +
         (size_t)qp * (hdp / 4) + kThreads / 32;
}

// causal 4 x 4 tile k = tr (tr + 1) / 2 + tc, tc <= tr -> (tr, tc)
__device__ __forceinline__ void causal_tile(int k, int& tr, int& tc) {
  tr = (int)((sqrtf(8.f * k + 1.f) - 1.f) * 0.5f);
  while ((tr + 1) * (tr + 2) / 2 <= k) ++tr;
  while (tr * (tr + 1) / 2 > k) --tr;
  tc = k - tr * (tr + 1) / 2;
}

// NT: causal tiles a thread owns, ceil(T / kThreads) for T = n (n + 1) / 2
// tiles of a (qp / 4 = n)-tile side: 1 for Q <= 88, 2 or 3 up to 128
template <typename TX, typename TY, int NT>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_intra_kernel(const BwdPtrs p, const BwdArgs a) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int Q = a.Q, qp = round4(Q), hdp = round4(a.hd), ld = qp + 4;
  const int n = qp / 4, ntiles = n * (n + 1) / 2, ndt = hdp / 4;
  const size_t xy = 2 * (size_t)hdp * ld, stage = 2 * (size_t)qp * kLdChunk;
  float* Xt = smem;                          // (hdp, ld): x[u, d] at d * ld + u
  float* Yt = Xt + (size_t)hdp * ld;         // (hdp, ld): dy, 0 past the sequence
  float* Cs = smem;                          // (qp, kLdChunk), setup only
  float* Bs = Cs + (size_t)qp * kLdChunk;    // (qp, kLdChunk), setup only
  float* Wb = smem + (xy > stage ? xy : stage);  // (qp, ld)
  float* cum_s = Wb + (size_t)qp * ld;
  float* dt_s = cum_s + qp;
  float* rsum = dt_s + qp;
  float* csum = rsum + qp;
  float* red = csum + qp;                    // (qp, ndt)
  float* dd_red = red + (size_t)qp * ndt;    // (kThreads / 32,)

  const int tid = threadIdx.x;
  const long long bc = blockIdx.x;
  const int g = blockIdx.y;
  const DyRows rows(a, bc);
  const int h_begin = g * a.hpb_intra, h_end = min(h_begin + a.hpb_intra, a.nh);

  int tq[NT], tu[NT];  // the thread's tiles' first row and column, -1 for none
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int k = tid + t * kThreads;
    int tr = -1, tc = -1;
    if (k < ntiles) causal_tile(k, tr, tc);
    tq[t] = 4 * tr;
    tu[t] = 4 * tc;
  }

  // S = C . B^T on the thread's tiles, over chunks of the state
  float S[NT][4][4] = {};
  for (int s0 = 0; s0 < a.st; s0 += kStChunk) {
    __syncthreads();
    stage_cb<TX>(Cs, Bs, p, a, bc, s0, qp);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (tq[t] < 0) continue;
      for (int c = 0; c < kStChunk; ++c) {
        float cq[4], bu[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cq[i] = Cs[(tq[t] + i) * kLdChunk + c];
          bu[i] = Bs[(tu[t] + i) * kLdChunk + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) S[t][i][j] = fmaf(cq[i], bu[j], S[t][i][j]);
      }
    }
  }

  // entry (i, j) of tile t: on or below the diagonal, in the chunk; its decay,
  // selected, never multiplied, past the diagonal
  auto causal = [&](int t, int i, int j) { return tu[t] + j <= tq[t] + i && tq[t] + i < Q; };
  auto decay = [&](int t, int i, int j) {
    return causal(t, i, j) ? expf(cum_s[tq[t] + i] - cum_s[tu[t] + j]) : 0.f;
  };

  float dS[NT][4][4] = {};
  for (int h = h_begin; h < h_end; ++h) {
    __syncthreads();  // the previous head (or S's staging) is done with shared memory
    for (int i = tid; i < qp * hdp; i += kThreads) {
      const int u = i / hdp, d = i % hdp;
      Xt[d * ld + u] = u < Q && d < a.hd
                           ? elem<TX>(p.x, bc * a.xs[0] + u * a.xs[1] + h * a.xs[2] + d * a.xs[3])
                           : 0.f;
    }
    load_dy<TY>(Yt, ld, true, a, p, rows, h, qp, hdp);
    for (int q = tid; q < qp; q += kThreads) {
      const bool in = q < Q;
      cum_s[q] = in ? p.cum[bc * a.cums[0] + q * a.cums[1] + h * a.cums[2]] : 0.f;
      dt_s[q] = in ? p.dt[bc * a.dts[0] + q * a.dts[1] + h * a.dts[2]] : 0.f;
    }
    __syncthreads();

    // dW = dy (dt x)^T and W on the thread's tiles; dW * W to Wb, dS += dW * decay
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (tq[t] < 0) continue;
      const int q0 = tq[t], u0 = tu[t];
      float dw[4][4] = {};
      for (int d = 0; d < hdp; ++d) {
        const float4 yv = ld4(Yt + d * ld + q0);
        const float4 xv = ld4(Xt + d * ld + u0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float y = at(yv, i);
          dw[i][0] = fmaf(y, xv.x, dw[i][0]);
          dw[i][1] = fmaf(y, xv.y, dw[i][1]);
          dw[i][2] = fmaf(y, xv.z, dw[i][2]);
          dw[i][3] = fmaf(y, xv.w, dw[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float pw[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = decay(t, i, j);
          const float dwv = causal(t, i, j) ? dw[i][j] * dt_s[u0 + j] : 0.f;
          dS[t][i][j] = fmaf(dwv, e, dS[t][i][j]);
          pw[j] = dwv * (S[t][i][j] * e);
        }
        *reinterpret_cast<float4*>(Wb + (q0 + i) * ld + u0) =
            make_float4(pw[0], pw[1], pw[2], pw[3]);
      }
    }
    __syncthreads();

    // dcum's intra part: row sums minus column sums of dW * W, in a fixed order
    if (tid < qp) {
      float acc = 0.f;
      for (int u = 0; u <= tid; ++u) acc += Wb[tid * ld + u];
      rsum[tid] = acc;
    } else if (tid < 2 * qp) {
      const int u = tid - qp;
      float acc = 0.f;
      for (int q = u; q < qp; ++q) acc += Wb[q * ld + u];
      csum[u] = acc;
    }
    __syncthreads();
    if (tid < Q) {
      float inter = 0.f;
      for (int tile = 0; tile < a.tiles; ++tile)
        inter += p.ws_dcum[((bc * a.tiles + tile) * Q + tid) * a.nh + h];
      p.dcum[(bc * Q + tid) * a.nh + h] = rsum[tid] - csum[tid] + inter;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (tq[t] < 0) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4 wv;
        wv.x = S[t][i][0] * decay(t, i, 0);
        wv.y = S[t][i][1] * decay(t, i, 1);
        wv.z = S[t][i][2] * decay(t, i, 2);
        wv.w = S[t][i][3] * decay(t, i, 3);
        *reinterpret_cast<float4*>(Wb + (tq[t] + i) * ld + tu[t]) = wv;
      }
    }
    __syncthreads();

    // W^T dy on 4 x 4 tiles (u, d), lanes on neighbouring u: dx, ddt's and dD's partials
    const float Dh = p.D[h];
    float dd = 0.f;
    for (int k = tid; k < n * ndt; k += kThreads) {
      const int u0 = 4 * (k % n), d0 = 4 * (k / n);
      float acc[4][4] = {};   // [u][d]
      for (int q = u0; q < qp; q += 4) {
        float4 wv[4], yv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wv[i] = ld4(Wb + (q + i) * ld + u0);   // W[q + i, u0 ...]
          yv[i] = ld4(Yt + (d0 + i) * ld + q);   // dy[q ..., d0 + i]
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float w = at(wv[kk], i);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(w, at(yv[j], kk), acc[i][j]);
          }
      }
      float4 xv[4], yv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xv[j] = ld4(Xt + (d0 + j) * ld + u0);
        yv[j] = ld4(Yt + (d0 + j) * ld + u0);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = u0 + i;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          part = fmaf(at(xv[j], i), acc[i][j], part);
          dd = fmaf(at(yv[j], i), at(xv[j], i), dd);
        }
        red[u * ndt + d0 / 4] = part;
        if (u >= Q) continue;
        TX* dx = static_cast<TX*>(p.dx) + ((bc * Q + u) * a.nh + h) * a.hd;
        const float dtu = dt_s[u];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (d0 + j < a.hd) dx[d0 + j] = from_f32<TX>(fmaf(dtu, acc[i][j], Dh * at(yv[j], i)));
      }
    }
    // dD's partial: a butterfly within each warp, then the warps in order
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dd += __shfl_xor_sync(kFull, dd, off);
    if ((tid & 31) == 0) dd_red[tid >> 5] = dd;
    __syncthreads();
    if (tid < Q) {
      float acc = 0.f;
      for (int k = 0; k < ndt; ++k) acc += red[tid * ndt + k];
      p.ddt[(bc * Q + tid) * a.nh + h] = acc;
    } else if (tid == kThreads - 1) {
      float acc = 0.f;
      for (int k = 0; k < kThreads / 32; ++k) acc += dd_red[k];
      p.ws_dd[bc * a.nh + h] = acc;
    }
  }

  // the group's dS, its causal tiles (0 above the diagonal within them)
  float* out = p.ws_ds + ((long long)g * a.bc + bc) * Q * Q;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (tq[t] < 0) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = tq[t] + i;
      if (q >= Q) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = tu[t] + j;
        if (u < Q) out[(long long)q * Q + u] = dS[t][i][j];
      }
    }
  }
}

// -- finish: dB, dC and dD -------------------------------------------------------

__host__ __device__ inline size_t finish_smem_floats(int Q) {
  const int qp = round4(Q);
  return (size_t)qp * (qp + 1) + 2 * (size_t)qp * kLdChunk;
}

template <typename TX>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_finish_kernel(const BwdPtrs p, const BwdArgs a) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int tid = threadIdx.x, Q = a.Q, qp = round4(Q), lds = qp + 1;
  const long long bc = blockIdx.x;
  if (bc == a.bc) {  // dD, over the batch-chunks in order
    for (int h = tid; h < a.nh; h += kThreads) {
      float acc = 0.f;
      for (long long b = 0; b < a.bc; ++b) acc += p.ws_dd[b * a.nh + h];
      p.dD[h] = acc;
    }
    return;
  }
  float* dSs = smem;                        // (qp, lds)
  float* Cs = dSs + (size_t)qp * lds;       // (qp, kLdChunk)
  float* Bs = Cs + (size_t)qp * kLdChunk;
  for (int i = tid; i < qp * qp; i += kThreads) {
    const int q = i / qp, u = i % qp;
    float acc = 0.f;
    if (u <= q && q < Q)
      for (int g = 0; g < a.g_intra; ++g)
        acc += p.ws_ds[(((long long)g * a.bc + bc) * Q + q) * Q + u];
    dSs[q * lds + u] = acc;
  }
  const int c = tid & (kStChunk - 1), r0 = tid / kStChunk;
  TX* dB = static_cast<TX*>(p.dB) + bc * Q * a.st;
  TX* dC = static_cast<TX*>(p.dC) + bc * Q * a.st;
  for (int s0 = 0; s0 < a.st; s0 += kStChunk) {
    __syncthreads();  // dS summed / the previous chunk's products done
    stage_cb<TX>(Cs, Bs, p, a, bc, s0, qp);
    __syncthreads();
    const int sc = s0 + c;
    if (sc >= a.st) continue;
    for (int r = r0; r < Q; r += kThreads / kStChunk) {
      float db = 0.f, dc = 0.f;
      for (int q = r; q < Q; ++q) db = fmaf(dSs[q * lds + r], Cs[q * kLdChunk + c], db);
      for (int u = 0; u <= r; ++u) dc = fmaf(dSs[r * lds + u], Bs[u * kLdChunk + c], dc);
      for (int g = 0; g < a.g_inter; ++g)
        dc += p.ws_dc[(((long long)g * a.bc + bc) * Q + r) * a.st + sc];
      dB[(long long)r * a.st + sc] = from_f32<TX>(db);
      dC[(long long)r * a.st + sc] = from_f32<TX>(dc);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(floats * sizeof(float)));
}

template <typename TX, typename TY, int NT>
cudaError_t launch_t(const BwdPtrs& p, const BwdArgs& a, cudaStream_t stream) {
  const size_t f_inter = inter_smem_floats(a.Q, a.hd), f_intra = intra_smem_floats(a.Q, a.hd),
               f_finish = finish_smem_floats(a.Q);
  if (cudaError_t err = set_smem(ssd_bwd_inter_kernel<TX, TY>, f_inter)) return err;
  if (cudaError_t err = set_smem(ssd_bwd_intra_kernel<TX, TY, NT>, f_intra)) return err;
  if (cudaError_t err = set_smem(ssd_bwd_finish_kernel<TX>, f_finish)) return err;
  ssd_bwd_inter_kernel<TX, TY><<<dim3(a.bc, a.tiles, a.g_inter), kThreads,
                                 f_inter * sizeof(float), stream>>>(p, a);
  if (cudaError_t err = cudaGetLastError()) return err;
  ssd_bwd_intra_kernel<TX, TY, NT><<<dim3(a.bc, a.g_intra), kThreads,
                                     f_intra * sizeof(float), stream>>>(p, a);
  if (cudaError_t err = cudaGetLastError()) return err;
  ssd_bwd_finish_kernel<TX><<<a.bc + 1, kThreads, f_finish * sizeof(float), stream>>>(p, a);
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t launch_nt(const BwdPtrs& p, const BwdArgs& a, cudaStream_t stream) {
  const int n = round4(a.Q) / 4, tiles = n * (n + 1) / 2;
  if (tiles <= kThreads) return launch_t<TX, TY, 1>(p, a, stream);
  if (tiles <= 2 * kThreads) return launch_t<TX, TY, 2>(p, a, stream);
  return launch_t<TX, TY, 3>(p, a, stream);
}

}  // namespace

// x (bc, Q, nh, hd), B and C (bc, Q, st) in `dtype`, read through the 16
// element strides in `strides` (x 4, dt 3, cum 3, B 3, C 3); dt and cum (bc, Q,
// nh) f32; h_prev (bc, nh, hd, st) and D (nh,) f32 contiguous; dy (b, s, nh, hd)
// contiguous in `dy_dtype` (f32, or bf16 for bf16 inputs).  Writes dx (bc, Q,
// nh, hd), dB and dC (bc, Q, st) in `dtype`; ddt and dcum (bc, Q, nh), dh_prev
// (bc, nh, hd, st) and dD (nh,) in f32; all contiguous.  `ws` holds the f32
// workspace of the header, in that order, for `tiles` = ceil(st / 64) and the
// head groups `g_inter` / `g_intra` of `hpb_inter` / `hpb_intra` heads.  Three
// launches; returns the first failing launch's cudaError_t.
extern "C" int ssd_chunk_scan_bwd(const void* x, const float* dt, const float* cum, const void* B,
                                  const void* C, const float* h_prev, const float* D,
                                  const void* dy, void* dx, float* ddt, float* dcum, void* dB,
                                  void* dC, float* dh_prev, float* dD, float* ws, int bc, int nc,
                                  int s, int Q, int nh, int hd, int st, const long long* strides,
                                  int dtype, int dy_dtype, int g_inter, int hpb_inter,
                                  int g_intra, int hpb_intra, int device, void* stream) {
  if (bc == 0 || Q == 0 || nh == 0 || hd == 0) return cudaSuccess;
  if (Q < 0 || Q > 128 || hd < 0 || hd > 128 || st < 1 || st > 512 || nh < 0 || nc < 1 ||
      g_inter < 1 || g_inter > 65535 || g_intra < 1 || g_intra > 65535 ||
      (long long)g_inter * hpb_inter < nh || (long long)g_intra * hpb_intra < nh)
    return cudaErrorInvalidValue;
  if (cudaError_t err = cudaSetDevice(device)) return err;
  BwdArgs a{bc, Q, nh, hd, st, nc, s, (st + kStTile - 1) / kStTile,
            g_inter, hpb_inter, g_intra, hpb_intra, {}, {}, {}, {}, {}};
  for (int i = 0; i < 4; ++i) a.xs[i] = strides[i];
  for (int i = 0; i < 3; ++i) {
    a.dts[i] = strides[4 + i];
    a.cums[i] = strides[7 + i];
    a.bs[i] = strides[10 + i];
    a.cs[i] = strides[13 + i];
  }
  float* ws_dc = ws + (size_t)bc * a.tiles * Q * nh;
  float* ws_ds = ws_dc + (size_t)g_inter * bc * Q * st;
  float* ws_dd = ws_ds + (size_t)g_intra * bc * Q * Q;
  const BwdPtrs p{x, dt, cum, B, C, h_prev, D, dy, dx, ddt, dcum, dB, dC, dh_prev, dD,
                  ws, ws_dc, ws_ds, ws_dd};
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && dy_dtype == kFloat32) return launch_nt<float, float>(p, a, sm);
  if (dtype == kBFloat16 && dy_dtype == kFloat32)
    return launch_nt<__nv_bfloat16, float>(p, a, sm);
  if (dtype == kBFloat16 && dy_dtype == kBFloat16)
    return launch_nt<__nv_bfloat16, __nv_bfloat16>(p, a, sm);
  return cudaErrorInvalidValue;
}
