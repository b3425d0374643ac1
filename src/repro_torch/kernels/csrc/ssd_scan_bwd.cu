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
// ~89 GFLOP, take 0.09 ms at the bf16 tensor-core peak (twice that with the
// f32 operands split, below), so it is bound by bytes; on the CUDA cores in
// f32 they take 1.33 ms at 67 TFLOP/s.
//
// Two sets of kernels, three launches each, in stream order: inter (the
// h_prev terms), intra (the Q x Q block) and finish (dB, dC and dD).  No float
// atomics: every cross-block sum goes through f32 partials in the workspace
// and is added in a fixed order, so two calls give the same bits.  The
// workspace (the wrapper's, f32): dcum's inter part (bc, tiles, Q, nh), dC's
// (groups, bc, Q, st), dS (groups, bc, Q, Q) and dD (bc, nh).  Rows q >= s
// get dy = 0, so every output row there is exactly 0.  Masked entries are
// selected to 0 and never exponentiated: above the diagonal (and past Q) the
// exponent is positive and can overflow, and inf * 0 is NaN.
//
// * bf16 x, B, C and dy (the training dtype), on the tensor cores
//   (ssd_bwd_*_bf16_kernel): mma.sync.m16n8k16 with f32 accumulators
//   (mma.cuh), the forward's design (ssd_scan.cu).  Operands that are bf16
//   already (dy, x, B, C) take one product; f32 operands are split into bf16
//   hi + lo and take two on the other operand's one fragment (split_bf16):
//   W in W^T dy, h_prev in G, E C in dh_prev, dS in dB and dC.  One rounding
//   of any of them would still meet the bf16 tolerance (3e-2 of each output's
//   scale) but puts ddt, dcum or dh_prev 3x to 20x past the f32 kernels' 1e-4;
//   the split keeps them there (tests/test_torch_ssd_bwd_bf16.py models it).
//   - inter (grid: bc x state tiles x head groups; 8 warps): a block's state
//     tile is 128 columns (Q <= 64 and d_state > 64) or 64, each warp 16 or 8
//     of them; its heads run one after another, all warps on the same head.
//     Per head, G = dy . h_prev (dy the A fragment, h_prev the B fragment read
//     from shared memory as f32 and split); E G is summed over the group's
//     heads in the accumulator registers and written once (the group's part
//     of dC), and sum_s C G, from the same registers, by quad shuffles and a
//     fixed-order sum over the 8 warps (dcum's inter part, times E).  Then
//     dh_prev = dy^T (E C): dy^T by ldmatrix.trans, E C built in registers
//     from C's fragments, split; stored from the accumulators as float2 rows.
//     h_prev (32 KB a head at the training shape), dy and cum come in by
//     cp.async into a ring of two stages: head h+1's land while head h
//     computes.  The block meets at two barriers a head (every warp shares
//     the head).
//   - intra (grid: bc x head groups; 4 warps): rows u of W^T, so that W^T,
//     built in the registers from S^T, is the A fragment of W^T dy, as
//     attention's P is of P V.  A warp owns a short and a long 16-row u tile
//     ({0, 3} and {1, 2} at Q 64) and their causal q chunks, so every warp
//     has the same work; two warps a head at Q <= 64, so a block runs two
//     heads at a time ("slots", as the forward), four warps at Q 128.
//     S^T = B C^T once a block by mma.sync, kept in shared memory in
//     fragment order (a warp's float4s, no bank conflicts).  Per head and
//     tile: dW'^T = x dy^T (one product), W^T and dW^T = dW'^T dt_u (masked)
//     in registers, dS^T += dW^T decay in a slot's fragment-order tile, and
//     W^T dy with W^T split; dx = dt (W^T dy) + D dy and ddt from the
//     accumulators, so no dt x product is rounded.  dx goes over the warp's
//     own rows of the x tile and leaves in 16-byte stores (4-byte stores of
//     the accumulator pairs were slower).  dcum's row sums of
//     dW * W are quad shuffles over the accumulator fragments; its column
//     sums are shuffles over a tile's rows and a fixed-order sum over the
//     u tiles.  x, dy, cum and dt come in by cp.async into a ring of two
//     stages a slot; a slot's warps meet at named barriers (bar.sync of 64
//     or 128 threads), twice a head.  Two blocks an SM, as the inter launch.
//   - finish (grid: bc + 1): dS summed over the intra groups into bf16 hi +
//     lo tiles; dB = dS^T C and dC = dS B by mma.sync over the causal
//     chunks, 64 state columns at a time, plus the inter groups' parts of dC;
//     the last block sums dD over bc.
//   - Why mma.sync and not wgmma: as in the forward, each head's products
//     are one chunk deep with a causal half, and the function is bound by
//     bytes.
//   - Shared memory: every Q <= 128, head_dim <= 128 and d_state <= 512
//     fits (the largest, the intra launch at Q 128 and head_dim 128, takes
//     215 KB); a layout past a block's 227 KB would be refused with
//     cudaErrorInvalidValue before any launch.
// * f32, and bf16 inputs with an f32 dy (ssd_bwd_{inter,intra,finish}_kernel):
//   f32 FMAs on the CUDA cores, as the forward's f32 kernel, operands staged
//   in shared memory as f32, each thread a 4 x 4 tile of an output.  They
//   serve the f32 gradient checks; an f32 dy keeps this path rather than
//   split dy.
//   - inter (grid: bc x 64-column tiles of the state x head groups): per head,
//     G = dy . h_prev and dh_prev = (E dy)^T C over the tile's columns.
//   - intra (grid: bc x head groups): S computed once a block into registers,
//     each thread owning up to three causal 4 x 4 tiles of it; per head, dW
//     and W on the same tiles, dW * W to shared memory for dcum's row and
//     column sums, then W for dx = dt W^T dy + D dy and ddt.
//   - finish: dB = dS^T C and dC = dS B, one thread an output.
//
// Inputs are read through their strides (the model passes slices of its conv
// output); dy (b, s, nh, hd), h_prev (bc, nh, hd, st) and D contiguous;
// outputs contiguous.  The bf16 kernels copy rows of x, dy, B and C 16 bytes
// at a time when head_dim and d_state are multiples of 8 (the wrapper checks
// 16-byte alignment and raises on a misaligned view; `vec`), else element by
// element.  Any Q <= 128, head_dim <= 128 and d_state <= 512.

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

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
  int tiles;                    // state tiles of an inter block (the wrapper's plan)
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

// -- f32 on the CUDA cores ---------------------------------------------------------

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

// -- bf16 on the tensor cores ------------------------------------------------------

using bf16 = __nv_bfloat16;
using mma::a_col;
using mma::a_row;
using mma::b_col;
using mma::b_row;

constexpr int kInterWarps = 8;
constexpr int kInterThreads = 32 * kInterWarps;
constexpr int kTcThreads = 128;       // intra and finish: 4 warps
constexpr int kStages = 2;            // the inter and intra rings: head h+1 lands during head h
constexpr int kSetupCols = 128;       // state columns the intra launch stages for S at a time
constexpr int kFinishCols = 64;       // state columns a finish pass stages
constexpr size_t kMaxSmem = 232448;   // a block's dynamic shared memory on sm_90
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~(size_t)15; }

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// causal 16 x 16 tile T of the u-oriented upper triangle (u tile i, q chunk j
// >= i, row-major) <-> (i, j)
__device__ __forceinline__ int tile_index(int QT, int i, int j) {
  return i * QT - i * (i - 1) / 2 + (j - i);
}

__device__ __forceinline__ void tile_of(int QT, int T, int& i, int& j) {
  i = 0;
  while (T >= QT - i) {
    T -= QT - i;
    ++i;
  }
  j = i + T;
}

// Fragment order of a 16 x 16 f32 tile held as two n8 accumulators: element e
// of n-tile n of lane l at n * 128 + l * 4 + e, so a warp's float4 reads and
// writes touch every bank once.
__device__ __forceinline__ void frag_store(float* tile, const float (&v)[2][4], int lane) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
    *reinterpret_cast<float4*>(tile + n * 128 + lane * 4) =
        make_float4(v[n][0], v[n][1], v[n][2], v[n][3]);
}

// Two f32 values to a row of an f32 output at column c (< cols), as a pair
// where the row holds one.
__device__ __forceinline__ void store2(float* row, int c, int cols, float v0, float v1) {
  if (c + 1 < cols && cols % 2 == 0) {
    *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
  } else {
    if (c < cols) row[c] = v0;
    if (c + 1 < cols) row[c + 1] = v1;
  }
}

__device__ __forceinline__ void store2(bf16* row, int c, int cols, float v0, float v1) {
  if (c + 1 < cols && cols % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (c < cols) row[c] = __float2bfloat16(v0);
    if (c + 1 < cols) row[c + 1] = __float2bfloat16(v1);
  }
}

// -- inter: G = dy . h_prev and dh_prev = dy^T (E C) over a tile of the state ---

// Shared memory of an inter block: C's columns of the tile (qp rows of stt + 8
// bf16), a ring of kStages stages of (dy: qp rows of hdp + 8 bf16; cum: qp f32;
// h_prev: hdp rows of stt + 4 f32), and the warps' dcum partials (8 x qp f32).
// h_prev rows padded by 4 floats: the B-fragment reads of a warp (rows 2t, 2t +
// 1, 2t + 8, 2t + 9, columns g) fall in distinct banks.
struct InterLayout {
  int qp, hdp, stt, ldc, ldy, ldh;
  size_t cum_off, h_off, stage, ring_off, red_off, bytes;
};

__host__ __device__ inline InterLayout inter_layout(int QT, int NS, int hd) {
  InterLayout l;
  l.qp = QT * 16;
  l.hdp = round16(hd);
  l.stt = 64 * NS;
  l.ldc = l.stt + 8;
  l.ldy = l.hdp + 8;
  l.ldh = l.stt + 4;
  l.cum_off = align16((size_t)l.qp * l.ldy * sizeof(bf16));
  l.h_off = align16(l.cum_off + (size_t)l.qp * sizeof(float));
  l.stage = align16(l.h_off + (size_t)l.hdp * l.ldh * sizeof(float));
  l.ring_off = align16((size_t)l.qp * l.ldc * sizeof(bf16));
  l.red_off = l.ring_off + kStages * l.stage;
  l.bytes = l.red_off + (size_t)kInterWarps * l.qp * sizeof(float);
  return l;
}

// h_prev rows [0, rows_p) x columns [s0, s0 + cols_p) of a (hd, st) f32 source
// into a padded tile, zero past hd and st: 16 bytes a cp.async where st is a
// multiple of 4 (rows 16-byte aligned), else element by element.
__device__ __forceinline__ void load_h_tile(float* dst, int ld, const float* src, int hd, int st,
                                            int s0, int rows_p, int cols_p, int tid,
                                            int nthreads) {
  const int groups = cols_p / 4;
  const bool vec = st % 4 == 0;
  for (int i = tid; i < rows_p * groups; i += nthreads) {
    const int d = i / groups, c = (i % groups) * 4, s = s0 + c;
    float* out = dst + d * ld + c;
    if (vec) {
      const bool ok = d < hd && s < st;
      mma::cp_async_16(out, ok ? src + (long long)d * st + s : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[e] = d < hd && s + e < st ? src[(long long)d * st + s + e] : 0.f;
    }
  }
}

// QT: 16-row q tiles (4 for Q <= 64, 8 for Q <= 128); NS: n8 tiles of the
// state a warp owns (the block's tile is 64 NS columns)
template <int QT, int NS>
__global__ void __launch_bounds__(kInterThreads)
ssd_bwd_inter_bf16_kernel(const BwdPtrs p, const BwdArgs a, const int vec) {
  const InterLayout L = inter_layout(QT, NS, a.hd);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + L.red_off);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const long long bc = blockIdx.x;
  const int tile = blockIdx.y, grp = blockIdx.z;
  const int s_base = tile * L.stt;
  const int n_base = warp * 8 * NS;  // the warp's columns within the tile
  const DyRows rows(a, bc);
  const int h_begin = grp * a.hpb_inter, h_end = min(h_begin + a.hpb_inter, a.nh);
  const int n_heads = max(0, h_end - h_begin);
  const bf16* dyb = static_cast<const bf16*>(p.dy) + rows.first * a.nh * a.hd;
  auto stage = [&](int j) { return smem + L.ring_off + (j % kStages) * L.stage; };
  auto issue = [&](int j) {  // dy, cum and h_prev of the group's head j
    const int h = h_begin + j;
    unsigned char* st = stage(j);
    mma::load_rows(reinterpret_cast<bf16*>(st), L.ldy, dyb + (long long)h * a.hd,
                   (long long)a.nh * a.hd, 1, rows.rows, a.hd, L.qp, L.hdp, vec, tid,
                   kInterThreads);
    float* cum = reinterpret_cast<float*>(st + L.cum_off);
    for (int r = tid; r < L.qp; r += kInterThreads) {
      const bool ok = r < a.Q;
      mma::cp_async_4(cum + r, ok ? p.cum + bc * a.cums[0] + r * a.cums[1] + h * a.cums[2] : p.cum,
                      ok);
    }
    load_h_tile(reinterpret_cast<float*>(st + L.h_off), L.ldh,
                p.h_prev + (bc * a.nh + h) * (long long)a.hd * a.st, a.hd, a.st, s_base, L.hdp,
                L.stt, tid, kInterThreads);
  };

  mma::load_rows(Cs, L.ldc, static_cast<const bf16*>(p.C) + bc * a.cs[0] + s_base * a.cs[2],
                 a.cs[1], a.cs[2], a.Q, a.st - s_base, L.qp, L.stt, vec, tid, kInterThreads);
  if (n_heads > 0) issue(0);
  mma::cp_async_commit();

  float dc[QT][NS][4];  // sum over the group's heads of E G, rows q, the warp's columns
#pragma unroll
  for (int m = 0; m < QT; ++m)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dc[m][n][e] = 0.f;

  for (int j = 0; j < n_heads; ++j) {
    const int h = h_begin + j;
    mma::cp_async_wait<0>();  // head j has landed, for this thread
    __syncthreads();          // ... for every thread; all are done with head j - 1
    if (j + 1 < n_heads) issue(j + 1);
    mma::cp_async_commit();
    const unsigned char* st = stage(j);
    const bf16* Ys = reinterpret_cast<const bf16*>(st);
    const float* cum = reinterpret_cast<const float*>(st + L.cum_off);
    const float* Hs = reinterpret_cast<const float*>(st + L.h_off);

    // G = dy . h_prev: dy the A fragment (rows q, k = d), h_prev the B fragment
    // (k = d, n = state) read as f32 and split into bf16 hi + lo
    float G[QT][NS][4];
#pragma unroll
    for (int m = 0; m < QT; ++m)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) G[m][n][e] = 0.f;
    for (int kc = 0; kc < L.hdp / 16; ++kc) {
      uint32_t bh[NS][2], bl[NS][2];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float* hp = Hs + (kc * 16 + 2 * t) * L.ldh + n_base + n * 8 + g;
        mma::split_bf16(hp[0], hp[L.ldh], bh[n][0], bl[n][0]);
        mma::split_bf16(hp[8 * L.ldh], hp[9 * L.ldh], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int m = 0; m < QT; ++m) {
        uint32_t af[4];
        mma::ldmatrix_x4(af, Ys + (m * 16 + a_row(lane)) * L.ldy + kc * 16 + a_col(lane));
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          mma::mma_bf16(G[m][n], af, bh[n][0], bh[n][1]);
          mma::mma_bf16(G[m][n], af, bl[n][0], bl[n][1]);
        }
      }
    }

    // dC's part += E G; dcum's part, sum_s C G over the warp's columns: a quad
    // shuffle, then the warps in order below
#pragma unroll
    for (int m = 0; m < QT; ++m) {
      const int q0 = m * 16 + g, q1 = q0 + 8;
      const float e0 = exp2f(cum[q0] * kLog2e), e1 = exp2f(cum[q1] * kLog2e);
      float part0 = 0.f, part1 = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int c = n_base + n * 8 + 2 * t;
        const float2 c0 = bf2(Cs + q0 * L.ldc + c), c1 = bf2(Cs + q1 * L.ldc + c);
        dc[m][n][0] = fmaf(e0, G[m][n][0], dc[m][n][0]);
        dc[m][n][1] = fmaf(e0, G[m][n][1], dc[m][n][1]);
        dc[m][n][2] = fmaf(e1, G[m][n][2], dc[m][n][2]);
        dc[m][n][3] = fmaf(e1, G[m][n][3], dc[m][n][3]);
        part0 = fmaf(c0.y, G[m][n][1], fmaf(c0.x, G[m][n][0], part0));
        part1 = fmaf(c1.y, G[m][n][3], fmaf(c1.x, G[m][n][2], part1));
      }
      part0 += __shfl_xor_sync(kFull, part0, 1);
      part0 += __shfl_xor_sync(kFull, part0, 2);
      part1 += __shfl_xor_sync(kFull, part1, 1);
      part1 += __shfl_xor_sync(kFull, part1, 2);
      if (t == 0) {
        red[warp * L.qp + q0] = part0;
        red[warp * L.qp + q1] = part1;
      }
    }

    // dh_prev = dy^T (E C): dy^T the A fragment (rows d, k = q) by ldmatrix.trans;
    // E C the B fragment (k = q, n = state), built from C's and split
    uint32_t ech[QT][NS][2], ecl[QT][NS][2];
#pragma unroll
    for (int kc = 0; kc < QT; ++kc) {
      const int q = kc * 16 + 2 * t;
      const float ea = exp2f(cum[q] * kLog2e), eb = exp2f(cum[q + 1] * kLog2e);
      const float ec = exp2f(cum[q + 8] * kLog2e), ed = exp2f(cum[q + 9] * kLog2e);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t cf[2];
        mma::ldmatrix_x2_trans(cf, Cs + (kc * 16 + a_row(lane)) * L.ldc + n_base + n * 8);
        const float2 v0 = bf2(cf[0]), v1 = bf2(cf[1]);
        mma::split_bf16(ea * v0.x, eb * v0.y, ech[kc][n][0], ecl[kc][n][0]);
        mma::split_bf16(ec * v1.x, ed * v1.y, ech[kc][n][1], ecl[kc][n][1]);
      }
    }
    float* dh = p.dh_prev + (bc * a.nh + h) * (long long)a.hd * a.st;
    for (int md = 0; md < L.hdp / 16; ++md) {
      float acc[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < QT; ++kc) {
        uint32_t af[4];
        mma::ldmatrix_x4_trans(af, Ys + (kc * 16 + b_row(lane)) * L.ldy + md * 16 + b_col(lane));
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          mma::mma_bf16(acc[n], af, ech[kc][n][0], ech[kc][n][1]);
          mma::mma_bf16(acc[n], af, ecl[kc][n][0], ecl[kc][n][1]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = md * 16 + g + 8 * half;
        if (d >= a.hd) continue;
#pragma unroll
        for (int n = 0; n < NS; ++n)
          store2(dh + (long long)d * a.st, s_base + n_base + n * 8 + 2 * t, a.st,
                 acc[n][2 * half], acc[n][2 * half + 1]);
      }
    }

    __syncthreads();  // every warp's dcum partial is in
    if (tid < a.Q) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kInterWarps; ++w) acc += red[w * L.qp + tid];
      p.ws_dcum[((bc * a.tiles + tile) * a.Q + tid) * a.nh + h] = exp2f(cum[tid] * kLog2e) * acc;
    }
  }

  // the group's part of dC
  float* out = p.ws_dc + ((long long)grp * a.bc + bc) * a.Q * a.st;
#pragma unroll
  for (int m = 0; m < QT; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = m * 16 + g + 8 * half;
      if (q >= a.Q) continue;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        store2(out + (long long)q * a.st, s_base + n_base + n * 8 + 2 * t, a.st,
               dc[m][n][2 * half], dc[m][n][2 * half + 1]);
    }
}

// -- intra: the Q x Q block, dx, ddt, dcum and the group's dS -------------------

// Shared memory of an intra block for QT q tiles and head dim HD: S^T's causal
// tiles in fragment order (f32), the slots' dS^T tiles likewise, a ring of
// kStages stages a slot of (x, dy: qp rows of HD + 8 bf16; cum, dt: qp f32),
// which S's staging of B and C (2 x qp rows of kSetupCols + 8 bf16) shares
// before the first head; the slots' dcum column partials (QT x qp f32), row
// sums (qp) and dD partials (one a warp).
struct IntraLayout {
  int qp, ldx, lds, ntile, slots;
  size_t ds_off, ring_off, y_off, cum_off, stage, col_off, row_off, dd_off, bytes;
};

__host__ __device__ inline IntraLayout intra_layout(int QT, int HD) {
  IntraLayout l;
  l.qp = QT * 16;
  l.ldx = HD + 8;
  l.lds = kSetupCols + 8;
  l.ntile = QT * (QT + 1) / 2;
  l.slots = 8 / QT;
  l.ds_off = (size_t)l.ntile * 256 * sizeof(float);
  l.ring_off = l.ds_off + (size_t)l.slots * l.ntile * 256 * sizeof(float);
  l.y_off = (size_t)l.qp * l.ldx * sizeof(bf16);
  l.cum_off = 2 * l.y_off;
  l.stage = l.cum_off + 2 * (size_t)l.qp * sizeof(float);
  const size_t ring = (size_t)kStages * l.slots * l.stage;
  const size_t staging = 2 * (size_t)l.qp * l.lds * sizeof(bf16);
  l.col_off = l.ring_off + (ring > staging ? ring : staging);
  l.row_off = l.col_off + (size_t)l.slots * QT * l.qp * sizeof(float);
  l.dd_off = l.row_off + (size_t)l.slots * l.qp * sizeof(float);
  l.bytes = align16(l.dd_off + (size_t)4 * sizeof(float));
  return l;
}

// QT: 16-row tiles (4 for Q <= 64, 8 for Q <= 128); HD: head_dim padded to 32,
// 64 or 128
template <int QT, int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_bwd_intra_bf16_kernel(const BwdPtrs p, const BwdArgs a, const int vec) {
  constexpr int PAIRS = QT / 2;    // warps a head takes: one short and one long u tile each
  constexpr int SLOTS = 8 / QT;    // heads a block runs at once
  constexpr int NTILE = QT * (QT + 1) / 2;
  constexpr int KT = (NTILE + 3) / 4;  // S tiles a warp computes
  constexpr int ND = HD / 8;       // n-tiles of a dx row
  constexpr int SLOT_THREADS = 32 * PAIRS;
  const IntraLayout L = intra_layout(QT, HD);
  extern __shared__ __align__(16) unsigned char smem[];
  float* Sf = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int slot = warp / PAIRS, pair = warp % PAIRS;
  const int stid = tid - slot * SLOT_THREADS;  // thread within the slot
  const long long bc = blockIdx.x;
  const int grp = blockIdx.y, Q = a.Q, QP = L.qp, LDX = L.ldx;
  const DyRows rows(a, bc);
  float* dSf = reinterpret_cast<float*>(smem + L.ds_off) + slot * NTILE * 256;
  float* colp = reinterpret_cast<float*>(smem + L.col_off) + slot * QT * QP;
  float* rowp = reinterpret_cast<float*>(smem + L.row_off) + slot * QP;
  float* ddp = reinterpret_cast<float*>(smem + L.dd_off) + slot * PAIRS;
  const int h_begin = grp * a.hpb_intra, h_end = min(h_begin + a.hpb_intra, a.nh);
  const int n_heads = h_end - h_begin > slot ? (h_end - h_begin - slot + SLOTS - 1) / SLOTS : 0;
  auto head = [&](int j) { return h_begin + slot + j * SLOTS; };

  // S^T = B C^T once a block, B the A fragment (rows u), C the B fragment
  // (n = q); tile T = warp + 4 k of the causal tiles, state staged kSetupCols
  // columns at a time
  {
    bf16* Bst = reinterpret_cast<bf16*>(smem + L.ring_off);
    bf16* Cst = Bst + QP * L.lds;
    float acc[KT][2][4];
#pragma unroll
    for (int k = 0; k < KT; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][0][e] = acc[k][1][e] = 0.f;
    for (int s0 = 0; s0 < a.st; s0 += kSetupCols) {
      const int cols = min(kSetupCols, round16(a.st - s0));
      __syncthreads();  // the previous chunk's products are done
      mma::load_rows(Bst, L.lds, static_cast<const bf16*>(p.B) + bc * a.bs[0] + s0 * a.bs[2],
                     a.bs[1], a.bs[2], Q, a.st - s0, QP, cols, vec, tid, kTcThreads);
      mma::load_rows(Cst, L.lds, static_cast<const bf16*>(p.C) + bc * a.cs[0] + s0 * a.cs[2],
                     a.cs[1], a.cs[2], Q, a.st - s0, QP, cols, vec, tid, kTcThreads);
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const int T = warp + 4 * k;
        if (T >= NTILE) continue;
        int i, j;
        tile_of(QT, T, i, j);
        for (int kc = 0; kc < cols / 16; ++kc) {
          uint32_t af[4], bf[4];
          mma::ldmatrix_x4(af, Bst + (i * 16 + a_row(lane)) * L.lds + kc * 16 + a_col(lane));
          mma::ldmatrix_x4(bf, Cst + (j * 16 + b_row(lane)) * L.lds + kc * 16 + b_col(lane));
          mma::mma_bf16(acc[k][0], af, bf[0], bf[1]);
          mma::mma_bf16(acc[k][1], af, bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int T = warp + 4 * k;
      if (T < NTILE) frag_store(Sf + T * 256, acc[k], lane);
    }
    float* dS0 = reinterpret_cast<float*>(smem + L.ds_off);
    for (int i = tid; i < SLOTS * NTILE * 256; i += kTcThreads) dS0[i] = 0.f;
    __syncthreads();  // S stored; the staging space is the ring's from here
  }

  const bf16* xb = static_cast<const bf16*>(p.x) + bc * a.xs[0];
  const bf16* dyb = static_cast<const bf16*>(p.dy) + rows.first * a.nh * a.hd;
  auto stage = [&](int j) {
    return smem + L.ring_off + ((j % kStages) * SLOTS + slot) * L.stage;
  };
  auto issue = [&](int j) {  // x, dy, cum and dt of the slot's head j
    const int h = head(j);
    unsigned char* st = stage(j);
    mma::load_rows(reinterpret_cast<bf16*>(st), LDX, xb + h * a.xs[2], a.xs[1], a.xs[3], Q, a.hd,
                   QP, HD, vec, stid, SLOT_THREADS);
    mma::load_rows(reinterpret_cast<bf16*>(st + L.y_off), LDX, dyb + (long long)h * a.hd,
                   (long long)a.nh * a.hd, 1, rows.rows, a.hd, QP, HD, vec, stid, SLOT_THREADS);
    float* f = reinterpret_cast<float*>(st + L.cum_off);
    for (int r = stid; r < QP; r += SLOT_THREADS) {
      const bool ok = r < Q;
      mma::cp_async_4(f + r, ok ? p.cum + bc * a.cums[0] + r * a.cums[1] + h * a.cums[2] : p.cum,
                      ok);
      mma::cp_async_4(f + QP + r, ok ? p.dt + bc * a.dts[0] + r * a.dts[1] + h * a.dts[2] : p.dt,
                      ok);
    }
  };
  if (n_heads > 0) issue(0);
  mma::cp_async_commit();

  for (int j = 0; j < n_heads; ++j) {
    const int h = head(j);
    mma::cp_async_wait<0>();                // head j has landed, for this thread
    mma::bar_sync(1 + slot, SLOT_THREADS);  // ... for the slot; it is done with head j - 1
    if (j + 1 < n_heads) issue(j + 1);
    mma::cp_async_commit();
    const unsigned char* st = stage(j);
    const bf16* Xs = reinterpret_cast<const bf16*>(st);
    const bf16* Ys = reinterpret_cast<const bf16*>(st + L.y_off);
    const float* cum = reinterpret_cast<const float*>(st + L.cum_off);
    const float* dt = cum + QP;
    const float Dh = p.D[h];
    // dcum's inter part, summed over the state tiles, read ahead of its use
    float inter = 0.f;
    if (stid < Q)
      for (int tl = 0; tl < a.tiles; ++tl)
        inter += p.ws_dcum[((bc * a.tiles + tl) * Q + stid) * a.nh + h];
    bf16* dx = static_cast<bf16*>(p.dx) + (bc * Q * a.nh + h) * (long long)a.hd;
    float dd = 0.f;  // dD's partial: sum dy x over the warp's rows

    for (int rr = 0; rr < 2; ++rr) {
      const int r = rr ? QT - 1 - pair : pair;  // the u tile
      const int u0 = r * 16 + g, u1 = u0 + 8;
      const float cu0 = cum[u0], cu1 = cum[u1], dt0 = dt[u0], dt1 = dt[u1];
      float out[ND][4];  // W^T dy, rows u, columns d
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[n][e] = 0.f;
      float sub0 = 0.f, sub1 = 0.f;  // sum_q P[q, u] for rows u0, u1 (P = dW * W)
      for (int jc = r; jc < QT; ++jc) {
        const int T = tile_index(QT, r, jc);
        // dW'^T = x dy^T: x the A fragment (rows u, k = d), dy the B fragment (n = q)
        float dw[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kc = 0; kc < HD / 16; ++kc) {
          uint32_t af[4], bf[4];
          mma::ldmatrix_x4(af, Xs + (r * 16 + a_row(lane)) * LDX + kc * 16 + a_col(lane));
          mma::ldmatrix_x4(bf, Ys + (jc * 16 + b_row(lane)) * LDX + kc * 16 + b_col(lane));
          mma::mma_bf16(dw[0], af, bf[0], bf[1]);
          mma::mma_bf16(dw[1], af, bf[2], bf[3]);
        }
        // per n-tile of the tile: W^T, dW^T * W^T's sums, dS^T, and W^T's half
        // of the A fragment (rows u, k = q) of W^T dy, split
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float* sd = dSf + T * 256 + n * 128 + lane * 4;
          const float4 sv = *reinterpret_cast<const float4*>(Sf + T * 256 + n * 128 + lane * 4);
          float4 dsv = *reinterpret_cast<const float4*>(sd);
          const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
          float ds4[4] = {dsv.x, dsv.y, dsv.z, dsv.w}, w[4], add[2] = {0.f, 0.f};
          const int q = jc * 16 + n * 8 + 2 * t;
          const float2 cq = *reinterpret_cast<const float2*>(cum + q);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int uu = e < 2 ? u0 : u1, qq = q + (e & 1);
            // selected, never multiplied: past the diagonal and past Q the
            // exponent can be positive
            const bool ok = qq >= uu && qq < Q;
            const float dec =
                ok ? exp2f(((e & 1 ? cq.y : cq.x) - (e < 2 ? cu0 : cu1)) * kLog2e) : 0.f;
            const float dwv = ok ? dw[n][e] * (e < 2 ? dt0 : dt1) : 0.f;
            w[e] = s4[e] * dec;
            const float pv = dwv * w[e];
            if (e < 2) sub0 += pv; else sub1 += pv;
            add[e & 1] += pv;
            ds4[e] = fmaf(dwv, dec, ds4[e]);
          }
          *reinterpret_cast<float4*>(sd) = make_float4(ds4[0], ds4[1], ds4[2], ds4[3]);
          // sum_u P[q, u] over the tile's 16 rows, per column q: over g
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v = add[c];
            v += __shfl_xor_sync(kFull, v, 4);
            v += __shfl_xor_sync(kFull, v, 8);
            v += __shfl_xor_sync(kFull, v, 16);
            if (g == 0) colp[r * QP + jc * 16 + n * 8 + 2 * t + c] = v;
          }
          mma::split_bf16(w[0], w[1], hi[2 * n], lo[2 * n]);          // row g
          mma::split_bf16(w[2], w[3], hi[2 * n + 1], lo[2 * n + 1]);  // row g + 8
        }
        // W^T dy: dy the B fragment (k = q, n = d) by ldmatrix.trans
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bf[4];
          mma::ldmatrix_x4_trans(bf, Ys + (jc * 16 + a_row(lane)) * LDX + dp * 16 + a_col(lane));
          mma::mma_bf16(out[2 * dp], hi, bf[0], bf[1]);
          mma::mma_bf16(out[2 * dp + 1], hi, bf[2], bf[3]);
          mma::mma_bf16(out[2 * dp], lo, bf[0], bf[1]);
          mma::mma_bf16(out[2 * dp + 1], lo, bf[2], bf[3]);
        }
      }
      sub0 += __shfl_xor_sync(kFull, sub0, 1);
      sub0 += __shfl_xor_sync(kFull, sub0, 2);
      sub1 += __shfl_xor_sync(kFull, sub1, 1);
      sub1 += __shfl_xor_sync(kFull, sub1, 2);
      if (t == 0) {
        rowp[u0] = sub0;
        rowp[u1] = sub1;
      }

      // dx = dt (W^T dy) + D dy, ddt = sum_d x (W^T dy), dD's partial.  With
      // 16-byte rows, dx goes over the warp's own x rows (each lane overwrites
      // the pairs it has just read) and leaves them in 16-byte stores.
      bf16* xw = const_cast<bf16*>(Xs);
      float ddt0 = 0.f, ddt1 = 0.f;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int d = n * 8 + 2 * t;
        const float2 x0 = bf2(Xs + u0 * LDX + d), x1 = bf2(Xs + u1 * LDX + d);
        const float2 y0 = bf2(Ys + u0 * LDX + d), y1 = bf2(Ys + u1 * LDX + d);
        ddt0 = fmaf(x0.y, out[n][1], fmaf(x0.x, out[n][0], ddt0));
        ddt1 = fmaf(x1.y, out[n][3], fmaf(x1.x, out[n][2], ddt1));
        dd = fmaf(y1.y, x1.y, fmaf(y1.x, x1.x, fmaf(y0.y, x0.y, fmaf(y0.x, x0.x, dd))));
        const float2 v0 = make_float2(fmaf(dt0, out[n][0], Dh * y0.x),
                                      fmaf(dt0, out[n][1], Dh * y0.y));
        const float2 v1 = make_float2(fmaf(dt1, out[n][2], Dh * y1.x),
                                      fmaf(dt1, out[n][3], Dh * y1.y));
        if (vec) {
          store2(xw + u0 * LDX, d, HD, v0.x, v0.y);
          store2(xw + u1 * LDX, d, HD, v1.x, v1.y);
        } else if (d < a.hd) {
          if (u0 < Q) store2(dx + (long long)u0 * a.nh * a.hd, d, a.hd, v0.x, v0.y);
          if (u1 < Q) store2(dx + (long long)u1 * a.nh * a.hd, d, a.hd, v1.x, v1.y);
        }
      }
      if (vec) {
        __syncwarp();
        for (int i = lane; i < 16 * (a.hd / 8); i += 32) {
          const int u = r * 16 + i / (a.hd / 8), c = (i % (a.hd / 8)) * 8;
          if (u < Q)
            *reinterpret_cast<uint4*>(dx + (long long)u * a.nh * a.hd + c) =
                *reinterpret_cast<const uint4*>(Xs + u * LDX + c);
        }
      }
      ddt0 += __shfl_xor_sync(kFull, ddt0, 1);
      ddt0 += __shfl_xor_sync(kFull, ddt0, 2);
      ddt1 += __shfl_xor_sync(kFull, ddt1, 1);
      ddt1 += __shfl_xor_sync(kFull, ddt1, 2);
      if (t == 0) {
        if (u0 < Q) p.ddt[(bc * Q + u0) * a.nh + h] = ddt0;
        if (u1 < Q) p.ddt[(bc * Q + u1) * a.nh + h] = ddt1;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dd += __shfl_xor_sync(kFull, dd, off);
    if (lane == 0) ddp[pair] = dd;
    mma::bar_sync(1 + slot, SLOT_THREADS);  // the slot's partials are in

    // dcum = sum_u P[q, u] - sum_q P[q, u] + the inter part, the u tiles and the
    // state tiles in order; dD's partial, the pairs in order
    if (stid < Q) {
      const int q = stid;
      float add = 0.f;
      for (int r = 0; r <= q / 16; ++r) add += colp[r * QP + q];
      p.dcum[(bc * Q + q) * a.nh + h] = add - rowp[q] + inter;
    }
    if (stid == SLOT_THREADS - 1) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < PAIRS; ++k) acc += ddp[k];
      p.ws_dd[bc * a.nh + h] = acc;
    }
  }

  // the group's dS: the slots' tiles summed in order, in the (q, u) layout
  __syncthreads();
  const float* dS0 = reinterpret_cast<const float*>(smem + L.ds_off);
  float* out = p.ws_ds + ((long long)grp * a.bc + bc) * Q * Q;
  for (int idx = tid; idx < NTILE * 256; idx += kTcThreads) {
    const int T = idx >> 8, n = (idx >> 7) & 1, l = (idx >> 2) & 31, e = idx & 3;
    int i, jc;
    tile_of(QT, T, i, jc);
    const int u = i * 16 + (l >> 2) + 8 * (e >> 1), q = jc * 16 + n * 8 + 2 * (l & 3) + (e & 1);
    if (u > q || q >= Q) continue;
    float v = 0.f;
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) v += dS0[sl * NTILE * 256 + idx];
    out[(long long)q * Q + u] = v;
  }
}

// -- finish: dB, dC and dD -------------------------------------------------------

// Shared memory of a finish block: dS in bf16 hi and lo (qp rows of qp + 8),
// then C's and B's columns of a pass (qp rows of kFinishCols + 8 bf16 each).
struct FinishLayout {
  int qp, lds, ldc;
  size_t lo_off, c_off, b_off, bytes;
};

__host__ __device__ inline FinishLayout finish_layout(int Q) {
  FinishLayout l;
  l.qp = round16(Q);
  l.lds = l.qp + 8;
  l.ldc = kFinishCols + 8;
  l.lo_off = (size_t)l.qp * l.lds * sizeof(bf16);
  l.c_off = 2 * l.lo_off;
  l.b_off = l.c_off + (size_t)l.qp * l.ldc * sizeof(bf16);
  l.bytes = l.b_off + (size_t)l.qp * l.ldc * sizeof(bf16);
  return l;
}

__global__ void __launch_bounds__(kTcThreads)
ssd_bwd_finish_bf16_kernel(const BwdPtrs p, const BwdArgs a, const int vec) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const long long bc = blockIdx.x;
  if (bc == a.bc) {  // dD, over the batch-chunks in order
    for (int h = tid; h < a.nh; h += kTcThreads) {
      float acc = 0.f;
      for (long long b = 0; b < a.bc; ++b) acc += p.ws_dd[b * a.nh + h];
      p.dD[h] = acc;
    }
    return;
  }
  const FinishLayout L = finish_layout(a.Q);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Shi = reinterpret_cast<bf16*>(smem);
  bf16* Slo = reinterpret_cast<bf16*>(smem + L.lo_off);
  bf16* Cs = reinterpret_cast<bf16*>(smem + L.c_off);
  bf16* Bs = reinterpret_cast<bf16*>(smem + L.b_off);
  const int Q = a.Q, QP = L.qp, QT = QP / 16;
  // dS summed over the intra groups in order, split into bf16 hi + lo; 0 above
  // the diagonal and past Q
  for (int i = tid; i < QP * QP; i += kTcThreads) {
    const int q = i / QP, u = i % QP;
    float v = 0.f;
    if (u <= q && q < Q)
      for (int grp = 0; grp < a.g_intra; ++grp)
        v += p.ws_ds[(((long long)grp * a.bc + bc) * Q + q) * Q + u];
    const bf16 hv = __float2bfloat16(v);
    Shi[q * L.lds + u] = hv;
    Slo[q * L.lds + u] = __float2bfloat16(v - __bfloat162float(hv));
  }
  bf16* dB = static_cast<bf16*>(p.dB) + bc * Q * a.st;
  bf16* dC = static_cast<bf16*>(p.dC) + bc * Q * a.st;
  for (int s0 = 0; s0 < a.st; s0 += kFinishCols) {
    __syncthreads();  // dS built / the previous pass's products done
    mma::load_rows(Cs, L.ldc, static_cast<const bf16*>(p.C) + bc * a.cs[0] + s0 * a.cs[2],
                   a.cs[1], a.cs[2], Q, a.st - s0, QP, kFinishCols, vec, tid, kTcThreads);
    mma::load_rows(Bs, L.ldc, static_cast<const bf16*>(p.B) + bc * a.bs[0] + s0 * a.bs[2],
                   a.bs[1], a.bs[2], Q, a.st - s0, QP, kFinishCols, vec, tid, kTcThreads);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    for (int m = warp; m < QT; m += kTcThreads / 32) {
      float acc[kFinishCols / 8][4];
      // dB, rows u of tile m: dS^T (by ldmatrix.trans) . C over the q chunks >= m
#pragma unroll
      for (int n = 0; n < kFinishCols / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      for (int kq = m; kq < QT; ++kq) {
        uint32_t ah[4], al[4];
        mma::ldmatrix_x4_trans(ah, Shi + (kq * 16 + b_row(lane)) * L.lds + m * 16 + b_col(lane));
        mma::ldmatrix_x4_trans(al, Slo + (kq * 16 + b_row(lane)) * L.lds + m * 16 + b_col(lane));
#pragma unroll
        for (int np = 0; np < kFinishCols / 16; ++np) {
          uint32_t bf[4];
          mma::ldmatrix_x4_trans(bf, Cs + (kq * 16 + a_row(lane)) * L.ldc + np * 16 + a_col(lane));
          mma::mma_bf16(acc[2 * np], ah, bf[0], bf[1]);
          mma::mma_bf16(acc[2 * np + 1], ah, bf[2], bf[3]);
          mma::mma_bf16(acc[2 * np], al, bf[0], bf[1]);
          mma::mma_bf16(acc[2 * np + 1], al, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int u = m * 16 + g + 8 * half;
        if (u >= Q) continue;
#pragma unroll
        for (int n = 0; n < kFinishCols / 8; ++n)
          store2(dB + (long long)u * a.st, s0 + n * 8 + 2 * t, a.st, acc[n][2 * half],
                 acc[n][2 * half + 1]);
      }
      // dC, rows q of tile m: dS . B over the u chunks <= m, + the inter groups' parts
#pragma unroll
      for (int n = 0; n < kFinishCols / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      for (int ku = 0; ku <= m; ++ku) {
        uint32_t ah[4], al[4];
        mma::ldmatrix_x4(ah, Shi + (m * 16 + a_row(lane)) * L.lds + ku * 16 + a_col(lane));
        mma::ldmatrix_x4(al, Slo + (m * 16 + a_row(lane)) * L.lds + ku * 16 + a_col(lane));
#pragma unroll
        for (int np = 0; np < kFinishCols / 16; ++np) {
          uint32_t bf[4];
          mma::ldmatrix_x4_trans(bf, Bs + (ku * 16 + a_row(lane)) * L.ldc + np * 16 + a_col(lane));
          mma::mma_bf16(acc[2 * np], ah, bf[0], bf[1]);
          mma::mma_bf16(acc[2 * np + 1], ah, bf[2], bf[3]);
          mma::mma_bf16(acc[2 * np], al, bf[0], bf[1]);
          mma::mma_bf16(acc[2 * np + 1], al, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = m * 16 + g + 8 * half;
        if (q >= Q) continue;
#pragma unroll
        for (int n = 0; n < kFinishCols / 8; ++n) {
          const int c = s0 + n * 8 + 2 * t;
          float v0 = acc[n][2 * half], v1 = acc[n][2 * half + 1];
          for (int grp = 0; grp < a.g_inter; ++grp) {
            const float* part = p.ws_dc + (((long long)grp * a.bc + bc) * Q + q) * a.st;
            if (c < a.st) v0 += part[c];
            if (c + 1 < a.st) v1 += part[c + 1];
          }
          store2(dC + (long long)q * a.st, c, a.st, v0, v1);
        }
      }
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename TX, typename TY, int NT>
cudaError_t launch_t(const BwdPtrs& p, const BwdArgs& a, cudaStream_t stream) {
  const size_t f_inter = inter_smem_floats(a.Q, a.hd), f_intra = intra_smem_floats(a.Q, a.hd),
               f_finish = finish_smem_floats(a.Q);
  if (cudaError_t err = set_smem(ssd_bwd_inter_kernel<TX, TY>, f_inter * sizeof(float)))
    return err;
  if (cudaError_t err = set_smem(ssd_bwd_intra_kernel<TX, TY, NT>, f_intra * sizeof(float)))
    return err;
  if (cudaError_t err = set_smem(ssd_bwd_finish_kernel<TX>, f_finish * sizeof(float))) return err;
  ssd_bwd_inter_kernel<TX, TY><<<dim3(a.bc, a.tiles, a.g_inter), kThreads,
                                 f_inter * sizeof(float), stream>>>(p, a);
  if (cudaError_t err = cudaGetLastError()) return err;
  ssd_bwd_intra_kernel<TX, TY, NT><<<dim3(a.bc, a.g_intra), kThreads,
                                     f_intra * sizeof(float), stream>>>(p, a);
  if (cudaError_t err = cudaGetLastError()) return err;
  ssd_bwd_finish_kernel<TX><<<a.bc + 1, kThreads, f_finish * sizeof(float), stream>>>(p, a);
  return cudaGetLastError();
}

// the CUDA-core kernels: 64-column state tiles
template <typename TX, typename TY>
cudaError_t launch_cuda_cores(const BwdPtrs& p, const BwdArgs& a, cudaStream_t stream) {
  if (a.tiles != (a.st + kStTile - 1) / kStTile) return cudaErrorInvalidValue;
  const int n = round4(a.Q) / 4, tiles = n * (n + 1) / 2;
  if (tiles <= kThreads) return launch_t<TX, TY, 1>(p, a, stream);
  if (tiles <= 2 * kThreads) return launch_t<TX, TY, 2>(p, a, stream);
  return launch_t<TX, TY, 3>(p, a, stream);
}

using TcKernel = void (*)(BwdPtrs, BwdArgs, int);

template <int QT>
TcKernel intra_bf16(int hd) {
  if (hd <= 32) return ssd_bwd_intra_bf16_kernel<QT, 32>;
  if (hd <= 64) return ssd_bwd_intra_bf16_kernel<QT, 64>;
  return ssd_bwd_intra_bf16_kernel<QT, 128>;
}

// the tensor-core kernels: QT 4 or 8 row tiles, inter state tiles of 128
// columns (QT 4 and d_state > 64) or 64; every layout is sized before any launch
cudaError_t launch_bf16(const BwdPtrs& p, const BwdArgs& a, int vec, cudaStream_t stream) {
  const int QT = a.Q <= 64 ? 4 : 8, NS = QT == 4 && a.st > 64 ? 2 : 1;
  if (a.tiles != (a.st + 64 * NS - 1) / (64 * NS)) return cudaErrorInvalidValue;
  const int HD = a.hd <= 32 ? 32 : a.hd <= 64 ? 64 : 128;
  const size_t b_inter = inter_layout(QT, NS, a.hd).bytes, b_intra = intra_layout(QT, HD).bytes,
               b_finish = finish_layout(a.Q).bytes;
  if (b_inter > kMaxSmem || b_intra > kMaxSmem || b_finish > kMaxSmem)
    return cudaErrorInvalidValue;
  const TcKernel inter = QT == 8   ? ssd_bwd_inter_bf16_kernel<8, 1>
                         : NS == 2 ? ssd_bwd_inter_bf16_kernel<4, 2>
                                   : ssd_bwd_inter_bf16_kernel<4, 1>;
  const TcKernel intra = QT == 8 ? intra_bf16<8>(a.hd) : intra_bf16<4>(a.hd);
  if (cudaError_t err = set_smem(inter, b_inter)) return err;
  if (cudaError_t err = set_smem(intra, b_intra)) return err;
  if (cudaError_t err = set_smem(ssd_bwd_finish_bf16_kernel, b_finish)) return err;
  inter<<<dim3(a.bc, a.tiles, a.g_inter), kInterThreads, b_inter, stream>>>(p, a, vec);
  if (cudaError_t err = cudaGetLastError()) return err;
  intra<<<dim3(a.bc, a.g_intra), kTcThreads, b_intra, stream>>>(p, a, vec);
  if (cudaError_t err = cudaGetLastError()) return err;
  ssd_bwd_finish_bf16_kernel<<<a.bc + 1, kTcThreads, b_finish, stream>>>(p, a, vec);
  return cudaGetLastError();
}

}  // namespace

// x (bc, Q, nh, hd), B and C (bc, Q, st) in `dtype`, read through the 16
// element strides in `strides` (x 4, dt 3, cum 3, B 3, C 3); dt and cum (bc, Q,
// nh) f32; h_prev (bc, nh, hd, st) and D (nh,) f32 contiguous; dy (b, s, nh, hd)
// contiguous in `dy_dtype` (f32, or bf16 for bf16 inputs).  `vec`: the bf16
// kernels copy x, dy, B and C rows 16 bytes at a time (rows contiguous,
// multiples of 8 elements, 16-byte aligned: the caller has checked).  Writes dx
// (bc, Q, nh, hd), dB and dC (bc, Q, st) in `dtype`; ddt and dcum (bc, Q, nh),
// dh_prev (bc, nh, hd, st) and dD (nh,) in f32; all contiguous.  `ws` holds the
// f32 workspace of the header, in that order, for the caller's plan: `tiles`
// state tiles of an inter block (ceil(st / 64), or ceil(st / 128) for the bf16
// kernels at Q <= 64 and d_state > 64) and the head groups `g_inter` /
// `g_intra` of `hpb_inter` / `hpb_intra` heads.  Three launches; returns the
// first failing launch's cudaError_t.
extern "C" int ssd_chunk_scan_bwd(const void* x, const float* dt, const float* cum, const void* B,
                                  const void* C, const float* h_prev, const float* D,
                                  const void* dy, void* dx, float* ddt, float* dcum, void* dB,
                                  void* dC, float* dh_prev, float* dD, float* ws, int bc, int nc,
                                  int s, int Q, int nh, int hd, int st, const long long* strides,
                                  int dtype, int dy_dtype, int vec, int tiles, int g_inter,
                                  int hpb_inter, int g_intra, int hpb_intra, int device,
                                  void* stream) {
  if (bc == 0 || Q == 0 || nh == 0 || hd == 0) return cudaSuccess;
  if (Q < 0 || Q > 128 || hd < 0 || hd > 128 || st < 1 || st > 512 || nh < 0 || nc < 1 ||
      tiles < 1 || tiles > 65535 || g_inter < 1 || g_inter > 65535 || g_intra < 1 ||
      g_intra > 65535 || (long long)g_inter * hpb_inter < nh ||
      (long long)g_intra * hpb_intra < nh)
    return cudaErrorInvalidValue;
  if (cudaError_t err = cudaSetDevice(device)) return err;
  BwdArgs a{bc, Q, nh, hd, st, nc, s, tiles, g_inter, hpb_inter, g_intra, hpb_intra,
            {}, {}, {}, {}, {}};
  for (int i = 0; i < 4; ++i) a.xs[i] = strides[i];
  for (int i = 0; i < 3; ++i) {
    a.dts[i] = strides[4 + i];
    a.cums[i] = strides[7 + i];
    a.bs[i] = strides[10 + i];
    a.cs[i] = strides[13 + i];
  }
  float* ws_dc = ws + (size_t)bc * tiles * Q * nh;
  float* ws_ds = ws_dc + (size_t)g_inter * bc * Q * st;
  float* ws_dd = ws_ds + (size_t)g_intra * bc * Q * Q;
  const BwdPtrs p{x, dt, cum, B, C, h_prev, D, dy, dx, ddt, dcum, dB, dC, dh_prev, dD,
                  ws, ws_dc, ws_ds, ws_dd};
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && dy_dtype == kFloat32) return launch_cuda_cores<float, float>(p, a, sm);
  if (dtype == kBFloat16 && dy_dtype == kFloat32)
    return launch_cuda_cores<__nv_bfloat16, float>(p, a, sm);
  if (dtype == kBFloat16 && dy_dtype == kBFloat16) return launch_bf16(p, a, vec, sm);
  return cudaErrorInvalidValue;
}
