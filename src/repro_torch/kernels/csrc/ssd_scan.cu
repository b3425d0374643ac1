// Mamba2 SSD chunk scan for Hopper (sm_90a).  Per (batch*chunk) and head:
//   scores[q, u] = C_q . B_u
//   w[q, u]      = scores[q, u] * exp(cum[q] - cum[u]) * dt[u]      for u <= q, else 0
//   y_intra[q]   = sum_u w[q, u] x[u]
// and, in the fused entry, the chunk's whole output:
//   y[q]         = y_intra[q] + exp(cum[q]) * (C_q . h_prev) + D * x[q]
// summed in f32 and rounded once to the output dtype, written straight into
// the (b, s, nh, hd) sequence with the padded rows q >= s dropped.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py::_intra_kernel
// (ssd_intra_chunk, its counterpart, y_intra in f32) and fuses the plain torch
// passes of models/ssm.py around it (the inter-chunk output, the D skip, the
// sums and the cast: ssd_chunk_scan).
//
// Bound, at the serving shape of mamba2-1.3b (64 batch-chunks of Q = 64, 64
// heads of 64, d_state 128, x/B/C in bf16):
// * ssd_intra_chunk reads 35 MB and writes a 67 MB f32 y: 31 us of device
//   memory at 3.35 TB/s, against 2.8 GFLOP over the causal half (the second
//   product twice, see below), 3 us at the bf16 tensor-core peak: bound by
//   bytes.
// * ssd_chunk_scan also reads the 134 MB f32 h_prev and writes y in bf16
//   (33.5 MB): 205 MB, 61 us.  Its C . h_prev product adds 8.6 GFLOP (twice
//   again), 12 us in all at the peak, so it too is bound by bytes.
//
// Two kernels, chosen by dtype:
// * bf16 (ssd_bf16_kernel), the served dtype, on the tensor cores with
//   mma.sync.m16n8k16 (mma.cuh).  The first port did both products as f32 FMAs
//   on the CUDA cores, with a block-wide barrier for every 32 state columns and
//   three per head, a Q x Q w tile rebuilt in shared memory per head (Q^2 exps,
//   half of them masked), and each head's causal rows on threads of 1x to 16x
//   the work ending at a common barrier: 0.195 ms at the serving shape, 16% of
//   its bound.
//   - One block per (batch*chunk, group of heads), 4 warps.  A warp owns two
//     16-row q tiles, a short one and a long one ({0, 3} and {1, 2} at Q = 64;
//     {0, 7} ... {3, 4} at Q = 128), so every warp has the same causal work:
//     5 (9) 16 x 16 score tiles.  At Q <= 64 two warps cover a head's rows, so
//     a block runs two heads at a time (two "slots"); at Q = 128 four.  The
//     launcher sizes the groups from the kernel's occupancy so that the grid
//     is one wave (heads_per_block()): aiming at four blocks an SM where three
//     fit left a second wave of 116 blocks behind the first 396.
//   - S = C . B^T for the warp's tiles by mma.sync (C and B bf16 already, f32
//     accumulation) once per block; S stays in the accumulator registers for
//     every head of the block's group.  No S or w tile goes to shared memory.
//   - Per head, w' = S * exp2((cum_q - cum_u) log2 e) * dt_u is built in the
//     registers, as the attention kernels build P: masked (selected to 0) for
//     u > q before it is used, never multiplied by a mask, since the exponent
//     is positive there and can overflow to inf (inf * 0 is NaN); exps only
//     on the causal 16 x 16 tiles.  dt is folded into w', so x enters the
//     product as stored bf16.
//   - Split bf16: w' = hi + lo, each rounded to bf16, and y += hi . x + lo . x,
//     two mma.sync on one ldmatrix.trans x fragment.  One bf16 w' (as P in
//     attention) misses SSD_TOL's 3e-2 at full width: y sums ~3 decayed terms of
//     |S| ~ 11, so a 2^-9 rounding of each is ~0.015 absolute where y itself
//     is near 0 (tests/test_torch_ssd_fused.py models both).
//   - A cp.async ring over each slot's heads: head h+1's x tile (Q x hd bf16),
//     cum and dt land while head h computes; the two warps of a slot meet at
//     a named barrier (bar.sync of 64 threads), twice a head, and never at a
//     block-wide one.
//   - ssd_chunk_scan, per head: acc = C . h_prev^T (split bf16 again: h_prev
//     is f32, C bf16, so hi + lo keeps ~16 bits; C by ldmatrix), acc *=
//     exp(cum_q), acc += w' . x, acc += D x_q, one rounding, one store.
//     y_intra, y_inter and their sums never reach device memory.
//   - h_prev, the largest input (134 MB at the serving shape), streams through
//     shared memory: each slot runs one cp.async stream of 16-column chunks
//     (4 KB at head_dim 64), two chunks ahead of their use, in a ring of four,
//     one pair barrier a chunk; a head's first chunk brings its x, cum and dt
//     too.  The first version read h_prev's fragments straight from global
//     memory, 8 bytes a lane, and took 0.352 ms: about 8 KB in flight per
//     slot's warp, too few bytes to cover the latency (582 GB/s).
//   - Why mma.sync and not wgmma: the products are 64 rows deep per head
//     (the whole chunk) and wgmma wants 64-row warpgroup tiles per head, with
//     the causal half wasted; the function is bound by bytes here anyway.
// * f32 (ssd_f32_kernel), the dtype of the logits checks: f32 FMAs on the CUDA
//   cores, the score tile in shared memory, each thread a 4 x 4 tile of y;
//   ssd_chunk_scan adds C . h_prev from global memory per tile in f32.
//
// Inputs are read through their element strides (the model passes slices of
// its conv output, whose rows are 8,704 B apart).  The bf16 kernel copies
// rows of x, B and C 16 bytes at a time when their lengths are multiples of 8
// elements (the wrapper checks 16-byte alignment and raises on a misaligned
// view); rows of other lengths are copied element by element.  Any Q <= 128,
// head_dim <= 128 and d_state <= 512, shared memory permitting: a bf16 launch
// whose tiles exceed a block's 227 KB (Q, head_dim and d_state all near their
// limits) is refused with cudaErrorInvalidValue.

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kMaxQ = 128;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxState = 512;

struct SsdArgs {
  int Q, nh, hd, st;
  int heads_per_block;  // set by the launcher (heads_per_block())
  int nc, s;          // output rows: batch*chunk bc is chunk bc % nc of sequence bc / nc,
                      // of length s ((bc, Q, nh, hd) for y_intra: nc 1, s Q)
  long long xs[4];    // x (bc, Q, nh, hd)
  long long dts[3];   // dt (bc, Q, nh)
  long long cums[3];  // cum (bc, Q, nh)
  long long bs[3];    // B (bc, Q, st)
  long long cs[3];    // C (bc, Q, st)
};

// Pointers of one launch; h_prev (bc, nh, hd, st) f32 and D (nh,) f32 are the
// fused entry's (contiguous), null for y_intra.
struct SsdPtrs {
  const void* x;
  const float* dt;
  const float* cum;
  const void* B;
  const void* C;
  const float* h_prev;
  const float* D;
  void* y;
};

// Where batch-chunk bc's rows go: q < rows of them, row q at ((first + q) * nh
// + h) * hd for head h.  Computed once a block (the divisions are 64-bit).
struct OutRows {
  long long first;
  int rows;

  __device__ OutRows(const SsdArgs& a, long long bc)
      : first((bc / a.nc) * a.s + (bc % a.nc) * a.Q),
        rows(min(a.Q, (int)(a.s - (bc % a.nc) * a.Q))) {}

  // Output offset of row q of head h, or -1 past the sequence's end.
  __device__ __forceinline__ long long at(const SsdArgs& a, int q, int h) const {
    return q < rows ? ((first + q) * a.nh + h) * a.hd : -1;
  }
};

// -- f32 on the CUDA cores ---------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kStateChunk = 32;            // state columns of C and B staged at a time
constexpr int kStageLd = kStateChunk + 1;  // padded row of the staging tiles

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Shared-memory floats: S, then (staging C and B | w and x*dt), then cum and dt.
__host__ inline size_t f32_smem_floats(int Q, int hd) {
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

template <bool FUSED>
__global__ void __launch_bounds__(kF32Threads)
ssd_f32_kernel(const SsdPtrs p, const SsdArgs a) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const float* __restrict__ x = static_cast<const float*>(p.x);
  const float* __restrict__ Bm = static_cast<const float*>(p.B);
  const float* __restrict__ Cm = static_cast<const float*>(p.C);
  float* __restrict__ y = static_cast<float*>(p.y);
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
  const OutRows out(a, bc);
  const int qt = qp / 4;  // 4-row tiles

  // -- scores: S[q][u] = sum_s C[q, s] B[u, s], tiles on or below the diagonal
  for (int i = tid; i < qp * ld; i += kF32Threads) S[i] = 0.f;
  for (int s0 = 0; s0 < a.st; s0 += kStateChunk) {
    __syncthreads();  // S zeroed / the previous chunk's products done
    for (int i = tid; i < qp * kStateChunk; i += kF32Threads) {
      const int q = i / kStateChunk, s = i % kStateChunk;
      const bool in = q < Q && s0 + s < a.st;
      Cs[q * kStageLd + s] = in ? Cm[bc * a.cs[0] + q * a.cs[1] + (s0 + s) * a.cs[2]] : 0.f;
      Bs[q * kStageLd + s] = in ? Bm[bc * a.bs[0] + q * a.bs[1] + (s0 + s) * a.bs[2]] : 0.f;
    }
    __syncthreads();
    for (int t = tid; t < qt * qt; t += kF32Threads) {
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
  for (int h = h_begin; h < h_end; ++h) {
    __syncthreads();  // S complete / the previous head's products done
    for (int q = tid; q < qp; q += kF32Threads) {
      const bool in = q < Q;
      cumh[q] = in ? p.cum[bc * a.cums[0] + q * a.cums[1] + h * a.cums[2]] : 0.f;
      dth[q] = in ? p.dt[bc * a.dts[0] + q * a.dts[1] + h * a.dts[2]] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < qp * qp; i += kF32Threads) {
      const int q = i / qp, u = i % qp;
      // masked entries are written, never exponentiated
      W[q * ld + u] = (q < Q && u <= q) ? S[q * ld + u] * expf(cumh[q] - cumh[u]) : 0.f;
    }
    const float* xh = x + bc * a.xs[0] + h * a.xs[2];
    for (int i = tid; i < qp * hdp; i += kF32Threads) {
      const int u = i / hdp, d = i % hdp;
      X[u * hdx + d] = (u < Q && d < a.hd) ? xh[u * a.xs[1] + d * a.xs[3]] * dth[u] : 0.f;
    }
    __syncthreads();
    const float* hb = FUSED ? p.h_prev + (bc * a.nh + h) * a.hd * a.st : nullptr;
    for (int t = tid; t < qt * dtiles; t += kF32Threads) {
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
      if constexpr (FUSED) {  // y = y_intra + exp(cum_q) C_q . h_prev + D x_q
        float inter[4][4] = {};
        for (int s = 0; s < a.st; ++s) {
          float cq[4], hv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            cq[i] = q0 + i < Q ? Cm[bc * a.cs[0] + (q0 + i) * a.cs[1] + s * a.cs[2]] : 0.f;
            hv[i] = d0 + i < a.hd ? hb[(d0 + i) * a.st + s] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) inter[i][j] = fmaf(cq[i], hv[j], inter[i][j]);
        }
        const float Dh = p.D[h];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float eq = q0 + i < Q ? expf(cumh[q0 + i]) : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool in = q0 + i < Q && d0 + j < a.hd;
            const float xv = in ? xh[(q0 + i) * a.xs[1] + (d0 + j) * a.xs[3]] : 0.f;
            acc[i][j] = acc[i][j] + eq * inter[i][j] + Dh * xv;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + i;
        if (q >= Q) break;
        const long long row = out.at(a, q, h);
        if (row < 0) break;
        float* yr = y + row;
        if (a.hd % 4 == 0) {
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

// Heads a block takes, a multiple of `slots`: as many blocks as the card holds at
// once (one wave, so no SM idles through a second wave's tail), at least one
// per batch-chunk, and every slot of a block the same number of heads.
template <typename Kernel>
cudaError_t heads_per_block(Kernel kernel, int threads, size_t smem, int bc, int nh, int slots,
                            int device, int* out) {
  int per_sm = 0, sms = 0;
  if (cudaError_t err =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem))
    return err;
  if (cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))
    return err;
  const int groups = max(1, min(nh, per_sm * sms / max(bc, 1)));
  *out = ((nh + groups - 1) / groups + slots - 1) / slots * slots;
  return cudaSuccess;
}

template <bool FUSED>
cudaError_t launch_f32(const SsdPtrs& p, int bc, SsdArgs a, int device, cudaStream_t stream) {
  const size_t bytes = f32_smem_floats(a.Q, a.hd) * sizeof(float);
  if (cudaError_t err = cudaFuncSetAttribute(
          ssd_f32_kernel<FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes))
    return err;
  if (cudaError_t err = heads_per_block(ssd_f32_kernel<FUSED>, kF32Threads, bytes, bc, a.nh, 1,
                                        device, &a.heads_per_block))
    return err;
  const dim3 grid(bc, (a.nh + a.heads_per_block - 1) / a.heads_per_block);
  ssd_f32_kernel<FUSED><<<grid, kF32Threads, bytes, stream>>>(p, a);
  return cudaGetLastError();
}

// -- bf16 on the tensor cores ------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

// The fused kernel streams h_prev through shared memory in chunks of 16 state
// columns (HD rows of 16 f32, 4 KB at HD 64), kHStages of them a slot, kHDist
// chunks ahead of their use.
constexpr int kHStages = 4;
constexpr int kHDist = 2;

// Shared memory of the bf16 kernel, for QT 16-row q tiles, head dim HD and
// d_state st: the C and B tiles (QT*16 rows of round16(st) + 8 bf16); a ring of
// x tiles (QT*16 rows of HD + 8 bf16) and of cum and dt (2 x QT*16 f32), `nx`
// stages a slot; for the fused entry, a ring of kHStages h_prev chunks a slot.
// Rows padded by 16 bytes: ldmatrix without bank conflicts, every row start
// 16-byte aligned.
struct Bf16Layout {
  int qp, ldc, ldx, slots, kch, nx;
  size_t x_off, f_off, h_off, bytes;
};

__host__ __device__ inline Bf16Layout bf16_layout(int QT, int HD, int st, bool fused) {
  Bf16Layout l;
  l.qp = QT * 16;
  l.kch = (st + 15) / 16;  // 16-column chunks of the state
  l.ldc = l.kch * 16 + 8;
  l.ldx = HD + 8;
  l.slots = 8 / QT;
  // the fused entry loads head j's x with h_prev chunk j * kch, kHDist chunks
  // early: its stage must not be one a head still in flight reads
  l.nx = fused ? (kHDist + 1 + l.kch - 1) / l.kch + 1 : 2;
  l.x_off = 2 * (size_t)l.qp * l.ldc * sizeof(bf16);
  l.f_off = l.x_off + (size_t)l.nx * l.slots * l.qp * l.ldx * sizeof(bf16);
  l.h_off = l.f_off + (size_t)l.nx * l.slots * 2 * l.qp * sizeof(float);
  l.bytes = l.h_off + (fused ? (size_t)kHStages * l.slots * HD * 16 * sizeof(float) : 0);
  return l;
}

// h_prev chunk: rows d < HD of 16 f32 columns [k0, k0 + 16) of a (hd, st)
// source, zero past hd and st.  A row is four 16-byte groups, group c stored at
// c ^ (d & 2): the float2 fragment reads of a half-warp (rows g, g + 1, g + 2,
// g + 3) then fall in distinct banks.
template <int HD>
__device__ __forceinline__ void load_h_chunk(float* dst, const float* src, int hd, int st, int k0,
                                             int tid, int nthreads) {
  const bool vec = st % 4 == 0;
  for (int i = tid; i < HD * 4; i += nthreads) {
    const int d = i >> 2, c = i & 3, s = k0 + 4 * c;
    float* out = dst + d * 16 + ((c ^ (d & 2)) << 2);
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

// QT: 16-row q tiles (4 for Q <= 64, 8 for Q <= 128); HD: head_dim padded to
// 32, 64 or 128; FUSED: ssd_chunk_scan's epilogue (else y_intra in f32).
template <int QT, int HD, bool FUSED>
__global__ void __launch_bounds__(kThreads)
ssd_bf16_kernel(const SsdPtrs p, const SsdArgs a, const int vec, const int out_bf16) {
  constexpr int PAIRS = QT / 2;   // warps a head's rows take: one short and one long q tile each
  constexpr int SLOTS = 8 / QT;   // heads a block runs at once
  constexpr int TILES = QT + 1;   // 16 x 16 causal score tiles a warp owns
  constexpr int NT = HD / 8;      // n-tiles of a y row
  constexpr int SLOT_THREADS = 32 * PAIRS;
  const Bf16Layout L = bf16_layout(QT, HD, a.st, FUSED);
  const int QP = L.qp, LDC = L.ldc, LDX = L.ldx, KCH = L.kch, NX = L.nx;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem);
  bf16* Bs = Cs + QP * LDC;
  bf16* xring = reinterpret_cast<bf16*>(smem + L.x_off);
  float* fring = reinterpret_cast<float*>(smem + L.f_off);
  float* hring = reinterpret_cast<float*>(smem + L.h_off);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int slot = warp / PAIRS, pair = warp % PAIRS;
  const int ra = pair, rb = QT - 1 - pair;  // the warp's short and long q tiles
  const int stid = tid - slot * SLOT_THREADS;  // thread within the slot
  const long long bc = blockIdx.x;
  const OutRows out(a, bc);
  const int h_begin = blockIdx.y * a.heads_per_block;
  const int h_end = min(h_begin + a.heads_per_block, a.nh);
  const int n_heads = h_end - h_begin > slot ? (h_end - h_begin - slot + SLOTS - 1) / SLOTS : 0;
  auto head = [&](int j) { return h_begin + slot + j * SLOTS; };

  const bf16* xb = static_cast<const bf16*>(p.x) + bc * a.xs[0];
  auto load_head = [&](int j) {  // x, cum and dt of the slot's head j into stage j % NX
    const int h = head(j);
    const int stage = (j % NX) * SLOTS + slot;
    mma::load_rows(xring + stage * QP * LDX, LDX, xb + h * a.xs[2], a.xs[1], a.xs[3], a.Q, a.hd,
                   QP, HD, vec, stid, SLOT_THREADS);
    float* f = fring + stage * 2 * QP;
    for (int r = stid; r < QP; r += SLOT_THREADS) {
      const bool ok = r < a.Q;
      mma::cp_async_4(f + r, ok ? p.cum + bc * a.cums[0] + r * a.cums[1] + h * a.cums[2] : p.cum,
                      ok);
      mma::cp_async_4(f + QP + r, ok ? p.dt + bc * a.dts[0] + r * a.dts[1] + h * a.dts[2] : p.dt,
                      ok);
    }
  };
  // fused: step i of the slot's stream is h_prev chunk i % KCH of head i / KCH;
  // a head's first step also brings its x, cum and dt
  const int steps = FUSED ? n_heads * KCH : 0;
  auto issue = [&](int i) {
    if (i >= steps) return;
    const int j = i / KCH, kc = i % KCH;
    if (kc == 0) load_head(j);
    load_h_chunk<HD>(hring + ((i % kHStages) * SLOTS + slot) * HD * 16,
                     p.h_prev + (bc * a.nh + head(j)) * a.hd * a.st, a.hd, a.st, kc * 16, stid,
                     SLOT_THREADS);
  };

  mma::load_rows(Cs, LDC, static_cast<const bf16*>(p.C) + bc * a.cs[0], a.cs[1], a.cs[2], a.Q,
                 a.st, QP, KCH * 16, vec, tid, kThreads);
  mma::load_rows(Bs, LDC, static_cast<const bf16*>(p.B) + bc * a.bs[0], a.bs[1], a.bs[2], a.Q,
                 a.st, QP, KCH * 16, vec, tid, kThreads);
  mma::cp_async_commit();
  if constexpr (FUSED) {
#pragma unroll
    for (int i = 0; i < kHDist; ++i) {
      issue(i);
      mma::cp_async_commit();
    }
    mma::cp_async_wait<kHDist>();  // C and B have landed; the stream's first steps may not have
  } else {
    if (n_heads > 0) load_head(0);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // C and B have landed; the first head may not have
  }
  __syncthreads();

  // S tile i of the warp: q tile ra, key chunk i for i <= ra; q tile rb, key
  // chunk i - ra - 1 after.  Two n8 accumulators each.
  float S[TILES][2][4];
#pragma unroll
  for (int i = 0; i < TILES; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[i][0][e] = S[i][1][e] = 0.f;
  for (int k0 = 0; k0 < KCH * 16; k0 += 16) {
    uint32_t ca[4], cb[4];
    mma::ldmatrix_x4(ca, Cs + (ra * 16 + mma::a_row(lane)) * LDC + k0 + mma::a_col(lane));
    mma::ldmatrix_x4(cb, Cs + (rb * 16 + mma::a_row(lane)) * LDC + k0 + mma::a_col(lane));
#pragma unroll
    for (int i = 0; i < TILES; ++i) {
      const bool first = i <= ra;
      const int kc = first ? i : i - ra - 1;
      uint32_t b[4], c[4];
      mma::ldmatrix_x4(b, Bs + (kc * 16 + mma::b_row(lane)) * LDC + k0 + mma::b_col(lane));
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] = first ? ca[e] : cb[e];
      mma::mma_bf16(S[i][0], c, b[0], b[1]);
      mma::mma_bf16(S[i][1], c, b[2], b[3]);
    }
  }

  // one head j of the slot (x, cum and dt landed and visible): acc += w' . x
  // over the causal tiles, w' split into bf16 hi + lo; then (+ D x_q), one
  // rounding and one store per element
  auto finish_head = [&](int j, float (&acc)[2][NT][4]) {
    const int h = head(j);
    const int stage = (j % NX) * SLOTS + slot;
    const bf16* xs = xring + stage * QP * LDX;
    const float* cum = fring + stage * 2 * QP;
    const float* dt = cum + QP;
    if constexpr (FUSED) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // C . h_prev^T times exp(cum_q), per row
        const int q0 = (r ? rb : ra) * 16 + g;
        const float e0 = exp2f(cum[q0] * kLog2e), e1 = exp2f(cum[q0 + 8] * kLog2e);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[r][n][0] *= e0;
          acc[r][n][1] *= e0;
          acc[r][n][2] *= e1;
          acc[r][n][3] *= e1;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TILES; ++i) {
      const bool first = i <= ra;
      const int R = first ? ra : rb, kc = first ? i : i - ra - 1;
      const int q0 = R * 16 + g, q1 = q0 + 8;
      const float cq0 = cum[q0], cq1 = cum[q1];
      const bool diag = kc == R;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int u = kc * 16 + n * 8 + 2 * t;
        const float2 cu = *reinterpret_cast<const float2*>(cum + u);
        const float2 du = *reinterpret_cast<const float2*>(dt + u);
        // selected, never multiplied: the exponent is positive past the diagonal
        const float w0 = diag && u > q0 ? 0.f : S[i][n][0] * exp2f((cq0 - cu.x) * kLog2e) * du.x;
        const float w1 = diag && u + 1 > q0 ? 0.f : S[i][n][1] * exp2f((cq0 - cu.y) * kLog2e) * du.y;
        const float w2 = diag && u > q1 ? 0.f : S[i][n][2] * exp2f((cq1 - cu.x) * kLog2e) * du.x;
        const float w3 = diag && u + 1 > q1 ? 0.f : S[i][n][3] * exp2f((cq1 - cu.y) * kLog2e) * du.y;
        mma::split_bf16(w0, w1, hi[2 * n], lo[2 * n]);          // a0 / a2: row g
        mma::split_bf16(w2, w3, hi[2 * n + 1], lo[2 * n + 1]);  // a1 / a3: row g + 8
      }
      const bf16* xrow = xs + (kc * 16 + mma::a_row(lane)) * LDX + mma::a_col(lane);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        mma::ldmatrix_x4_trans(b, xrow + dp * 16);
        if (first) {
          mma::mma_bf16(acc[0][2 * dp], hi, b[0], b[1]);
          mma::mma_bf16(acc[0][2 * dp + 1], hi, b[2], b[3]);
          mma::mma_bf16(acc[0][2 * dp], lo, b[0], b[1]);
          mma::mma_bf16(acc[0][2 * dp + 1], lo, b[2], b[3]);
        } else {
          mma::mma_bf16(acc[1][2 * dp], hi, b[0], b[1]);
          mma::mma_bf16(acc[1][2 * dp + 1], hi, b[2], b[3]);
          mma::mma_bf16(acc[1][2 * dp], lo, b[0], b[1]);
          mma::mma_bf16(acc[1][2 * dp + 1], lo, b[2], b[3]);
        }
      }
    }

    const float Dh = FUSED ? p.D[h] : 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = out.at(a, (r ? rb : ra) * 16 + g + 8 * half, h);
        if (row < 0) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int d = n * 8 + 2 * t;
          if (d >= a.hd) continue;
          float v0 = acc[r][n][2 * half], v1 = acc[r][n][2 * half + 1];
          if constexpr (FUSED) {
            const int q = (r ? rb : ra) * 16 + g + 8 * half;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xs + q * LDX + d));
            v0 = fmaf(Dh, xv.x, v0);
            v1 = fmaf(Dh, xv.y, v1);
          }
          const bool pair_ok = d + 1 < a.hd && a.hd % 2 == 0;
          if (out_bf16) {
            bf16* o = static_cast<bf16*>(p.y) + row + d;
            if (pair_ok) {
              *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
            } else {
              o[0] = __float2bfloat16(v0);
              if (d + 1 < a.hd) o[1] = __float2bfloat16(v1);
            }
          } else {
            float* o = static_cast<float*>(p.y) + row + d;
            if (pair_ok) {
              *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
            } else {
              o[0] = v0;
              if (d + 1 < a.hd) o[1] = v1;
            }
          }
        }
      }
  };

  float acc[2][NT][4];
  if constexpr (FUSED) {
    // acc = C . h_prev^T over the state, a chunk of 16 columns a step, h_prev
    // split into bf16 hi + lo; the C fragments come from shared memory
    for (int j = 0; j < n_heads; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.f;
      for (int kc = 0; kc < KCH; ++kc) {
        const int i = j * KCH + kc;
        // the stage step i + kHDist refills was read at step i - 2, before
        // every slot thread passed the barrier of step i - 1
        issue(i + kHDist);
        mma::cp_async_commit();
        mma::cp_async_wait<kHDist>();  // step i has landed, for this thread
        mma::bar_sync(1 + slot, SLOT_THREADS);  // ... and for the whole slot
        const float* hs = hring + ((i % kHStages) * SLOTS + slot) * HD * 16;
        uint32_t ca[4], cb[4];
        mma::ldmatrix_x4(ca, Cs + (ra * 16 + mma::a_row(lane)) * LDC + kc * 16 + mma::a_col(lane));
        mma::ldmatrix_x4(cb, Cs + (rb * 16 + mma::a_row(lane)) * LDC + kc * 16 + mma::a_col(lane));
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          // B fragment (k = state, n = d): h_prev[d][2t, 2t + 1] and [2t + 8, 2t + 9]
          const float* row = hs + (n * 8 + g) * 16 + 2 * (t & 1);
          const float2 v0 = *reinterpret_cast<const float2*>(row + (((t >> 1) ^ (g & 2)) << 2));
          const float2 v1 =
              *reinterpret_cast<const float2*>(row + (((2 + (t >> 1)) ^ (g & 2)) << 2));
          uint32_t hi0, lo0, hi1, lo1;
          mma::split_bf16(v0.x, v0.y, hi0, lo0);
          mma::split_bf16(v1.x, v1.y, hi1, lo1);
          mma::mma_bf16(acc[0][n], ca, hi0, hi1);
          mma::mma_bf16(acc[0][n], ca, lo0, lo1);
          mma::mma_bf16(acc[1][n], cb, hi0, hi1);
          mma::mma_bf16(acc[1][n], cb, lo0, lo1);
        }
      }
      finish_head(j, acc);
    }
  } else {
    for (int j = 0; j < n_heads; ++j) {
      if (j + 1 < n_heads) load_head(j + 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();  // head j's stage has landed, for this thread
      mma::bar_sync(1 + slot, SLOT_THREADS);  // ... and for the whole slot
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.f;
      finish_head(j, acc);
      // the slot is done with this stage before it is refilled
      mma::bar_sync(1 + slot, SLOT_THREADS);
    }
  }
}

template <int QT, int HD, bool FUSED>
cudaError_t launch_bf16_t(const SsdPtrs& p, int bc, SsdArgs a, int vec, int out_bf16, int device,
                          cudaStream_t stream) {
  const size_t bytes = bf16_layout(QT, HD, a.st, FUSED).bytes;
  if (cudaError_t err = cudaFuncSetAttribute(ssd_bf16_kernel<QT, HD, FUSED>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes))
    return err;
  if (cudaError_t err = heads_per_block(ssd_bf16_kernel<QT, HD, FUSED>, kThreads, bytes, bc, a.nh,
                                        8 / QT, device, &a.heads_per_block))
    return err;
  const dim3 grid(bc, (a.nh + a.heads_per_block - 1) / a.heads_per_block);
  ssd_bf16_kernel<QT, HD, FUSED><<<grid, kThreads, bytes, stream>>>(p, a, vec, out_bf16);
  return cudaGetLastError();
}

template <int QT, bool FUSED>
cudaError_t launch_bf16_qt(const SsdPtrs& p, int bc, const SsdArgs& a, int vec, int out_bf16,
                           int device, cudaStream_t stream) {
  if (a.hd <= 32) return launch_bf16_t<QT, 32, FUSED>(p, bc, a, vec, out_bf16, device, stream);
  if (a.hd <= 64) return launch_bf16_t<QT, 64, FUSED>(p, bc, a, vec, out_bf16, device, stream);
  return launch_bf16_t<QT, 128, FUSED>(p, bc, a, vec, out_bf16, device, stream);
}

template <bool FUSED>
cudaError_t launch(const SsdPtrs& p, int bc, const SsdArgs& a, int dtype, int vec, int out_dtype,
                   int device, void* stream) {
  if (bc == 0 || a.Q == 0 || a.nh == 0 || a.hd == 0) return cudaSuccess;
  if (a.Q < 0 || a.Q > kMaxQ || a.hd < 0 || a.hd > kMaxHeadDim || a.st < 1 ||
      a.st > kMaxState || a.nh < 0 || a.nc < 1)
    return cudaErrorInvalidValue;
  if (cudaError_t err = cudaSetDevice(device)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    if (out_dtype != kFloat32) return cudaErrorInvalidValue;
    return launch_f32<FUSED>(p, bc, a, device, s);
  }
  if (dtype != kBFloat16 || (out_dtype == kBFloat16 && !FUSED)) return cudaErrorInvalidValue;
  const int out_bf16 = out_dtype == kBFloat16;
  if (a.Q <= 64) return launch_bf16_qt<4, FUSED>(p, bc, a, vec, out_bf16, device, s);
  return launch_bf16_qt<8, FUSED>(p, bc, a, vec, out_bf16, device, s);
}

SsdArgs make_args(int Q, int nh, int hd, int st, int nc, int s, const long long* strides) {
  SsdArgs a{Q, nh, hd, st, 0, nc, s, {}, {}, {}, {}, {}};
  for (int i = 0; i < 4; ++i) a.xs[i] = strides[i];
  for (int i = 0; i < 3; ++i) {
    a.dts[i] = strides[4 + i];
    a.cums[i] = strides[7 + i];
    a.bs[i] = strides[10 + i];
    a.cs[i] = strides[13 + i];
  }
  return a;
}

}  // namespace

// x (bc, Q, nh, hd), B and C (bc, Q, st) in `dtype`; dt and cum (bc, Q, nh) f32;
// all read through the 16 element strides in `strides` (x 4, dt 3, cum 3, B 3,
// C 3); `vec`: the bf16 kernel copies x, B and C rows 16 bytes at a time (rows
// contiguous, multiples of 8 elements, 16-byte aligned: the caller has
// checked).  y (bc, Q, nh, hd) f32, contiguous.  Returns the launch's
// cudaError_t.
extern "C" int ssd_intra_chunk(const void* x, const float* dt, const float* cum, const void* B,
                               const void* C, float* y, int bc, int Q, int nh, int hd, int st,
                               const long long* strides, int dtype, int vec, int device,
                               void* stream) {
  const SsdPtrs p{x, dt, cum, B, C, nullptr, nullptr, y};
  return launch<false>(p, bc, make_args(Q, nh, hd, st, 1, Q, strides), dtype, vec, kFloat32,
                       device, stream);
}

// The same inputs for bc = b * nc batch-chunks, with h_prev (bc, nh, hd, st) f32
// (the state entering each chunk) and D (nh,) f32, both contiguous.  y (b, s,
// nh, hd) contiguous in `out_dtype` (f32, or bf16 for bf16 inputs): chunk c of
// sequence i fills rows c * Q ... of y[i], those past s dropped.
extern "C" int ssd_chunk_scan(const void* x, const float* dt, const float* cum, const void* B,
                              const void* C, const float* h_prev, const float* D, void* y, int bc,
                              int nc, int s, int Q, int nh, int hd, int st,
                              const long long* strides, int dtype, int vec, int out_dtype,
                              int device, void* stream) {
  const SsdPtrs p{x, dt, cum, B, C, h_prev, D, y};
  return launch<true>(p, bc, make_args(Q, nh, hd, st, nc, s, strides), dtype, vec, out_dtype,
                      device, stream);
}
