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
// Bound: device-memory bytes.  The function reads x and dy and writes dx once
// each (gamma and dgamma are d values); a few operations per byte.
//
// Design: one launch, one pass over the rows.
// * Grid: `slabs` blocks of 8 warps, at most two an SM, all resident at once
//   (a cooperative launch).  A block owns a contiguous slab of rows.
// * A row is taken by a team of 1, 2, 4 or 8 warps, the bucket: the fewest
//   that cover d at four 16-byte packs a thread, so a block has 8, 4, 2 or 1
//   rows in flight.  A thread owns the same packs in every row and keeps f32
//   dgamma sums for its columns in registers beside its gamma packs, loaded
//   once.  A pack past d is predicated off (at d = 896 bf16 half the lanes
//   hold a fourth pack), never branched around.
// * Loads: the team's rows stream through a ring of kStages row buffers in
//   shared memory, filled by bulk asynchronous copies (cp.async.bulk, the
//   TMA's one-dimensional form) that complete on an mbarrier, issued kStages
//   rows ahead by the team's first thread.  The bytes in flight cost no
//   registers, which the dgamma sums need: holding a row's packs in registers
//   instead took the kernel past 128 registers a thread, and it spilled.  The
//   row sums are a warp butterfly (and for a team of several warps an exchange
//   through shared memory behind the team's named barrier); dx is computed
//   from the buffer and written, so device memory sees x and dy once and dx
//   once.
// * dgamma, deterministic and without float atomics: at the slab's end the
//   teams meet in shared memory and are added in team order, and the block
//   writes one f32 partial row.  Then a grid-wide barrier (a counter in device
//   memory, arrive and depart, left at 0 for the next launch), after which the
//   blocks add the partial rows column by column in a fixed order and write
//   dgamma in gamma's dtype.  dgamma is the same bit for bit in every call.
//   The barrier's one round of loads, spread over the grid, keeps the tail
//   short; a last-block sum (each block takes a ticket, the last one adds
//   every partial row) puts a chain of fences, atomics and loads on one SM.
//   Compiled with -DRMSNORM_BWD_TAIL=0 the kernel stops after the partial
//   rows (dgamma is not written): chip_smoke.py times that build to measure
//   the tail.
// * Rows wider than a team of 8 warps holds (d > 8192 bf16, 4096 f32), and
//   views that cannot take 16-byte loads, take the chunked kernel: the whole
//   block a row, the row in chunks of register loads, its sums in a first pass
//   and dx in a second that re-reads each chunk (L1/L2 hits, as the first pass
//   just brought it in), dgamma accumulated in the block's own partial row in
//   device memory, each column owned by one thread.

#include <stdint.h>

#include "common.cuh"

#ifndef RMSNORM_BWD_TAIL
#define RMSNORM_BWD_TAIL 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;   // the wrapper's BLOCKS_PER_SM: registers and
                                  // shared memory are sized so that all fit
constexpr int kPacks = 4;         // packs a thread holds in a row
constexpr int kChunkPacks = 2;    // ... and in a chunk of the chunked kernel, which
                                  // holds its partial sums and gamma's packs too
constexpr int kStages = 2;        // row buffers a team keeps in flight
constexpr int kBarBytes = 8 * kWarps * kStages;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSpinLimit = 1u << 25;  // ~2 s of polling at the barrier, then a trap
constexpr unsigned kWaitLimit = 1u << 16;  // tries of a row buffer's wait, then a trap

struct Args {
  const void* x;
  const void* gamma;
  const void* dy;
  void* dx;
  void* dgamma;
  float* partial;  // (slabs, d): a row per slab
  int* counters;   // 2, both 0 between launches: the barrier's arrivals and departures
  int rows, d, rows_per_slab;
  float eps;
};

template <typename E, int VEC>
__device__ __forceinline__ void zero(Pack<E, VEC>& p) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) p.v[e] = from_f32<E>(0.f);
}

// A pack of read-only input: 16-byte loads (two for 8 f32 gamma values, one
// 8-byte load for 4 bf16 ones), or one element on the scalar path.
template <typename E, int VEC>
__device__ __forceinline__ void load(Pack<E, VEC>& out, const E* p) {
  constexpr int kBytes = sizeof(E) * VEC;
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      reinterpret_cast<uint4*>(&out)[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(&out) = __ldg(reinterpret_cast<const uint2*>(p));
  } else {
    static_assert(VEC == 1, "a pack is 16 bytes, or one element");
    out.v[0] = p[0];
  }
}

__device__ __forceinline__ void team_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

// The leader's arrival, announcing `bytes` of copies that complete on the barrier.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the barrier's phase of this parity; each try suspends the thread for
// at most about 0.1 ms, and a wait of seconds (a copy that never lands) traps.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (unsigned tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity), "r"(100000u)
        : "memory");
    if (done) return;
    if (tries > kWaitLimit) __trap();
  }
}

// bytes (a multiple of 16, both addresses on 16 bytes) from device to shared memory
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// (sum of x^2, sum of x * gamma * dy) over a row's team: a warp butterfly (every
// lane ends with the same bits), then for a team of several warps the warps'
// sums through shared memory, added in warp order.  `red` is double-buffered by
// the team's row parity, so one barrier a row suffices.
template <int TW>
__device__ __forceinline__ float2 row_sums(float ss, float sgd, float (*red)[kWarps][2],
                                           int parity, int team) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ss += __shfl_xor_sync(kFull, ss, o);
    sgd += __shfl_xor_sync(kFull, sgd, o);
  }
  if constexpr (TW > 1) {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
      red[parity][warp][0] = ss;
      red[parity][warp][1] = sgd;
    }
    team_sync(1 + team, 32 * TW);
    ss = sgd = 0.f;
#pragma unroll
    for (int w = 0; w < TW; ++w) {
      ss += red[parity][team * TW + w][0];
      sgd += red[parity][team * TW + w][1];
    }
  }
  return make_float2(ss, sgd);
}

template <int W>
struct Cols {  // W f32 columns
  float v[W];
};

template <int W>
__device__ __forceinline__ void add(Cols<W>& s, const Cols<W>& t) {
#pragma unroll
  for (int i = 0; i < W; ++i) s.v[i] += t.v[i];
}

// dgamma[c] = sum over slabs of partial[slab, c], W columns a unit.  Block b
// takes units 8b..8b+7 (and every gridDim.x * 8-th after); thread (unit j,
// lane k) adds slabs k, k + 32, ... in order, 8 loads in flight; the 32 lanes'
// sums of a unit meet by a fixed butterfly inside the warps and in warp order
// across them.  The partial rows were written by other blocks of this launch,
// so they are read from L2.
template <typename G, int W>
__device__ void sum_partials(const Args& a, int slabs) {
  __shared__ Cols<W> wsum[kWarps][8];
  const int j = threadIdx.x % 8, k = threadIdx.x / 8, warp = threadIdx.x / 32;
  const int units = a.d / W;
  const Cols<W>* part = reinterpret_cast<const Cols<W>*>(a.partial);
  for (int u0 = blockIdx.x * 8; u0 < units; u0 += gridDim.x * 8) {
    const int u = u0 + j;
    Cols<W> s;
#pragma unroll
    for (int i = 0; i < W; ++i) s.v[i] = 0.f;
    if (u < units) {
      for (int k0 = k; k0 < slabs; k0 += 32 * 8) {
        Cols<W> v[8];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
#pragma unroll
          for (int i = 0; i < W; ++i) v[b].v[i] = 0.f;
          if (k0 + 32 * b < slabs) {
            const float* src = reinterpret_cast<const float*>(part + (size_t)(k0 + 32 * b) * units + u);
            if constexpr (W == 4) {
              const float4 q = __ldcg(reinterpret_cast<const float4*>(src));
              v[b].v[0] = q.x, v[b].v[1] = q.y, v[b].v[2] = q.z, v[b].v[3] = q.w;
            } else {
              v[b].v[0] = __ldcg(src);
            }
          }
        }
#pragma unroll
        for (int b = 0; b < 8; ++b) add(s, v[b]);
      }
    }
    // lanes j + 8m of a warp hold 4 slab lanes of unit j
#pragma unroll
    for (int o = 8; o < 32; o <<= 1) {
#pragma unroll
      for (int i = 0; i < W; ++i) s.v[i] += __shfl_xor_sync(kFull, s.v[i], o);
    }
    if (threadIdx.x % 32 < 8) wsum[warp][j] = s;
    __syncthreads();
    if (threadIdx.x < 8 && u < units) {
      Cols<W> t = wsum[0][j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) add(t, wsum[w][j]);
      G* dg = static_cast<G*>(a.dgamma) + (size_t)u * W;
#pragma unroll
      for (int i = 0; i < W; ++i) dg[i] = from_f32<G>(t.v[i]);
    }
    __syncthreads();
  }
}

// After the block's partial row is written: the grid-wide barrier, the sums of
// the block's columns, and the departure that leaves the counters at 0.
template <typename G>
__device__ void grid_tail(const Args& a) {
#if RMSNORM_BWD_TAIL
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");  // this block's partial row
    atomicAdd(a.counters, 1);
    for (unsigned spins = 0; ld_acquire(a.counters) < (int)gridDim.x; ++spins) {
      if (spins > kSpinLimit) __trap();
      __nanosleep(64);
    }
  }
  __syncthreads();
  if (a.d % 4 == 0)
    sum_partials<G, 4>(a, gridDim.x);
  else
    sum_partials<G, 1>(a, gridDim.x);
  if (threadIdx.x == 0 && atomicAdd(a.counters + 1, 1) == (int)gridDim.x - 1) {
    a.counters[0] = 0;  // every block has left the barrier
    a.counters[1] = 0;
  }
#endif
}

// The register path: T x, dy, dx; G gamma, dgamma; TW warps a row.
template <typename T, typename G, int TW>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) rmsnorm_bwd_kernel(const Args a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NT = kWarps / TW;  // rows in flight a block
  constexpr int TT = 32 * TW;      // threads a row
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][kWarps][2];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [NT][kStages]
  T* ring = reinterpret_cast<T*>(smem + kBarBytes);     // [NT][kStages][x row, dy row]
  const int team = threadIdx.x / TT;
  const int tl = threadIdx.x % TT;  // the thread's place in its team
  const int d = a.d, P = d / VEC;   // packs a row
  const uint32_t row_bytes = (uint32_t)d * sizeof(T);
  const int r0 = blockIdx.x * a.rows_per_slab;
  const int r1 = min(a.rows, r0 + a.rows_per_slab);
  const int nrows = r1 - r0 > team ? (r1 - r0 - team + NT - 1) / NT : 0;  // the team's rows
  const float fd = (float)d;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  const G* gamma = static_cast<const G*>(a.gamma);
  uint64_t* tbars = bars + team * kStages;
  T* tring = ring + (size_t)team * kStages * 2 * d;

  if (threadIdx.x < NT * kStages) mbar_init(bars + threadIdx.x);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
  // the team's i-th row (r0 + team + NT * i) into buffer i % kStages
  auto issue = [&](int i) {
    const int s = i % kStages;
    const size_t off = (size_t)(r0 + team + NT * i) * d;
    T* buf = tring + (size_t)s * 2 * d;
    mbar_expect(tbars + s, 2 * row_bytes);
    bulk_copy(buf, x + off, row_bytes, tbars + s);
    bulk_copy(buf + d, dy + off, row_bytes, tbars + s);
  };
  if (tl == 0) {
    for (int i = 0; i < min(nrows, kStages); ++i) issue(i);
  }

  Pack<G, VEC> g[kPacks];
  float acc[kPacks][VEC];
#pragma unroll
  for (int j = 0; j < kPacks; ++j) {
    const int p = tl + TT * j;
    zero(g[j]);
    if (p < P) load(g[j], gamma + p * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;
  }
  for (int i = 0; i < nrows; ++i) {
    const int s = i % kStages;
    mbar_wait(tbars + s, (i / kStages) & 1);
    const T* bx = tring + (size_t)s * 2 * d;
    const T* bd = bx + d;
    float ss = 0.f, sgd = 0.f;
#pragma unroll
    for (int j = 0; j < kPacks; ++j) {
      const int p = tl + TT * j;
      Pack<T, VEC> xv, dv;
      zero(xv);
      zero(dv);
      if (p < P) {
        xv = *reinterpret_cast<const Pack<T, VEC>*>(bx + p * VEC);
        dv = *reinterpret_cast<const Pack<T, VEC>*>(bd + p * VEC);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xf = to_f32(xv.v[e]);
        ss += xf * xf;
        sgd += xf * to_f32(g[j].v[e]) * to_f32(dv.v[e]);
      }
    }
    const float2 sums = row_sums<TW>(ss, sgd, red, i & 1, team);
    const float r = rsqrtf(sums.x / fd + a.eps);
    const float coef = r * r * r * sums.y / fd;
    const size_t off = (size_t)(r0 + team + NT * i) * d;
#pragma unroll
    for (int j = 0; j < kPacks; ++j) {
      const int p = tl + TT * j;
      if (p < P) {
        const Pack<T, VEC> xv = *reinterpret_cast<const Pack<T, VEC>*>(bx + p * VEC);
        const Pack<T, VEC> dv = *reinterpret_cast<const Pack<T, VEC>*>(bd + p * VEC);
        Pack<T, VEC> out;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xf = to_f32(xv.v[e]), df = to_f32(dv.v[e]);
          out.v[e] = from_f32<T>(r * to_f32(g[j].v[e]) * df - xf * coef);
          acc[j][e] += df * xf * r;
        }
        *reinterpret_cast<Pack<T, VEC>*>(dx + off + p * VEC) = out;
      }
    }
    // the buffer is free once the whole team has read it
    if constexpr (TW == 1)
      __syncwarp();
    else
      team_sync(1 + team, TT);
    if (tl == 0 && i + kStages < nrows) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(i + kStages);
    }
  }

  float* prow = a.partial + (size_t)blockIdx.x * d;
  if constexpr (NT == 1) {
    // one team: every column has one owner, which writes it
#pragma unroll
    for (int j = 0; j < kPacks; ++j) {
      const int p = tl + TT * j;
      if (p < P) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) prow[p * VEC + e] = acc[j][e];
      }
    }
  } else {
    // the teams meet in shared memory (the ring, every copy consumed) and are
    // added in team order
    float* comb = reinterpret_cast<float*>(ring);  // [NT][d]
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPacks; ++j) {
      const int p = tl + TT * j;
      if (p < P) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) comb[team * d + p * VEC + e] = acc[j][e];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float sum = comb[c];
#pragma unroll
      for (int t = 1; t < NT; ++t) sum += comb[t * d + c];
      prow[c] = sum;
    }
  }
  grid_tail<G>(a);
}

// The chunked path, the whole block a row: T x, dy, dx; G gamma, dgamma; VEC
// elements a pack (16 bytes, or 1 for a view that cannot take 16-byte loads).
template <typename T, typename G, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) rmsnorm_bwd_chunked_kernel(const Args a) {
  constexpr int kChunk = kThreads * kChunkPacks;  // packs a chunk
  __shared__ float red[2][kWarps][2];
  const int tl = threadIdx.x;
  const int d = a.d, P = d / VEC;
  const int r0 = blockIdx.x * a.rows_per_slab;
  const int r1 = min(a.rows, r0 + a.rows_per_slab);
  const float fd = (float)d;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  const G* gamma = static_cast<const G*>(a.gamma);
  float* prow = a.partial + (size_t)blockIdx.x * d;
  // the thread's columns of the block's partial row start at 0; pack p is
  // always thread p % kThreads's
  for (int p = tl; p < P; p += kThreads) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) prow[p * VEC + e] = 0.f;
  }
  for (int row = r0; row < r1; ++row) {
    const size_t off = (size_t)row * d;
    float ss = 0.f, sgd = 0.f;
    for (int base = 0; base < P; base += kChunk) {
      Pack<T, VEC> xv[kChunkPacks], dv[kChunkPacks];
      Pack<G, VEC> g[kChunkPacks];
#pragma unroll
      for (int j = 0; j < kChunkPacks; ++j) {
        const int p = base + tl + kThreads * j;
        zero(xv[j]);
        zero(dv[j]);
        zero(g[j]);
        if (p < P) {
          load(xv[j], x + off + p * VEC);
          load(dv[j], dy + off + p * VEC);
          load(g[j], gamma + p * VEC);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunkPacks; ++j) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xf = to_f32(xv[j].v[e]);
          ss += xf * xf;
          sgd += xf * to_f32(g[j].v[e]) * to_f32(dv[j].v[e]);
        }
      }
    }
    const float2 s = row_sums<kWarps>(ss, sgd, red, (row - r0) & 1, 0);
    const float r = rsqrtf(s.x / fd + a.eps);
    const float coef = r * r * r * s.y / fd;
    for (int base = 0; base < P; base += kChunk) {
      Pack<T, VEC> xv[kChunkPacks], dv[kChunkPacks];
      Pack<G, VEC> g[kChunkPacks];
      float acc[kChunkPacks][VEC];
#pragma unroll
      for (int j = 0; j < kChunkPacks; ++j) {
        const int p = base + tl + kThreads * j;
        zero(xv[j]);
        zero(dv[j]);
        zero(g[j]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;
        if (p < P) {
          load(xv[j], x + off + p * VEC);
          load(dv[j], dy + off + p * VEC);
          load(g[j], gamma + p * VEC);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[j][e] = prow[p * VEC + e];  // the thread's own
        }
      }
#pragma unroll
      for (int j = 0; j < kChunkPacks; ++j) {
        const int p = base + tl + kThreads * j;
        Pack<T, VEC> out;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xf = to_f32(xv[j].v[e]), df = to_f32(dv[j].v[e]);
          out.v[e] = from_f32<T>(r * to_f32(g[j].v[e]) * df - xf * coef);
          acc[j][e] += df * xf * r;
        }
        if (p < P) {
          *reinterpret_cast<Pack<T, VEC>*>(dx + off + p * VEC) = out;
#pragma unroll
          for (int e = 0; e < VEC; ++e) prow[p * VEC + e] = acc[j][e];
        }
      }
    }
  }
  grid_tail<G>(a);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// A cooperative launch, so that every block is resident for the barrier; the
// kernel's shared-memory limit is raised first where it needs more than 48 KB.
template <typename Kernel>
cudaError_t launch_all_resident(Kernel kernel, int blocks, size_t smem, const Args& a,
                                cudaStream_t s) {
  if (smem > 48 * 1024) {
    if (cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
      return err;
  }
  void* args[] = {const_cast<Args*>(&a)};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                     dim3(kThreads), args, smem, s);
}

template <typename T, typename G>
cudaError_t launch(const Args& a, int slabs, int bucket, bool wide, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int covered = 32 * bucket * kPacks * kVec;  // columns a team holds
  if (wide && (a.d % kVec != 0 || !aligned16(a.x) || !aligned16(a.dy) || !aligned16(a.dx) ||
               !aligned16(a.gamma) || (bucket > 0 && a.d > covered)))
    return cudaErrorInvalidValue;
  if (!wide && bucket != 0) return cudaErrorInvalidValue;
  if (!wide) return launch_all_resident(rmsnorm_bwd_chunked_kernel<T, G, 1>, slabs, 0, a, s);
  const size_t ring =
      kBarBytes + (size_t)(kWarps / (bucket ? bucket : 1)) * kStages * 2 * a.d * sizeof(T);
  switch (bucket) {
    case 0: return launch_all_resident(rmsnorm_bwd_chunked_kernel<T, G, kVec>, slabs, 0, a, s);
    case 1: return launch_all_resident(rmsnorm_bwd_kernel<T, G, 1>, slabs, ring, a, s);
    case 2: return launch_all_resident(rmsnorm_bwd_kernel<T, G, 2>, slabs, ring, a, s);
    case 4: return launch_all_resident(rmsnorm_bwd_kernel<T, G, 4>, slabs, ring, a, s);
    case 8: return launch_all_resident(rmsnorm_bwd_kernel<T, G, 8>, slabs, ring, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, dy, dx: (rows, d) contiguous, one dtype; gamma, dgamma: (d,) contiguous, one
// dtype.  partial: (slabs, d) f32 scratch; counters: 2 ints, 0 on entry and left
// 0.  Slab k holds rows [k * rows_per_slab, (k + 1) * rows_per_slab); slabs must
// not exceed two blocks an SM.  bucket: warps a row (1, 2, 4 or 8) on the
// register path, 0 for the chunked path; wide: 16-byte packs (else one element,
// chunked).  Returns the launch error (0 on success).
extern "C" int rmsnorm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                           void* dgamma, float* partial, int* counters, int rows, int d,
                           int slabs, int rows_per_slab, int bucket, int wide, float eps,
                           int x_dtype, int g_dtype, int device, void* stream) {
  if (d == 0) return cudaSuccess;
  if (slabs <= 0 || rows_per_slab <= 0 || rows < 0 || (long long)slabs * rows_per_slab < rows)
    return cudaErrorInvalidValue;
  if (cudaError_t err = cudaSetDevice(device)) return err;
  const Args a{x, gamma, dy, dx, dgamma, partial, counters, rows, d, rows_per_slab, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32 && g_dtype == kFloat32)
    return launch<float, float>(a, slabs, bucket, wide, s);
  if (x_dtype == kFloat32 && g_dtype == kBFloat16)
    return launch<float, __nv_bfloat16>(a, slabs, bucket, wide, s);
  if (x_dtype == kBFloat16 && g_dtype == kFloat32)
    return launch<__nv_bfloat16, float>(a, slabs, bucket, wide, s);
  if (x_dtype == kBFloat16 && g_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, slabs, bucket, wide, s);
  return cudaErrorInvalidValue;
}
