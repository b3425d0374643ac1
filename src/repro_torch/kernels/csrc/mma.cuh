// Tensor-core building blocks shared by the bf16 attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): warp-level mma.sync on
// m16n8k16 bf16 tiles with f32 accumulators, ldmatrix fragment loads,
// cp.async copies into a padded shared-memory tile layout.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), four b32 registers of two bf16 each:
//     a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//     a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, k x n, "col"), two registers: b0 (k 2t, 2t+1; n g), b1 (k 2t+8, 2t+9; n g);
//   C/D (16 x 8, f32), four floats: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// A C tile of two neighbouring n-tiles, rounded to bf16 and paired, is exactly
// the A fragment of the next product over those 16 columns (pack_bf16): that
// is how P and dS go from one product to the next without shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

// Shared-memory tiles hold rows of DH bf16 padded by 8 elements (16 bytes):
// the 8 rows that one ldmatrix phase reads then start 4 banks apart (DH 32, 64,
// 128, and 256 with rows of 132 words) or at banks 0, 12, 24, 4, 16, 28, 8, 20
// (DH 80, rows of 44 words), so
// the phase's 16-byte reads touch all 32 banks once; and every row start stays
// 16-byte aligned for cp.async.  DH must be a multiple of 16 (whole k-chunks).
template <int DH>
struct Tile {
  static constexpr int kStride = DH + 8;  // elements between rows
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i, and
// register i of every lane receives its part of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// The same with each 8x8 matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a * b on one 16 x 8 x 16 tile, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 in one register, lo in the low half (the
// lower column of a fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes global -> shared, bypassing L1; with ok false nothing is read and
// the 16 bytes are zero-filled (rows past a ragged edge).  src must be a
// valid address either way.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (lse and D rows), zero-filled when ok is false.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS x DH bf16 rows [row0, row0 + ROWS) of a (seq, DH) slice with row stride
// `ld` elements into a padded tile, by cp.async; rows at or past row_end are
// zero-filled and not read.  The caller commits the group.
template <int ROWS, int DH, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long ld, int row0, int row_end, int tid) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < row_end;
    const __nv_bfloat16* src = ok ? base + (long long)(row0 + r) * ld + c * 8 : base;
    cp_async_16(dst + r * Tile<DH>::kStride + c * 8, src, ok);
  }
}

// Lane offsets (row, column) into a padded tile of the address each lane gives
// ldmatrix_x4, for the three fragment shapes used:
//  * A fragment of a 16 x 16 row-major block, or B fragments (trans) of two
//    n-tiles of a k x n block stored k-major (V in P.V, K in dS.K, dO in Pt.dO,
//    Q in dSt.Q): matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15);
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
//  * B fragments (no trans) of two n-tiles of 8 rows and one k-chunk of 16
//    columns of a block stored n-major (K in Q.Kt, V in dO.Vt, Q and dO in
//    K.Qt and V.dOt): matrices (rows 0-7, cols 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15),
//    so registers (0, 1) are n-tile 0's (b0, b1) and (2, 3) n-tile 1's.
__device__ __forceinline__ int b_row(int lane) { return ((lane >> 4) << 3) + (lane & 7); }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) << 3; }

// acc[n] (16 x 8 f32 tiles, n over NT n-tiles) += A (16 x 16*KC, fragments a[kc])
// times the rows [0, 8*NT) x cols [0, 16*KC) of an n-major padded tile, transposed:
// out[i][j] += sum_k A[i][k] * tile[j][k].
template <int NT, int KC, int DH, typename AFn>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], AFn a_frag,
                                        const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t a[4];
    a_frag(kc, a);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, tile + (np * 16 + b_row(lane)) * Tile<DH>::kStride + kc * 16 + b_col(lane));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] (16 x 8 f32 tiles over DH / 8 n-tiles) += P (16 x 16*KC, as the f32
// C tiles p[2*KC][4], rounded to bf16 here) times rows [0, 16*KC) of a k-major
// padded tile: out[i][j] += sum_k P[i][k] * tile[k][j].
template <int KC, int DH>
__device__ __forceinline__ void mma_pv(float (&acc)[DH / 8][4], const float (&p)[2 * KC][4],
                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const uint32_t a[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                           pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                           pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                           pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + (kc * 16 + a_row(lane)) * Tile<DH>::kStride + dp * 16 +
                               a_col(lane));
      mma_bf16(acc[2 * dp], a, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// A fragments of a warp's 16 rows of a padded tile, over DH / 16 k-chunks: held
// in registers when RESIDENT, else read from shared memory at each use (at DH
// 128 the registers go to the accumulators instead).
template <int DH, bool RESIDENT>
struct AFrags {
  static constexpr int kChunks = DH / 16;
  uint32_t r[RESIDENT ? kChunks : 1][4];
  const __nv_bfloat16* rows;  // the warp's first row in the tile

  __device__ __forceinline__ void init(const __nv_bfloat16* tile_rows, int lane) {
    rows = tile_rows + a_row(lane) * Tile<DH>::kStride + a_col(lane);
    if constexpr (RESIDENT) {
#pragma unroll
      for (int kc = 0; kc < kChunks; ++kc) ldmatrix_x4(r[kc], rows + kc * 16);
    }
  }

  __device__ __forceinline__ void operator()(int kc, uint32_t (&a)[4]) const {
    if constexpr (RESIDENT) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = r[kc][i];
    } else {
      ldmatrix_x4(a, rows + kc * 16);
    }
  }
};

// Stores a warp's 16 x DH f32 accumulators (times `mul`) as bf16 rows
// [row0, row0 + 16) of a (seq, DH) slice with row stride `ld`, rows at or past
// row_end skipped: through the warp's own 16 rows of a padded tile, so that
// every global store is 16 bytes.
template <int DH>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 8][4], float mul0, float mul1,
                                           __nv_bfloat16* stage, __nv_bfloat16* out,
                                           long long ld, int row0, int row_end, int lane) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int S = Tile<DH>::kStride;
  __syncwarp();  // the warp's last reads of these rows are done
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * S + n * 8 + 2 * t) =
        pack_bf16(acc[n][0] * mul0, acc[n][1] * mul0);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * S + n * 8 + 2 * t) =
        pack_bf16(acc[n][2] * mul1, acc[n][3] * mul1);
  }
  __syncwarp();
  constexpr int kChunks = DH / 8;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    if (row0 + r < row_end)
      *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * ld + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * S + c * 8);
  }
}

// The attention masks and bands of the three bf16 kernels.  Query q sees key k
// when q < sq, k < valid_k, (causal) q >= k and (window) q - k < window;
// positions count from 0 in both sequences.
struct Band {
  int sq, valid_k, causal, window;

  __device__ __forceinline__ bool visible(int qpos, int kpos) const {
    return qpos < sq && kpos < valid_k && (!causal || qpos >= kpos) &&
           (window <= 0 || qpos - kpos < window);
  }

  // Whether some pair of queries [q0, q0 + nq) and keys [k0, k0 + nk) is
  // masked: only such tiles pay for the per-element test.
  __device__ __forceinline__ bool crosses(int q0, int nq, int k0, int nk) const {
    return q0 + nq > sq || k0 + nk > valid_k || (causal && k0 + nk - 1 > q0) ||
           (window > 0 && q0 + nq - 1 - k0 >= window);
  }

  // Tiles of nk keys from `begin` (a multiple of nk) that hold a key some query
  // of [q0, q0 + nq) sees; the keys at or past *end are all masked.
  __device__ __forceinline__ int key_tiles(int q0, int nq, int nk, int* begin, int* end) const {
    int e = valid_k;
    if (causal) e = min(e, min(q0 + nq, sq));
    int b = window > 0 ? max(0, q0 - window + 1) : 0;
    b = b / nk * nk;
    *begin = b;
    *end = e;
    return e > b ? (e - b + nk - 1) / nk : 0;
  }

  // Tiles of nq queries from `begin` (a multiple of nq) that hold a query that
  // sees some key of [k0, k0 + nk), k0 a multiple of nq.
  __device__ __forceinline__ int query_tiles(int k0, int nk, int nq, int* begin) const {
    const int k_last = min(k0 + nk, valid_k) - 1;
    if (k_last < k0) return 0;  // the whole tile is past valid_k
    const int b = causal ? k0 / nq * nq : 0;
    const int e = window > 0 ? min(sq, k_last + window) : sq;
    *begin = b;
    return e > b ? (e - b + nq - 1) / nq : 0;
  }
};

}  // namespace mma
