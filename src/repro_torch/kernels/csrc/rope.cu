// Rotary position embedding (RoPE) for Hopper (sm_90a), forward and backward:
// q and k rotated in one launch, split-half, in f32 registers.
//
//   forward:  y1 = x1 cos - x2 sin,    y2 = x1 sin + x2 cos
//   backward: dx1 = g1 cos + g2 sin,   dx2 = g2 cos - g1 sin
//
// x1 and x2 are the first and second half of a head's dh values; cos and sin
// are f32 tables of (table_rows, s, dh / 2), table_rows 1 (every row of the
// batch at the same positions) or b (each row at its own).  Each product, sum
// and difference is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, so
// that nothing contracts into an FMA), and the result once to the tensor's
// dtype, as the plain version's eager passes and autograd's backward of them
// round: the results are theirs bit for bit (kernels/rope/ref.py).
//
// Replaces no TPU kernel: the JAX package's RoPE (src/repro/models/layers.py
// apply_rope) is plain jnp, which XLA fuses into its neighbours.  Run eagerly,
// the same arithmetic is some ten passes over each tensor in each direction
// (upcast, four products, a difference and a sum, a concatenation, a cast);
// this kernel is those passes fused.
//
// Bound: device-memory bytes.  A call reads q and k once and writes them once;
// the tables are s x dh/2 values shared by every head and stay in L2.  At
// hubert-xlarge's coded step, q and k of (128, 16, 500, 80) in bf16, that is
// 4 x 163.8 MB, 0.196 ms at 3.35 TB/s, for six f32 operations a pair of values.
//
// Design: one read and one write of each value.  A team of threads takes a row
// (one (batch, position, head) of dh values), each thread 16 bytes of each half
// (8 bf16 or 4 f32) with the matching cos and sin, the rows in the order of the
// projection's (b, s, heads, dh) layout, so that a warp reads neighbouring
// heads of one position and they share a table row.  Rows are addressed
// through the (b, h, s) strides the wrapper passes: the head-transposed views
// of the projections are read in place, and the outputs written in whatever
// layout the wrapper allocated (the forward's contiguous (b, h, s, dh), the
// backward's the input's).  A view whose rows cannot take 16-byte packs takes
// one pair of values a thread.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// One rotated tensor: x read, y written, each a (b, h, s, dh) tensor reached
// through its (b, h, s) strides in elements, its last dimension contiguous.
struct Side {
  const void* x;
  void* y;
  long long xs[3];
  long long ys[3];
  int h;
  int rows;    // b * h * s
  int blocks;  // blocks of the grid that take its rows
};

template <int VEC>
__device__ __forceinline__ void load_table(const float* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + j);
      v[j] = f.x;
      v[j + 1] = f.y;
      v[j + 2] = f.z;
      v[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = p[j];
  }
}

// The grid's first q.blocks blocks take q's rows, the rest k's.  tpr threads
// a row (kThreads / tpr rows a block), each VEC values of each half a step.
template <typename T, int VEC, bool kBackward>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const Side q, const Side k, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, int s, int half, int table_rows, int tpr) {
  const bool second = blockIdx.x >= q.blocks;
  const int rows_a_block = kThreads / tpr;
  const int t = threadIdx.x / tpr;
  const int lane = threadIdx.x - t * tpr;
  if (t >= rows_a_block) return;
  const int row = (second ? blockIdx.x - q.blocks : blockIdx.x) * rows_a_block + t;
  if (row >= (second ? k.rows : q.rows)) return;
  // (b, s, h) order: the projection's
  const int h = second ? k.h : q.h;
  const int hi = row % h;
  const int bs = row / h;
  const int si = bs % s;
  const int bi = bs / s;
  const T* x = static_cast<const T*>(second ? k.x : q.x) +
               bi * (second ? k.xs[0] : q.xs[0]) + hi * (second ? k.xs[1] : q.xs[1]) +
               si * (second ? k.xs[2] : q.xs[2]);
  T* y = static_cast<T*>(second ? k.y : q.y) + bi * (second ? k.ys[0] : q.ys[0]) +
         hi * (second ? k.ys[1] : q.ys[1]) + si * (second ? k.ys[2] : q.ys[2]);
  const long long tab = ((long long)(table_rows > 1 ? bi : 0) * s + si) * half;

  for (int c = lane * VEC; c < half; c += tpr * VEC) {
    const Pack<T, VEC> a = *reinterpret_cast<const Pack<T, VEC>*>(x + c);
    const Pack<T, VEC> b = *reinterpret_cast<const Pack<T, VEC>*>(x + half + c);
    float cv[VEC], sv[VEC];
    load_table<VEC>(cos_t + tab + c, cv);
    load_table<VEC>(sin_t + tab + c, sv);
    Pack<T, VEC> o1, o2;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float x1 = to_f32(a.v[j]);
      const float x2 = to_f32(b.v[j]);
      if constexpr (kBackward) {
        o1.v[j] = from_f32<T>(__fadd_rn(__fmul_rn(x1, cv[j]), __fmul_rn(x2, sv[j])));
        o2.v[j] = from_f32<T>(__fsub_rn(__fmul_rn(x2, cv[j]), __fmul_rn(x1, sv[j])));
      } else {
        o1.v[j] = from_f32<T>(__fsub_rn(__fmul_rn(x1, cv[j]), __fmul_rn(x2, sv[j])));
        o2.v[j] = from_f32<T>(__fadd_rn(__fmul_rn(x1, sv[j]), __fmul_rn(x2, cv[j])));
      }
    }
    *reinterpret_cast<Pack<T, VEC>*>(y + c) = o1;
    *reinterpret_cast<Pack<T, VEC>*>(y + half + c) = o2;
  }
}

template <typename T, bool kBackward>
cudaError_t launch(Side q, Side k, const float* cos_t, const float* sin_t, int s, int half,
                   int table_rows, bool wide, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int vec = wide ? kVec : 1;
  const int tpr = half / vec < kThreads ? half / vec : kThreads;
  const int rows_a_block = kThreads / tpr;
  q.blocks = (q.rows + rows_a_block - 1) / rows_a_block;
  k.blocks = (k.rows + rows_a_block - 1) / rows_a_block;
  const int grid = q.blocks + k.blocks;
  if (grid == 0) return cudaSuccess;
  if (wide)
    rope_kernel<T, kVec, kBackward><<<grid, kThreads, 0, stream>>>(
        q, k, cos_t, sin_t, s, half, table_rows, tpr);
  else
    rope_kernel<T, 1, kBackward><<<grid, kThreads, 0, stream>>>(
        q, k, cos_t, sin_t, s, half, table_rows, tpr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Side& q, const Side& k, const float* cos_t, const float* sin_t, int s,
                     int half, int table_rows, bool wide, bool backward, cudaStream_t stream) {
  if (backward)
    return launch<T, true>(q, k, cos_t, sin_t, s, half, table_rows, wide, stream);
  return launch<T, false>(q, k, cos_t, sin_t, s, half, table_rows, wide, stream);
}

}  // namespace

// q (b, hq, s, dh) and k (b, hk, s, dh), read through their (b, h, s) strides
// (qs*, ks*), rotated into qy and ky (strides qys*, kys*); hk 0 rotates q
// alone.  cos, sin: contiguous f32 (table_rows, s, dh / 2), table_rows 1 or b.
// wide: every row takes 16-byte packs (the wrapper checks the pointers, the
// strides and dh / 2).  backward: the rotation's transpose (dx from dy).
// b * h * s < 2^31 for each tensor (the wrapper checks).  Returns the launch's
// cudaError_t (0 on success).
extern "C" int rope_apply(const void* q, const void* k, void* qy, void* ky, const void* cos_t,
                          const void* sin_t, int b, int hq, int hk, int s, int dh,
                          int table_rows, long long qs0, long long qs1, long long qs2,
                          long long ks0, long long ks1, long long ks2, long long qys0,
                          long long qys1, long long qys2, long long kys0, long long kys1,
                          long long kys2, int wide, int backward, int dtype, int device,
                          void* stream) {
  if (cudaError_t err = cudaSetDevice(device)) return err;
  if (dh % 2 || (table_rows != 1 && table_rows != b)) return cudaErrorInvalidValue;
  const Side sq{q, qy, {qs0, qs1, qs2}, {qys0, qys1, qys2}, hq, b * hq * s, 0};
  const Side sk{k, ky, {ks0, ks1, ks2}, {kys0, kys1, kys2}, hk, b * hk * s, 0};
  const float* c = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(sq, sk, c, sn, s, dh / 2, table_rows, wide, backward, st);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(sq, sk, c, sn, s, dh / 2, table_rows, wide, backward, st);
  return cudaErrorInvalidValue;
}
