// Window statistics of the wait-out gate for Hopper (sm_90a).
//
// Per grid cell of a bool (cells, rows, n) window of straggler rows:
//   gate_window_stats:  distinct (workers straggling anywhere), worker_max (the
//                       most rounds one worker straggles), round_max (the most
//                       stragglers in one round), pair_bad (a worker straggles
//                       in two rounds d >= B apart);
//   gate_buffer_stats:  per worker act (straggles at all), cnt (how often), md
//                       (straggles in rows 0..rows-B); per cell pair_bad.
//
// Replaces the TPU kernels src/repro/kernels/gate_window/gate_window.py::
// _stats_kernel and ::_buffer_kernel.
//
// Bound: device-memory bytes.  Each input byte is read once and each output
// written once; the work is a few integer operations per byte.  At the gate's
// sizes (tens of KB) the launch itself takes longer than either bound.
//
// Design: one warp per cell, over a grid-stride loop of cells, so any cell count
// is taken.  Lane l walks worker columns l, l+32, ... and packs that worker's
// straggles into a bitmask m, bit r for row r.  Then act is m != 0, cnt is
// popc(m), md is m restricted to rows 0..rows-B, and the pairs d rows apart are
// popc(m & (m >> d)).  A row's straggler count is the popc of one warp ballot,
// kept by lane r.  Warp shuffles reduce the per-cell values.  The bytes are read
// in place through the caller's strides: no int32 copy and no padding, which
// the TPU kernel needs for its 128 lanes.  rows <= 32, the width of the mask.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 32;
constexpr unsigned kFull = 0xffffffffu;

struct Window {
  const uint8_t* x;
  long long cells, n, sc, sr, sw;  // element strides of cells, rows, workers
  int rows, B;
};

// Bitmask of the rows in which worker `col` straggles; lane r adds row r's
// straggler count among the warp's 32 columns to *row_count.
__device__ __forceinline__ uint32_t column_mask(const Window& w, const uint8_t* cell,
                                                long long col, int lane, int* row_count) {
  const bool in = col < w.n;
  uint32_t m = 0;
  for (int r = 0; r < w.rows; ++r) {
    const bool bit = in && cell[r * w.sr + col * w.sw] != 0;
    m |= static_cast<uint32_t>(bit) << r;
    const int c = __popc(__ballot_sync(kFull, bit));
    if (lane == r) *row_count += c;
  }
  return m;
}

// Same-worker straggle pairs d >= B rows apart (d >= 1: B <= 0 counts as 1).
__device__ __forceinline__ int pairs(uint32_t m, int rows, int B) {
  int p = 0;
  for (int d = max(B, 1); d < rows; ++d) p += __popc(m & (m >> d));
  return p;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
window_stats_kernel(Window w, int* __restrict__ distinct, int* __restrict__ worker_max,
                    int* __restrict__ round_max, bool* __restrict__ pair_bad) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); c < w.cells; c += step) {
    const uint8_t* cell = w.x + c * w.sc;
    int dist = 0, wmax = 0, pair = 0, row_count = 0;
    for (long long c0 = 0; c0 < w.n; c0 += 32) {  // uniform trip count: ballots need the warp
      const uint32_t m = column_mask(w, cell, c0 + lane, lane, &row_count);
      dist += m != 0;
      wmax = max(wmax, __popc(m));
      pair += pairs(m, w.rows, w.B);
    }
    dist = warp_sum(dist);
    wmax = warp_max(wmax);
    pair = warp_sum(pair);
    const int rmax = warp_max(row_count);  // lanes >= rows hold 0
    if (lane == 0) {
      distinct[c] = dist;
      worker_max[c] = wmax;
      round_max[c] = rmax;
      pair_bad[c] = pair > 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
buffer_stats_kernel(Window w, bool* __restrict__ act, int* __restrict__ cnt,
                    bool* __restrict__ md, bool* __restrict__ pair_bad) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kWarps;
  // rows 0..rows-B pair-violate with the candidate row the gate appends at `rows`
  const uint32_t md_rows =
      w.rows >= w.B ? static_cast<uint32_t>((1ull << (w.rows - max(w.B, 1) + 1)) - 1) : 0u;
  for (long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); c < w.cells; c += step) {
    const uint8_t* cell = w.x + c * w.sc;
    int pair = 0, row_count = 0;
    for (long long c0 = 0; c0 < w.n; c0 += 32) {
      const long long col = c0 + lane;
      const uint32_t m = column_mask(w, cell, col, lane, &row_count);
      pair += pairs(m, w.rows, w.B);
      if (col < w.n) {
        const long long o = c * w.n + col;
        act[o] = m != 0;
        cnt[o] = __popc(m);
        md[o] = (m & md_rows) != 0;
      }
    }
    pair = warp_sum(pair);
    if (lane == 0) pair_bad[c] = pair > 0;
  }
}

cudaError_t prepare(const Window& w, int device, unsigned* blocks) {
  if (w.cells < 0 || w.n < 0 || w.rows < 0 || w.rows > kMaxRows) return cudaErrorInvalidValue;
  if (cudaError_t err = cudaSetDevice(device)) return err;
  const long long need = (w.cells + kWarps - 1) / kWarps;
  *blocks = static_cast<unsigned>(need < 65535 ? need : 65535);  // grid-stride beyond
  return cudaSuccess;
}

}  // namespace

// win: bool (cells, rows, n) at element strides (sc, sr, sw); outputs (cells,)
// contiguous.  Returns the launch's cudaError_t (0 on success).
extern "C" int gate_window_stats(const void* win, long long cells, int rows, long long n,
                                 long long sc, long long sr, long long sw, int B, int* distinct,
                                 int* worker_max, int* round_max, bool* pair_bad, int device,
                                 void* stream) {
  const Window w{static_cast<const uint8_t*>(win), cells, n, sc, sr, sw, rows, B};
  unsigned blocks = 0;
  if (cudaError_t err = prepare(w, device, &blocks)) return err;
  if (cells == 0) return cudaSuccess;
  window_stats_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, distinct, worker_max, round_max, pair_bad);
  return cudaGetLastError();
}

// buf: bool (cells, rows, n) at element strides (sc, sr, sw); act, cnt, md
// (cells, n) and pair_bad (cells,) contiguous.  rows == 0 writes zeros.
extern "C" int gate_buffer_stats(const void* buf, long long cells, int rows, long long n,
                                 long long sc, long long sr, long long sw, int B, bool* act,
                                 int* cnt, bool* md, bool* pair_bad, int device, void* stream) {
  const Window w{static_cast<const uint8_t*>(buf), cells, n, sc, sr, sw, rows, B};
  unsigned blocks = 0;
  if (cudaError_t err = prepare(w, device, &blocks)) return err;
  if (cells == 0) return cudaSuccess;
  buffer_stats_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, act, cnt, md, pair_bad);
  return cudaGetLastError();
}
