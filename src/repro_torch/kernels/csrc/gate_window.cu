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
// Bound: at the gate's sizes, the launch.  Each input byte is read once and
// each output written once, a few integer operations per byte; at (64, 3, 256)
// that is 50 KB, 15 ns at the card's memory rate, far below what any launch
// takes.  So the design keeps one round trip to memory between launch and
// exit, and spreads the cells over the SMs.  The tensor cores, TMA and wgmma
// have nothing to offer here: there is no product, and a cell's rows are a
// few hundred bytes.
//
// Design.  One warp a block and one cell a block at a time, over a grid-stride
// loop of cells (a folded spec axis is more cells): at the gate's 64 cells, 64
// blocks on 64 SMs.  Lane l owns runs of 16 workers (16l, 16l + 512, ...) and
// loads each run's byte of every row before it uses any of them: one 16-byte
// load a row, the row count a template bucket (<= 4, 8, 16, 32), so the loads
// unroll into registers and are all in flight together.  A run is four 32-bit
// words of 0/1 bytes, one byte a worker, combined a word at a time:
//   act, distinct:    OR over the rows; a count is dp4a(word, 0x01010101);
//   cnt, worker_max:  bytewise sum over the rows (<= 32, fits a byte);
//   md:               OR over rows 0..rows-B;
//   round_max:        dp4a row counts, summed over the warp;
//   pair_bad:         a worker straggles twice d >= max(B, 1) rows apart iff its
//                     last straggle row minus its first is >= d; first and last
//                     are kept a byte a worker, and the test is one add into
//                     each byte's top bit.  (The suffix-OR rule, v_r & OR of
//                     rows >= r + d, says the same, but needs a run-time row
//                     index into the registers.)
// Warp totals are single REDUX instructions (__reduce_{add,max,or}_sync).
//
// Any strides are read.  The wrapper says whether the view takes the wide path
// (workers adjacent, every row start 16-byte aligned), checked here again; a
// view that does not (a worker stride other than 1, rows or a start off 16
// bytes), and a run cut short by n, is read byte by byte into the same words.
// rows <= 32.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 32;            // one warp a block
constexpr int kRun = 16;                // workers a lane owns: one 16-byte load a row
constexpr int kMaxRows = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kOnes = 0x01010101u;
// resident one-warp blocks of an H100 (132 SMs x 32): one wave; more cells
// than this are taken by the grid-stride loop
constexpr long long kMaxBlocks = 132 * 32;

struct Window {
  const uint8_t* x;
  long long cells, n, sc, sr, sw;  // element strides of cells, rows, workers
  int rows, B;
  bool wide;                       // 16-byte loads of whole runs
};

// 16 workers' 0/1 bytes: worker 4i + b of the run is byte b of w[i].
struct Run {
  uint32_t w[4];
};

// 1 in each byte of v that is not 0 (a bool byte is 0 or 1 already).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t v) {
  return ((((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) >> 7) & kOnes;
}

// Rows 0..R-1 of the run of workers j0.. of one cell; rows >= w.rows and
// workers >= n read as 0.  On the wide path every row's 16-byte load is issued
// before any is used.  The byte path is for views the gate does not pass; it
// keeps four loads in flight: sixteen a row, unrolled, would hold a register
// each and spill at 16 rows.
template <int R>
__device__ __forceinline__ void load_rows(const Window& w, const uint8_t* cell, long long j0,
                                          Run (&v)[R]) {
  if (w.wide && j0 + kRun <= w.n) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // only the load is conditional, so it is predicated, not branched around
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (r < w.rows) q = __ldg(reinterpret_cast<const uint4*>(cell + r * w.sr + j0));
      v[r].w[0] = nonzero_bytes(q.x);
      v[r].w[1] = nonzero_bytes(q.y);
      v[r].w[2] = nonzero_bytes(q.z);
      v[r].w[3] = nonzero_bytes(q.w);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r].w[0] = v[r].w[1] = v[r].w[2] = v[r].w[3] = 0u;
      if (r >= w.rows) continue;
      const uint8_t* row = cell + r * w.sr;
#pragma unroll 1
      for (int i = 0; i < 4; ++i) {
        uint32_t word = 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const long long col = j0 + 4 * i + k;
          if (col < w.n && __ldg(row + col * w.sw) != 0) word |= 1u << (8 * k);
        }
        // selects, not a run-time index into the registers
        v[r].w[0] |= i == 0 ? word : 0u;
        v[r].w[1] |= i == 1 ? word : 0u;
        v[r].w[2] |= i == 2 ? word : 0u;
        v[r].w[3] |= i == 3 ? word : 0u;
      }
    }
  }
}

// What both kernels take from a run: OR and bytewise sum over the rows, and
// whether a worker straggles twice >= d rows apart (the word's top bits).
struct RunStats {
  Run any, sum;
  uint32_t pair;
};

template <int R>
__device__ __forceinline__ RunStats run_stats(const Run (&v)[R], int d, bool pairs) {
  RunStats s;
  Run first, last;
#pragma unroll
  for (int i = 0; i < 4; ++i) s.any.w[i] = s.sum.w[i] = first.w[i] = last.w[i] = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {  // rows past w.rows are 0 and change nothing
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t m = v[r].w[i] * 0xffu;  // 0xff where the worker straggles
      s.any.w[i] |= v[r].w[i];
      s.sum.w[i] += v[r].w[i];
      last.w[i] = (last.w[i] & ~m) | (m & (r * kOnes));
      const int q = R - 1 - r;  // first: the same, from the last row down
      const uint32_t mq = v[q].w[i] * 0xffu;
      first.w[i] = (first.w[i] & ~mq) | (mq & (q * kOnes));
    }
  }
  // last >= first in every byte (both 0 for an idle worker), so one 32-bit
  // subtraction is bytewise; a difference <= 31 plus 128 - d sets a byte's top
  // bit iff it is >= d (1 <= d < rows <= 32, so no byte carries)
  s.pair = 0u;
  if (pairs) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s.pair |= (last.w[i] - first.w[i] + static_cast<uint32_t>(128 - d) * kOnes) & 0x80808080u;
  }
  return s;
}

__device__ __forceinline__ int count_bytes(const Run& v) {  // of 0/1 bytes
  uint32_t c = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) c = __dp4a(v.w[i], kOnes, c);
  return static_cast<int>(c);
}

__device__ __forceinline__ int max_byte(const Run& v) {
  uint32_t m = __vmaxu4(__vmaxu4(v.w[0], v.w[1]), __vmaxu4(v.w[2], v.w[3]));
  m = __vmaxu4(m, m >> 16);
  m = __vmaxu4(m, m >> 8);
  return static_cast<int>(m & 0xffu);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
window_stats_kernel(Window w, int* __restrict__ distinct, int* __restrict__ worker_max,
                    int* __restrict__ round_max, bool* __restrict__ pair_bad) {
  const int lane = threadIdx.x;
  const int d = max(w.B, 1);
  const bool pairs = d < w.rows;
  for (long long c = blockIdx.x; c < w.cells; c += gridDim.x) {
    const uint8_t* cell = w.x + c * w.sc;
    int dist = 0, wmax = 0, rc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) rc[r] = 0;
    uint32_t pair = 0u;
    for (long long j0 = (long long)lane * kRun; j0 < w.n; j0 += kThreads * kRun) {
      Run v[R];
      load_rows<R>(w, cell, j0, v);
      const RunStats s = run_stats<R>(v, d, pairs);
#pragma unroll
      for (int r = 0; r < R; ++r) rc[r] += count_bytes(v[r]);
      dist += count_bytes(s.any);
      wmax = max(wmax, max_byte(s.sum));
      pair |= s.pair;
    }
    int rmax = 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < w.rows) rmax = max(rmax, __reduce_add_sync(kFull, rc[r]));
    dist = __reduce_add_sync(kFull, dist);
    wmax = __reduce_max_sync(kFull, wmax);
    pair = __reduce_or_sync(kFull, pair);
    if (lane == 0) {
      distinct[c] = dist;
      worker_max[c] = wmax;
      round_max[c] = rmax;
      pair_bad[c] = pair != 0u;
    }
  }
}

// The bytes of a word as four int32.
__device__ __forceinline__ int4 widen(uint32_t v) {
  return make_int4(__byte_perm(v, 0u, 0x4440), __byte_perm(v, 0u, 0x4441),
                   __byte_perm(v, 0u, 0x4442), __byte_perm(v, 0u, 0x4443));
}

template <int R>
__global__ void __launch_bounds__(kThreads)
buffer_stats_kernel(Window w, bool wide_out, bool* __restrict__ act, int* __restrict__ cnt,
                    bool* __restrict__ md, bool* __restrict__ pair_bad) {
  const int lane = threadIdx.x;
  const int d = max(w.B, 1);
  const bool pairs = d < w.rows;
  // rows 0..rows-B pair-violate with the candidate row the gate appends at `rows`
  const long long md_last = (long long)w.rows - w.B;
  for (long long c = blockIdx.x; c < w.cells; c += gridDim.x) {
    const uint8_t* cell = w.x + c * w.sc;
    uint32_t pair = 0u;
    for (long long j0 = (long long)lane * kRun; j0 < w.n; j0 += kThreads * kRun) {
      Run v[R];
      load_rows<R>(w, cell, j0, v);
      const RunStats s = run_stats<R>(v, d, pairs);
      Run m;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        m.w[i] = 0u;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r <= md_last) m.w[i] |= v[r].w[i];
      }
      pair |= s.pair;
      const long long o = c * w.n + j0;
      if (wide_out) {  // n % 16 == 0: whole runs, 16-byte aligned outputs
        *reinterpret_cast<uint4*>(act + o) = make_uint4(s.any.w[0], s.any.w[1], s.any.w[2],
                                                        s.any.w[3]);
        *reinterpret_cast<uint4*>(md + o) = make_uint4(m.w[0], m.w[1], m.w[2], m.w[3]);
        int4* out = reinterpret_cast<int4*>(cnt + o);
#pragma unroll
        for (int i = 0; i < 4; ++i) out[i] = widen(s.sum.w[i]);
      } else {
#pragma unroll
        for (int b = 0; b < kRun; ++b) {
          if (j0 + b < w.n) {
            const int shift = 8 * (b & 3);
            act[o + b] = (s.any.w[b >> 2] >> shift) & 1u;
            md[o + b] = (m.w[b >> 2] >> shift) & 1u;
            cnt[o + b] = static_cast<int>((s.sum.w[b >> 2] >> shift) & 0xffu);
          }
        }
      }
    }
    pair = __reduce_or_sync(kFull, pair);
    if (lane == 0) pair_bad[c] = pair != 0u;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaError_t prepare(const Window& w, int device, unsigned* blocks) {
  if (w.cells < 0 || w.n < 0 || w.rows < 0 || w.rows > kMaxRows) return cudaErrorInvalidValue;
  // the wrapper's wide flag, checked: workers adjacent, every row start aligned
  if (w.wide && !(w.sw == 1 && aligned16(w.x) && (w.sr % 16 == 0 || w.rows <= 1) &&
                  (w.sc % 16 == 0 || w.cells <= 1)))
    return cudaErrorMisalignedAddress;
  if (cudaError_t err = cudaSetDevice(device)) return err;
  *blocks = static_cast<unsigned>(w.cells < kMaxBlocks ? w.cells : kMaxBlocks);
  return cudaSuccess;
}

template <int R>
void launch_window(const Window& w, unsigned blocks, cudaStream_t s, int* distinct,
                   int* worker_max, int* round_max, bool* pair_bad) {
  window_stats_kernel<R><<<blocks, kThreads, 0, s>>>(w, distinct, worker_max, round_max,
                                                     pair_bad);
}

template <int R>
void launch_buffer(const Window& w, unsigned blocks, cudaStream_t s, bool wide_out, bool* act,
                   int* cnt, bool* md, bool* pair_bad) {
  buffer_stats_kernel<R><<<blocks, kThreads, 0, s>>>(w, wide_out, act, cnt, md, pair_bad);
}

}  // namespace

// win: bool (cells, rows, n) at element strides (sc, sr, sw), wide as the
// wrapper's gate_window.wide_path says; outputs (cells,) contiguous.  Returns
// the launch's cudaError_t (0 on success).
extern "C" int gate_window_stats(const void* win, long long cells, int rows, long long n,
                                 long long sc, long long sr, long long sw, int B, int wide,
                                 int* distinct, int* worker_max, int* round_max, bool* pair_bad,
                                 int device, void* stream) {
  const Window w{static_cast<const uint8_t*>(win), cells, n, sc, sr, sw, rows, B, wide != 0};
  unsigned blocks = 0;
  if (cudaError_t err = prepare(w, device, &blocks)) return err;
  if (cells == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 4)
    launch_window<4>(w, blocks, s, distinct, worker_max, round_max, pair_bad);
  else if (rows <= 8)
    launch_window<8>(w, blocks, s, distinct, worker_max, round_max, pair_bad);
  else if (rows <= 16)
    launch_window<16>(w, blocks, s, distinct, worker_max, round_max, pair_bad);
  else
    launch_window<32>(w, blocks, s, distinct, worker_max, round_max, pair_bad);
  return cudaGetLastError();
}

// buf: bool (cells, rows, n) at element strides (sc, sr, sw), wide as above;
// act, cnt, md (cells, n) and pair_bad (cells,) contiguous.  rows == 0 writes
// zeros.
extern "C" int gate_buffer_stats(const void* buf, long long cells, int rows, long long n,
                                 long long sc, long long sr, long long sw, int B, int wide,
                                 bool* act, int* cnt, bool* md, bool* pair_bad, int device,
                                 void* stream) {
  const Window w{static_cast<const uint8_t*>(buf), cells, n, sc, sr, sw, rows, B, wide != 0};
  unsigned blocks = 0;
  if (cudaError_t err = prepare(w, device, &blocks)) return err;
  if (cells == 0) return cudaSuccess;
  const bool wide_out = n % kRun == 0 && aligned16(act) && aligned16(cnt) && aligned16(md);
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 4)
    launch_buffer<4>(w, blocks, s, wide_out, act, cnt, md, pair_bad);
  else if (rows <= 8)
    launch_buffer<8>(w, blocks, s, wide_out, act, cnt, md, pair_bad);
  else if (rows <= 16)
    launch_buffer<16>(w, blocks, s, wide_out, act, cnt, md, pair_bad);
  else
    launch_buffer<32>(w, blocks, s, wide_out, act, cnt, md, pair_bad);
  return cudaGetLastError();
}
