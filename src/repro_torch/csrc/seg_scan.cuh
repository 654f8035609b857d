// seg_scan.cuh: the single-pass segmented row scan shared by node_fused.cu
// and head_tail.cu.
//
// For a batch of [B, m, n] matrices whose rows are cut into segments (a
// segment starts wherever a row's start flag is set), every column gets a
// segmented inclusive prefix sum of a per-element value over its rows. One
// kernel does it in one pass over the data (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016, made
// segmented):
//
//   1. A block takes the next tile from an atomic ticket (so it waits only on
//      tiles that are already running) and stages the tile — tile_rows rows x
//      all n columns of one batch matrix, one contiguous span of memory — and
//      its per-row vectors into shared memory with coalesced cp.async copies,
//      all in flight at once. Matrices are staged at an odd row pitch, so
//      threads that scan neighbouring row chunks of one column hit different
//      banks.
//   2. Every data column gets tpc threads, each of which sums rpt consecutive
//      rows serially; a Hillis-Steele scan over the tpc chunk sums gives every
//      chunk its inclusive value and the tile its aggregate. The node pass adds
//      one more lane, the squared weights, scanned by all 256 threads over
//      their own row chunks (rw rows each), so c_incl costs no second pass.
//   3. The block publishes its aggregate (its inclusive prefix straight away
//      if the tile holds a segment start or is its batch's first tile), looks
//      back over its predecessors until one has published an inclusive
//      prefix, then sums forward from there. Summing forward left to right
//      from the prefix it found gives the same bits as a strict tile-by-tile
//      chain, so the result does not depend on which prefix the look-back
//      happened to find: the scan is deterministic.
//   4. The block publishes its inclusive prefix, rescans its rows from each
//      chunk's carry-in, applies the caller's epilogue in shared memory and
//      writes the tile out with coalesced stores (to a strided destination:
//      the node pass writes its slab straight into its band of R0).
//
// Publishing is release/acquire: values first (stored to L2 with st.cg), the
// block barrier, then one thread's st.release.gpu of the status word (the
// barrier orders the other threads' stores before it);
// readers take ld.acquire.gpu on the status word before ld.cg of the values.
// A float64 value has its own word: the status word holds only the state.
// The status words, the ticket and the node pass's row marks are zeroed by one
// cudaMemsetAsync before every launch. A look-back spin is bounded: when it
// runs out, the block writes an error code into a host-mapped word that the
// Python wrapper reads, and goes on with a zero carry, so the launch
// ends rather than hangs.
//
// Arithmetic is in the I/O type T with correctly rounded operations that nvcc
// never contracts into an FMA (add, sub, mul, quot, root below), so every
// value is rounded where the plain PyTorch version rounds it; the CPU tests
// emulate this order of arithmetic exactly (tests/_scan_order.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace segscan {

constexpr int kThreads = 256;            // threads per block
constexpr int kSmemBudget = 48 * 1024;   // shared bytes of a tile's rows
constexpr unsigned kSpinLimit = 1u << 24;  // polls of one status word

enum Mode { kPass = 0, kContract = 1, kTail = 2, kCumsum = 3 };
enum Status { kNone = 0, kAggregate = 1, kInclusive = 2 };
constexpr int kTimedOut = 1;  // error code of a look-back that ran out

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

// What each mode stages per row: [tile_rows, n] matrices, per-row arrays of T,
// of int32 and of int64 (every mode also keeps one start-flag byte a row).
__host__ __device__ constexpr int mats_of(int mode) {
  return mode == kContract || mode == kTail ? 2 : 1;
}
// (The node pass keeps coef_a, and coef_b for 4-byte T, in its int64 array.)
__host__ __device__ constexpr int row_t_of(int mode, int item) {
  return mode == kPass ? (item == 4 ? 4 : 5) : mode == kContract ? 5 : mode == kTail ? 2 : 0;
}
__host__ __device__ constexpr int row_i_of(int mode) { return mode == kPass ? 1 : 0; }
__host__ __device__ constexpr int row_l_of(int mode) { return mode == kPass ? 1 : 0; }
__host__ __device__ constexpr bool w2_of(int mode) { return mode == kPass; }

// The launch shape for n columns of item-byte values (mirrored in
// kernels/_seg_scan.py:geometry).
struct Geometry {
  int n;                   // data columns (lanes)
  int lanes;               // n, plus the w² lane in the node pass
  int tpc;                 // threads per data lane (1 when n > kThreads / 2)
  int rpt;                 // rows a thread scans serially (odd)
  int tile_rows;           // tpc * rpt
  int rw;                  // rows of the w² lane per thread
  int pitch;               // row pitch of a staged matrix (odd)
  int64_t tiles_per_batch;
  int64_t tiles;
};

inline Geometry geometry(int64_t B, int64_t m, int64_t n, int item, int mode) {
  Geometry g;
  g.n = (int)n;
  g.lanes = (int)n + (w2_of(mode) ? 1 : 0);
  g.tpc = n == 0 ? kThreads : (n <= kThreads ? kThreads / (int)n : 1);
  g.pitch = (int)(n | 1);
  const int64_t per_row = (int64_t)mats_of(mode) * g.pitch * item +
                          (int64_t)row_t_of(mode, item) * item + 4 * row_i_of(mode) +
                          8 * row_l_of(mode) + 1;
  int64_t rows = kSmemBudget / per_row;
  int64_t rpt = rows / g.tpc;
  if (rpt < 1) rpt = 1;
  if (rpt % 2 == 0) rpt -= 1;
  g.rpt = (int)rpt;
  g.tile_rows = g.tpc * g.rpt;
  g.rw = (g.tile_rows + kThreads - 1) / kThreads;
  g.tiles_per_batch = (m + g.tile_rows - 1) / g.tile_rows;
  g.tiles = B * g.tiles_per_batch;
  return g;
}

// Dynamic shared memory of one block.
inline size_t smem_bytes(const Geometry& g, int item, int mode) {
  const size_t rows = (size_t)g.tile_rows;
  size_t t = (size_t)mats_of(mode) * rows * g.pitch + (size_t)row_t_of(mode, item) * rows +
             2 * (size_t)g.lanes + 4 * kThreads;
  size_t i = 4 * kThreads + (size_t)row_i_of(mode) * rows + 1;
  return 8 * (size_t)row_l_of(mode) * rows + t * item + i * 4 + rows;
}

// Scratch of one launch: [tiles + 1] status words (the last is the ticket),
// in the node pass [m] slot marks (mark[L] = k + 1 where live slot k ends at
// row L, else 0), all zeroed by one memset; then the tiles' aggregates and
// inclusive prefixes, [tiles, lanes] each.
inline size_t zeroed_ints(const Geometry& g, int64_t m, int mode) {
  return (size_t)(g.tiles + 1) + (mode == kPass ? (size_t)m : 0);
}
inline size_t scratch_bytes(const Geometry& g, int64_t m, int item, int mode) {
  return (zeroed_ints(g, m, mode) * 4 + 15) / 16 * 16 + 2 * (size_t)g.tiles * g.lanes * item;
}

template <typename T>
struct Params {
  const T* x;              // [B, m, n] the matrix scanned (pass, contract: data)
  const T* x2;             // tail: data (x is wa)
  const T* dscale;         // [m] or null (pass, contract)
  const T* w;              // [m] weights (pass, contract)
  const T* es;             // [m] emit scale (pass, contract)
  const T* ca;             // [m] given coefficients (contract, tail)
  const T* cb;
  const uint8_t* first;    // [m] start flags (contract, tail, cumsum)
  const void* pos;         // [m] pos_in_seg (pass), int32 or int64
  int pos64;
  int* mark;               // [m] slot + 1 of the segment ending at the row, or 0 (pass)
  int64_t K;
  T* out;                  // [B, m, out_w] at strides out_bs, out_rs (unit columns)
  int64_t out_bs, out_rs;
  int out_w, out_col;      // pass: the slab at columns [out_col, out_col + n) of
                           // rows out_w wide, zeros in the rest; else out_w = n
  T* out2;                 // contract: s_incl, contiguous
  T* heads;                // pass: [B, K, n]
  T* norms;                // pass: [K]
  int64_t m;
  Geometry g;
  int* status;             // [tiles + 1]
  T* agg;                  // [tiles, lanes]
  T* inc;                  // [tiles, lanes]
  int* error;              // host-mapped error word, or null
};

// Built with -DSEG_TRACE (tools/seg_scan_trace.py), thread 0 of every block
// records the global timer at its start and after each phase of its tile
// (the first kMaxTraced tiles of a launch, the last launch's values kept).
#ifdef SEG_TRACE
constexpr int kMaxTraced = 1 << 16;
__device__ unsigned long long g_trace[kMaxTraced * 8];
__device__ __forceinline__ unsigned long long now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define SEG_TRACE_MARK(i)                                                   \
  if (j == 0 && tile < kMaxTraced) g_trace[tile * 8 + (i)] = now()
#else
#define SEG_TRACE_MARK(i)
#endif

__device__ __forceinline__ int64_t load_index(const void* p, int wide, int64_t i) {
  return wide ? __ldg((const long long*)p + i) : (int64_t)__ldg((const int*)p + i);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Shared-memory arrays of one block.
template <typename T>
struct Smem {
  int64_t* pos;  // pass: [tile_rows] pos_in_seg (an int32 input in the low word),
                 // then coef_a (and coef_b for 4-byte T) in the same bytes
  T* mat0;    // [tile_rows, pitch]: the scanned matrix, then the first output
  T* mat1;    // contract: s_incl out; tail: data
  T* w;       // pass, contract: weights
  T* em;      // pass, contract: emit scale (pass: zeroed at starts in phase 4a)
  T* ca;      // pass: coef_a (from phase 4a); contract, tail: given
  T* cb;
  T* ds;      // pass, contract: data_scale
  T* hn;      // pass: the heads' divisor at rows where a segment ends
  T* tagg;    // [lanes] the tile's aggregate, then its inclusive prefix
  T* tcarry;  // [lanes] the tile's carry-in (exclusive prefix)
  T* hx;      // [2, kThreads] chunk sums of the data lanes, then inclusive
  T* wx;      // [2, kThreads] the same for the w² lane
  int* hf;    // [2, kThreads] start flags of those chunks
  int* wf;
  int* mark;  // pass: [tile_rows] slot + 1 of the segment ending at the row, or 0
  int* ticket;  // [1] the tile this block drew
  uint8_t* flag;  // [tile_rows] start flags

  __device__ Smem(unsigned char* raw, const Geometry& g, int mode) {
    const int rows = g.tile_rows;
    pos = reinterpret_cast<int64_t*>(raw);
    T* t = reinterpret_cast<T*>(pos + (mode == kPass ? rows : 0));
    mat0 = t;
    t += (size_t)rows * g.pitch;
    mat1 = nullptr;
    if (mats_of(mode) == 2) {
      mat1 = t;
      t += (size_t)rows * g.pitch;
    }
    w = em = ca = cb = ds = hn = nullptr;
    if (mode == kPass || mode == kContract) {
      w = t; t += rows;
      em = t; t += rows;
    }
    if (mode == kPass) {  // in the pos region, dead once the start flags are read
      ca = reinterpret_cast<T*>(pos);
      if (sizeof(T) == 4) {
        cb = ca + rows;
      } else {
        cb = t; t += rows;
      }
    } else if (mode != kCumsum) {
      ca = t; t += rows;
      cb = t; t += rows;
    }
    if (mode == kPass || mode == kContract) {
      ds = t; t += rows;
    }
    if (mode == kPass) {
      hn = t; t += rows;
    }
    tagg = t; t += g.lanes;
    tcarry = t; t += g.lanes;
    hx = t; t += 2 * kThreads;
    wx = t; t += 2 * kThreads;
    int* i = reinterpret_cast<int*>(t);
    hf = i; i += 2 * kThreads;
    wf = i; i += 2 * kThreads;
    mark = nullptr;
    if (mode == kPass) {
      mark = i;
      i += rows;
    }
    ticket = i; i += 1;
    flag = reinterpret_cast<uint8_t*>(i);
  }
};

// An asynchronous copy of kBytes (4 or 8) from global to shared memory
// (cp.async): a thread issues all of its copies of a tile before it waits, so
// they are in flight together and take no registers.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned at = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(at), "l"(gmem), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

// Copy a contiguous [rows, n] span (cnt elements) into a [rows, pitch] shared
// matrix, element by element, coalesced.
template <typename T>
__device__ void stage_matrix(const T* __restrict__ src, int cnt, int n, int pitch, T* dst) {
  if (cnt == 0) return;
  const int step_r = kThreads / n, step_c = kThreads % n;
  int r = threadIdx.x / n, c = threadIdx.x % n;
  for (int at = threadIdx.x; at < cnt; at += kThreads) {
    cp_async<sizeof(T)>(dst + r * pitch + c, src + at);
    r += step_r;
    c += step_c;
    if (c >= n) { c -= n; ++r; }
  }
}

// Write a [rows, pitch] shared matrix to rows r0.. of a destination with row
// stride rs (elements; columns contiguous), coalesced along each row.
template <typename T>
__device__ void store_matrix(const T* src, int rows, int n, int pitch, T* __restrict__ dst,
                             int64_t rs) {
  const int cnt = rows * n;
  if (cnt == 0) return;
  const int step_r = kThreads / n, step_c = kThreads % n;
  int r = threadIdx.x / n, c = threadIdx.x % n;
  for (int at = threadIdx.x; at < cnt; at += kThreads) {
    __stcs(dst + r * rs + c, src[r * pitch + c]);
    r += step_r;
    c += step_c;
    if (c >= n) { c -= n; ++r; }
  }
}

// Write a [rows, pitch] shared matrix into columns [col, col + n) of rows
// w wide (stride rs) and zeros into their other columns, coalesced: rows
// of a full-width destination are one contiguous span.
template <typename T>
__device__ void store_rows(const T* src, int rows, int n, int pitch, T* __restrict__ dst,
                           int64_t rs, int w, int col) {
  const int cnt = rows * w;
  const int step_r = kThreads / w, step_c = kThreads % w;
  int r = threadIdx.x / w, c = threadIdx.x % w;
  for (int at = threadIdx.x; at < cnt; at += kThreads) {
    const int k = c - col;
    __stcs(dst + r * rs + c, k >= 0 && k < n ? src[r * pitch + k] : T(0));
    r += step_r;
    c += step_c;
    if (c >= w) { c -= w; ++r; }
  }
}

// d = data * data_scale at row r, column c (pass, contract; the data as it is
// without a data_scale).
template <typename T>
__device__ __forceinline__ T masked(const Smem<T>& s, const Geometry& g, bool scaled, int r,
                                    int c) {
  const T x = s.mat0[r * g.pitch + c];
  return scaled ? mul(x, s.ds[r]) : x;
}

// The value a data lane scans at row r, column c.
template <typename T, int kMode>
__device__ __forceinline__ T lane_value(const Smem<T>& s, const Geometry& g, bool scaled, int r,
                                        int c) {
  if constexpr (kMode == kPass || kMode == kContract)
    return mul(masked(s, g, scaled, r, c), s.w[r]);  // wa = d * w
  else
    return s.mat0[r * g.pitch + c];  // tail: wa given; cumsum: x
}

// One pass of the segmented scan over the tile the block draws (see the top of
// this file); the mode picks what is staged and the epilogue.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads) seg_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Geometry& g = p.g;
  const Smem<T> s(smem_raw, g, kMode);
  const int j = threadIdx.x;
  constexpr bool kW2 = w2_of(kMode);

  // -- 1. the tile, and staging ------------------------------------------------
#ifdef SEG_TRACE
  const unsigned long long t_start = now();
#endif
  if (j == 0) *s.ticket = atomicAdd(p.status + g.tiles, 1);
  __syncthreads();
  const int64_t tile = *s.ticket;
#ifdef SEG_TRACE
  if (j == 0 && tile < kMaxTraced) g_trace[tile * 8 + 7] = t_start;
#endif
  SEG_TRACE_MARK(0);  // ticket
  const int64_t b = tile / g.tiles_per_batch, tb = tile - b * g.tiles_per_batch;
  const int64_t r0 = tb * g.tile_rows;
  const int rows = (int)(p.m - r0 < g.tile_rows ? p.m - r0 : g.tile_rows);
  constexpr int kT = sizeof(T);
  for (int r = j; r < rows; r += kThreads) {
    const int64_t row = r0 + r;
    if constexpr (kMode == kPass) {
      if (p.pos64) cp_async<8>(s.pos + r, (const int64_t*)p.pos + row);
      else cp_async<4>(s.pos + r, (const int*)p.pos + row);
      cp_async<kT>(s.w + r, p.w + row);
      cp_async<kT>(s.em + r, p.es + row);
      if (p.dscale) cp_async<kT>(s.ds + r, p.dscale + row);
      cp_async<4>(s.mark + r, p.mark + row);
    }
    if constexpr (kMode == kContract) {
      cp_async<kT>(s.w + r, p.w + row);
      cp_async<kT>(s.em + r, p.es + row);
      cp_async<kT>(s.ds + r, p.dscale + row);
    }
    if constexpr (kMode == kContract || kMode == kTail) {
      cp_async<kT>(s.ca + r, p.ca + row);
      cp_async<kT>(s.cb + r, p.cb + row);
    }
  }
  const int64_t span = (b * p.m + r0) * g.n;
  stage_matrix(p.x + span, rows * g.n, g.n, g.pitch, s.mat0);
  if constexpr (kMode == kTail) stage_matrix(p.x2 + span, rows * g.n, g.n, g.pitch, s.mat1);
  int any_start = 0;
  if constexpr (kMode != kPass) {
    // The start flags are bytes, below cp.async's smallest copy: eight loads a
    // thread in flight at a time.
    for (int base = j; base < rows; base += 8 * kThreads) {
      uint8_t f[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = base + u * kThreads;
        f[u] = r < rows ? __ldg(p.first + r0 + r) : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = base + u * kThreads;
        if (r < rows) s.flag[r] = f[u] != 0;
        any_start |= f[u] != 0;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if constexpr (kMode == kPass) {
    for (int r = j; r < rows; r += kThreads) {
      const int64_t pos = p.pos64 ? s.pos[r] : *reinterpret_cast<const int*>(s.pos + r);
      s.flag[r] = pos == 0;
      any_start |= pos == 0;
    }
  }
  const bool tile_start = __syncthreads_or(any_start) != 0;
  SEG_TRACE_MARK(1);  // staged

  // -- 2. chunk sums and the tile's aggregate ----------------------------------
  const bool scaled = p.dscale != nullptr;
  // Thread j scans chunk q = j / n of column lane = j % n: a warp's threads
  // touch neighbouring columns of a row before neighbouring chunks.
  // (With no columns no thread has a chunk: q = tpc.)
  const int q = g.n > 0 ? j / g.n : g.tpc, lane = g.n > 0 ? j % g.n : 0;
  const bool chunked = g.tpc > 1;
  T x = T(0);
  int f = 0;
  if (chunked) {
    if (q < g.tpc) {
      for (int k = 0, r = q * g.rpt; k < g.rpt && r < rows; ++k, ++r) {
        const T v = lane_value<T, kMode>(s, g, scaled, r, lane);
        const bool st = s.flag[r];
        x = st ? v : add(x, v);
        f |= st;
      }
    }
  } else {
    for (int c = j; c < g.n; c += kThreads) {
      T xc = T(0);
      for (int r = 0; r < rows; ++r) {
        const T v = lane_value<T, kMode>(s, g, scaled, r, c);
        xc = s.flag[r] ? v : add(xc, v);
      }
      s.tagg[c] = xc;
    }
  }
  T y = T(0);  // the w² lane
  int fy = 0;
  if constexpr (kW2) {
    for (int k = 0, r = j * g.rw; k < g.rw && r < rows; ++k, ++r) {
      const T v = mul(s.w[r], s.w[r]);
      const bool st = s.flag[r];
      y = st ? v : add(y, v);
      fy |= st;
    }
  }
  // Hillis-Steele over the chunks: x_q = f_q ? x_q : x_{q-off} + x_q, from one
  // of two buffers into the other (one barrier a round).
  const int scan_span = kW2 ? kThreads : (chunked ? g.tpc : 1);
  int cur = 0;
  s.hx[j] = x;
  s.hf[j] = f;
  s.wx[j] = y;
  s.wf[j] = fy;
  __syncthreads();
  for (int off = 1; off < scan_span; off <<= 1) {
    const int from = cur * kThreads, to = (cur ^ 1) * kThreads;
    if (chunked && q < g.tpc && q >= off) {
      const int at = from + j - off * g.n;
      x = f ? x : add(s.hx[at], x);
      f |= s.hf[at];
    }
    if (kW2 && j >= off) {
      const int at = from + j - off;
      y = fy ? y : add(s.wx[at], y);
      fy |= s.wf[at];
    }
    s.hx[to + j] = x;
    s.hf[to + j] = f;
    s.wx[to + j] = y;
    s.wf[to + j] = fy;
    __syncthreads();
    cur ^= 1;
  }
  const T* hx = s.hx + cur * kThreads;  // inclusive chunk values
  const int* hf = s.hf + cur * kThreads;
  const T* wx = s.wx + cur * kThreads;
  const int* wf = s.wf + cur * kThreads;
  if (chunked && q == g.tpc - 1) s.tagg[lane] = x;
  if (kW2 && j == kThreads - 1) s.tagg[g.n] = y;
  __syncthreads();
  SEG_TRACE_MARK(2);  // chunk sums and their scan

  // -- 3. publish, look back, publish the inclusive prefix ----------------------
  const bool early = tile_start || tb == 0;  // the inclusive prefix is the aggregate
  {
    T* dst = (early ? p.inc : p.agg) + tile * g.lanes;
    for (int c = j; c < g.lanes; c += kThreads) __stcg(dst + c, s.tagg[c]);
    __syncthreads();
    if (j == 0) st_release(p.status + tile, early ? kInclusive : kAggregate);
  }
  SEG_TRACE_MARK(3);  // aggregate published
  if (tb == 0) {
    for (int c = j; c < g.lanes; c += kThreads) s.tcarry[c] = T(0);
  } else if (j < 32) {
    // Warp 0 looks back over 32 predecessors at a time, each lane acquiring
    // one status word, to the nearest tile with an inclusive prefix. Tiles
    // with only an aggregate hold no segment start, so the look-back ends at
    // the latest at the batch's first tile, which publishes at once. Before
    // any inclusive prefix every tile must have published its aggregate, or
    // the warp polls again.
    const int64_t first_tile = tile - tb;
    int64_t top = tile - 1;  // nearest predecessor not yet passed over
    int64_t base = -1;
    unsigned spins = 0;
    for (;;) {
      const int64_t at = top - j;
      const int st = at >= first_tile ? ld_acquire(p.status + at) : kInclusive;
      const unsigned incl = __ballot_sync(0xffffffffu, st == kInclusive);
      const unsigned none = __ballot_sync(0xffffffffu, st == kNone);
      const unsigned before = incl ? (incl & -incl) - 1 : 0xffffffffu;  // lanes nearer
      if ((none & before) == 0) {
        if (incl) {
          base = top - (__ffs(incl) - 1);
          break;
        }
        top -= 32;
        spins = 0;
        continue;
      }
      if (++spins > kSpinLimit) {
        if (j == 0 && p.error) atomicExch_system(p.error, kTimedOut);
        break;  // no base: a zero carry, so the launch ends
      }
      __nanosleep(64);
    }
    __syncwarp();  // orders each lane's acquire before every lane's reads
    for (int c = j; c < g.lanes; c += 32) {
      T carry = T(0);
      if (base >= 0) {
        carry = __ldcg(p.inc + base * g.lanes + c);
        for (int64_t t = base + 1; t < tile; ++t) carry = add(carry, __ldcg(p.agg + t * g.lanes + c));
      }
      s.tcarry[c] = carry;
      if (!early) __stcg(p.inc + tile * g.lanes + c, add(carry, s.tagg[c]));
    }
    if (!early) {
      __syncwarp();
      if (j == 0) st_release(p.status + tile, kInclusive);
    }
  }
  __syncthreads();
  SEG_TRACE_MARK(4);  // looked back

  // -- 4. rescan from each chunk's carry-in; the epilogue ------------------------
  if constexpr (kW2) {
    // Phase 4a: the w² lane gives every row its tail coefficients (the guarded
    // formulas of kernels/node_fused/ref.py), zeroes the emit scale at segment
    // starts, and writes the norm of each segment that ends at one of its rows.
    T run = j == 0 ? s.tcarry[g.n]
                   : (wf[j - 1] ? wx[j - 1] : add(s.tcarry[g.n], wx[j - 1]));
    for (int k = 0, r = j * g.rw; k < g.rw && r < rows; ++k, ++r) {
      const T w = s.w[r];
      const T v = mul(w, w);
      const bool st = s.flag[r];
      run = st ? v : add(run, v);
      const T cex = st ? T(1) : sub(run, v);  // c_excl_safe
      s.ca[r] = root(quot(cex, run));
      s.cb[r] = -quot(w, root(mul(cex, run)));
      if (st) s.em[r] = T(0);
      if (s.mark[r] > 0) {
        const T nrm = root(run);
        p.norms[s.mark[r] - 1] = nrm;
        s.hn[r] = nrm > T(0) ? nrm : T(1);
      }
    }
    __syncthreads();
  }
  auto emit = [&](int c, int r_begin, int r_end, T run) {
    for (int r = r_begin; r < r_end; ++r) {
      const T v = lane_value<T, kMode>(s, g, scaled, r, c);
      run = s.flag[r] ? v : add(run, v);
      T* at = s.mat0 + r * g.pitch + c;
      if constexpr (kMode == kPass || kMode == kContract) {
        // emit * (coef_a * d + coef_b * (s_incl - wa))
        const T d = masked(s, g, scaled, r, c);
        *at = mul(s.em[r], add(mul(s.ca[r], d), mul(s.cb[r], sub(run, v))));
      } else if constexpr (kMode == kTail) {
        // coef_a * data + coef_b * (s_incl - wa)
        *at = add(mul(s.ca[r], s.mat1[r * g.pitch + c]), mul(s.cb[r], sub(run, v)));
      } else {
        *at = run;
      }
      if constexpr (kMode == kContract) s.mat1[r * g.pitch + c] = run;
      if constexpr (kMode == kPass) {
        if (s.mark[r] > 0) p.heads[(b * p.K + s.mark[r] - 1) * g.n + c] = quot(run, s.hn[r]);
      }
    }
  };
  if (chunked) {
    if (q < g.tpc) {
      const int prev = j - g.n;  // chunk q - 1 of the column
      const T run = q == 0 ? s.tcarry[lane]
                           : (hf[prev] ? hx[prev] : add(s.tcarry[lane], hx[prev]));
      const int r_begin = q * g.rpt;
      emit(lane, r_begin, min(r_begin + g.rpt, rows), run);
    }
  } else {
    for (int c = j; c < g.n; c += kThreads) emit(c, 0, rows, s.tcarry[c]);
  }
  __syncthreads();
  SEG_TRACE_MARK(5);  // rescanned (the epilogue in shared memory)

  // -- 5. the tile out -------------------------------------------------------------
  T* out = p.out + b * p.out_bs + r0 * p.out_rs;
  if (p.out_w > g.n) store_rows(s.mat0, rows, g.n, g.pitch, out, p.out_rs, p.out_w, p.out_col);
  else store_matrix(s.mat0, rows, g.n, g.pitch, out, p.out_rs);
  if constexpr (kMode == kContract)
    store_matrix(s.mat1, rows, g.n, g.pitch, p.out2 + span, (int64_t)g.n);
  SEG_TRACE_MARK(6);  // stored
}

// Launch seg_kernel<T, kMode> over p's tiles (the status words must be zero).
template <typename T, int kMode>
cudaError_t launch(const Params<T>& p, cudaStream_t stream) {
  if (p.g.tiles == 0) return cudaSuccess;
  const size_t smem = smem_bytes(p.g, sizeof(T), kMode);
  cudaError_t err = cudaFuncSetAttribute(seg_kernel<T, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  seg_kernel<T, kMode><<<(unsigned)p.g.tiles, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Point p's scratch pointers into one buffer of scratch_bytes(p.g, p.m, sizeof(T), mode),
// and zero its status words and marks (one cudaMemsetAsync).
template <typename T>
cudaError_t carve(Params<T>& p, void* scratch, int mode, cudaStream_t stream) {
  unsigned char* raw = static_cast<unsigned char*>(scratch);
  const size_t ints = zeroed_ints(p.g, p.m, mode);
  p.status = reinterpret_cast<int*>(raw);
  if (mode == kPass) p.mark = p.status + p.g.tiles + 1;
  raw += (ints * 4 + 15) / 16 * 16;
  p.agg = reinterpret_cast<T*>(raw);
  p.inc = p.agg + (size_t)p.g.tiles * p.g.lanes;
  return cudaMemsetAsync(p.status, 0, ints * 4, stream);
}

}  // namespace segscan
