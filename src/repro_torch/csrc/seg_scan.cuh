// seg_scan.cuh: the three-phase segmented row scan shared by node_fused.cu and
// head_tail.cu.
//
// For a batch of [B, m, n] matrices whose rows are cut into segments (a
// segment starts wherever first[r] is set), every one of the C = B * n
// columns gets a segmented inclusive prefix sum over its rows of some
// per-element value wa. CUDA blocks run in no order, so the scan is split
// into three phases:
//
//   1. seg_reduce: every block scans its tile (rows x column lanes) and writes
//      the tile's segmented aggregate per column plus whether a segment
//      starts inside the tile.
//   2. seg_carry:  one warp per column scans the tile aggregates with the
//      segmented combine (f_a,x_a)+(f_b,x_b) = (f_a|f_b, x_b + (f_b?0:x_a))
//      and writes each tile's carry-in.
//   3. an emit kernel of the including file rescans its tile from its
//      carry-in (seg_thread_carry) and writes its outputs.
//
// The value wa is computed by a functor the caller passes (node_fused forms
// it from data * data_scale * weights, head_tail reads it), so both kernels
// share one scan. Accumulation is in the I/O type T.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace segscan {

constexpr int kThreads = 256;      // threads per block
constexpr int kRowsPerThread = 8;  // consecutive rows one thread scans serially

inline int next_pow2(int64_t x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The launch shape of phases 1 and 3 for C columns of m rows.
struct Geometry {
  int tc;             // column lanes per block (a power of two, <= 32)
  int ny;             // row lanes per block
  int64_t tile_rows;  // rows one block covers
  int64_t nblk;       // row tiles
  dim3 block, grid;
};

inline Geometry geometry(int64_t B, int64_t m, int64_t n) {
  Geometry g;
  const int64_t C = B * n;
  g.tc = next_pow2(C) < 32 ? next_pow2(C) : 32;
  g.ny = kThreads / g.tc;
  g.tile_rows = (int64_t)g.ny * kRowsPerThread;
  g.nblk = (m + g.tile_rows - 1) / g.tile_rows;
  g.block = dim3(g.tc, g.ny);
  g.grid = dim3((unsigned)g.nblk, (unsigned)((C + g.tc - 1) / g.tc));
  return g;
}

// Offset of column c's row 0 in a [B, m, n] batch.
__device__ __forceinline__ int64_t col_offset(int64_t c, int64_t m, int64_t n) {
  return (c / n) * m * n + (c % n);
}

// Inclusive segmented scan of (x, f) across the blockDim.y row lanes of each
// column lane, in shared memory. On return (x, f) is the inclusive value of
// this thread's lane; sx/sf hold every lane's inclusive value.
template <typename T>
__device__ void block_scan(T& x, int& f, T* sx, int* sf) {
  const int tc = blockDim.x, ny = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int me = ty * tc + tx;
  sx[me] = x;
  sf[me] = f;
  __syncthreads();
  for (int off = 1; off < ny; off <<= 1) {
    T px = T(0);
    int pf = 0;
    const bool has = ty >= off;
    if (has) {
      px = sx[me - off * tc];
      pf = sf[me - off * tc];
    }
    __syncthreads();
    if (has) {
      x = f ? x : x + px;
      f = f | pf;
      sx[me] = x;
      sf[me] = f;
    }
    __syncthreads();
  }
}

// Serial segmented sum of this thread's kRowsPerThread rows from r0, then the
// block scan. Returns this lane's inclusive (x, f) in the references.
template <typename T, typename WaFn>
__device__ void scan_rows(const WaFn& wa_at, const uint8_t* __restrict__ first,
                          int64_t off0, int64_t r0, int64_t m, int64_t n, bool live,
                          T& x, int& f, T* sx, int* sf) {
  x = T(0);
  f = 0;
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t r = r0 + k;
    if (r >= m) break;
    const bool start = first[r] != 0;
    T wa = T(0);
    if (live) wa = wa_at(off0 + r * n, r);
    x = start ? wa : x + wa;
    f |= start;
  }
  block_scan(x, f, sx, sf);
}

// Phase 1: every tile's segmented aggregate per column, and whether a segment
// starts inside the tile.
template <typename T, typename WaFn>
__global__ void seg_reduce(WaFn wa_at, const uint8_t* __restrict__ first,
                           int64_t m, int64_t n, int64_t C,
                           T* __restrict__ blk_x, uint8_t* __restrict__ blk_f) {
  __shared__ T sx[kThreads];
  __shared__ int sf[kThreads];
  const int tc = blockDim.x, ny = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t c = (int64_t)blockIdx.y * tc + tx;
  const int64_t r0 = ((int64_t)blockIdx.x * ny + ty) * kRowsPerThread;
  const bool live = c < C;
  const int64_t off0 = live ? col_offset(c, m, n) : 0;
  T x;
  int f;
  scan_rows(wa_at, first, off0, r0, m, n, live, x, f, sx, sf);
  if (ty == ny - 1) {
    if (live) blk_x[(int64_t)blockIdx.x * C + c] = x;
    if (tx == 0 && blockIdx.y == 0) blk_f[blockIdx.x] = (uint8_t)f;
  }
}

// Phase 2: one warp per column, exclusive segmented scan of the tile
// aggregates.
template <typename T>
__global__ void seg_carry(const T* __restrict__ blk_x, const uint8_t* __restrict__ blk_f,
                          int64_t nblk, int64_t C, T* __restrict__ carry) {
  const int lane = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (c >= C) return;
  T run = T(0);  // inclusive value at the row before the current chunk
  for (int64_t base = 0; base < nblk; base += 32) {
    const int64_t i = base + lane;
    T x = T(0);
    int f = 0;
    if (i < nblk) {
      x = blk_x[i * C + c];
      f = blk_f[i];
    }
    for (int off = 1; off < 32; off <<= 1) {
      const T px = __shfl_up_sync(0xffffffffu, x, off);
      const int pf = __shfl_up_sync(0xffffffffu, f, off);
      if (lane >= off) {
        x = f ? x : x + px;
        f = f | pf;
      }
    }
    // Exclusive value for tile i: inclusive of lane-1 combined after `run`.
    T ex = __shfl_up_sync(0xffffffffu, x, 1);
    int exf = __shfl_up_sync(0xffffffffu, f, 1);
    if (lane == 0) {
      ex = T(0);
      exf = 0;
    }
    if (i < nblk) carry[i * C + c] = exf ? ex : ex + run;
    const T tot = __shfl_sync(0xffffffffu, x, 31);
    const int totf = __shfl_sync(0xffffffffu, f, 31);
    run = totf ? tot : tot + run;
  }
}

// Phase 3's start: the segmented inclusive sum just before this thread's first
// row (the block's carry-in, then the row lanes above it). Every thread of the
// block must call it (it holds barriers); the value is meaningful for live
// columns only.
template <typename T, typename WaFn>
__device__ T seg_thread_carry(const WaFn& wa_at, const uint8_t* __restrict__ first,
                              const T* __restrict__ carry, int64_t off0, int64_t r0,
                              int64_t m, int64_t n, int64_t C, int64_t c, bool live,
                              T* sx, int* sf) {
  T x;
  int f;
  scan_rows(wa_at, first, off0, r0, m, n, live, x, f, sx, sf);
  if (!live) return T(0);
  const int tc = blockDim.x, tx = threadIdx.x, ty = threadIdx.y;
  T run = carry[(int64_t)blockIdx.x * C + c];
  if (ty > 0) {
    const int prev = (ty - 1) * tc + tx;
    run = sf[prev] ? sx[prev] : sx[prev] + run;
  }
  return run;
}

// Phases 1 and 2; the caller launches its emit kernel on g.grid / g.block.
template <typename T, typename WaFn>
cudaError_t reduce_and_carry(const Geometry& g, WaFn wa_at, const uint8_t* first,
                             int64_t m, int64_t n, int64_t C, T* blk_x,
                             uint8_t* blk_f, T* carry, cudaStream_t stream) {
  seg_reduce<T, WaFn><<<g.grid, g.block, 0, stream>>>(wa_at, first, m, n, C, blk_x, blk_f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int warps = 8;
  seg_carry<T><<<(unsigned)((C + warps - 1) / warps), warps * 32, 0, stream>>>(
      blk_x, blk_f, g.nblk, C, carry);
  return cudaGetLastError();
}

}  // namespace segscan
