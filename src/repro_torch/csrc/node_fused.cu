// node_fused: one fused FiGaRo head/tail pass over a join-tree node, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/node_fused/kernel.py:130
// node_fused_kernel (body _node_fused_body at :94). For data [B, m, n] and
// per-row vectors of length m it computes, per column,
//
//   d       = data * data_scale
//   wa      = d * weights
//   s_incl  = segmented inclusive prefix sum of wa over rows (restart at first)
//   emitted = emit_scale * (coef_a * d + coef_b * (s_incl - wa))
//
// and writes emitted and s_incl. The B batch matrices share the row vectors,
// so they are folded into C = B * n independent columns.
//
// What bounds it: bytes. Each element is read once and two are written, at
// a few flops per element, far below the card's ~20 flops per byte balance
// point. The TPU kernel walks row blocks in order and hands the segment
// prefix from one block to the next in scratch memory; CUDA blocks run in no
// order, so this kernel uses a two-phase segmented scan instead:
//
//   1. nf_reduce: every block scans its tile (rows x column lanes) and writes
//      the tile's segmented aggregate per column plus whether a segment
//      starts inside the tile.
//   2. nf_carry:  one warp per column scans the tile aggregates with the
//      segmented combine (f_a,x_a)+(f_b,x_b) = (f_a|f_b, x_b + (f_b?0:x_a))
//      and writes each tile's carry-in.
//   3. nf_emit:   every block rescans its tile from its carry-in and writes
//      both outputs.
//
// So data is read twice (phases 1 and 3) and both outputs written once; the
// tile aggregates are m / tile_rows times smaller. Accumulation is in the
// I/O type (float for float, double for double), as in the TPU kernel. Dead
// capacity rows (weights = data_scale = 0, never segment starts) add exactly
// zero to the running sum and emit exactly zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // threads per block
constexpr int kRowsPerThread = 8;  // consecutive rows one thread scans serially

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

template <typename T>
__global__ void nf_reduce(const T* __restrict__ data, const T* __restrict__ dscale,
                          const T* __restrict__ w, const uint8_t* __restrict__ first,
                          int64_t m, int64_t n, int64_t C,
                          T* __restrict__ blk_x, uint8_t* __restrict__ blk_f) {
  __shared__ T sx[kThreads];
  __shared__ int sf[kThreads];
  const int tc = blockDim.x, ny = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t c = (int64_t)blockIdx.y * tc + tx;
  const int64_t r0 = ((int64_t)blockIdx.x * ny + ty) * kRowsPerThread;
  T x = T(0);
  int f = 0;
  const bool live = c < C;
  const T* col = data;
  if (live) col = data + (c / n) * m * n + (c % n);
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t r = r0 + k;
    if (r >= m) break;
    const bool start = first[r] != 0;
    T wa = T(0);
    if (live) wa = col[r * n] * dscale[r] * w[r];
    x = start ? wa : x + wa;
    f |= start;
  }
  block_scan(x, f, sx, sf);
  if (ty == ny - 1) {
    if (live) blk_x[(int64_t)blockIdx.x * C + c] = x;
    if (tx == 0 && blockIdx.y == 0) blk_f[blockIdx.x] = (uint8_t)f;
  }
}

// One warp per column: exclusive segmented scan of the tile aggregates.
template <typename T>
__global__ void nf_carry(const T* __restrict__ blk_x, const uint8_t* __restrict__ blk_f,
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

template <typename T>
__global__ void nf_emit(const T* __restrict__ data, const T* __restrict__ dscale,
                        const T* __restrict__ w, const uint8_t* __restrict__ first,
                        const T* __restrict__ coef_a, const T* __restrict__ coef_b,
                        const T* __restrict__ emit_scale, const T* __restrict__ carry,
                        int64_t m, int64_t n, int64_t C,
                        T* __restrict__ emitted, T* __restrict__ s_incl) {
  __shared__ T sx[kThreads];
  __shared__ int sf[kThreads];
  const int tc = blockDim.x, ny = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t c = (int64_t)blockIdx.y * tc + tx;
  const int64_t r0 = ((int64_t)blockIdx.x * ny + ty) * kRowsPerThread;
  const bool live = c < C;
  int64_t off0 = 0;
  if (live) off0 = (c / n) * m * n + (c % n);
  T x = T(0);
  int f = 0;
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t r = r0 + k;
    if (r >= m) break;
    const bool start = first[r] != 0;
    T wa = T(0);
    if (live) wa = data[off0 + r * n] * dscale[r] * w[r];
    x = start ? wa : x + wa;
    f |= start;
  }
  block_scan(x, f, sx, sf);
  if (!live) return;  // no barrier follows
  // Carry into this thread's rows: the block's carry-in, then the lanes above.
  T run = carry[(int64_t)blockIdx.x * C + c];
  if (ty > 0) {
    const int prev = (ty - 1) * tc + tx;
    run = sf[prev] ? sx[prev] : sx[prev] + run;
  }
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t r = r0 + k;
    if (r >= m) break;
    const int64_t at = off0 + r * n;
    const T d = data[at] * dscale[r];
    const T wa = d * w[r];
    run = first[r] ? wa : run + wa;
    s_incl[at] = run;
    emitted[at] = emit_scale[r] * (coef_a[r] * d + coef_b[r] * (run - wa));
  }
}

int next_pow2(int64_t x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <typename T>
int launch(const T* data, const T* dscale, const T* w, const uint8_t* first,
           const T* coef_a, const T* coef_b, const T* emit_scale,
           int64_t B, int64_t m, int64_t n, T* emitted, T* s_incl,
           T* blk_x, uint8_t* blk_f, T* carry, cudaStream_t stream) {
  const int64_t C = B * n;
  const int tc = next_pow2(C) < 32 ? next_pow2(C) : 32;
  const int ny = kThreads / tc;
  const int64_t tile_rows = (int64_t)ny * kRowsPerThread;
  const int64_t nblk = (m + tile_rows - 1) / tile_rows;
  const dim3 block(tc, ny);
  const dim3 grid((unsigned)nblk, (unsigned)((C + tc - 1) / tc));
  nf_reduce<T><<<grid, block, 0, stream>>>(data, dscale, w, first, m, n, C, blk_x, blk_f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = 8;
  nf_carry<T><<<(unsigned)((C + warps - 1) / warps), warps * 32, 0, stream>>>(
      blk_x, blk_f, nblk, C, carry);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nf_emit<T><<<grid, block, 0, stream>>>(data, dscale, w, first, coef_a, coef_b,
                                          emit_scale, carry, m, n, C, emitted, s_incl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of row tiles the scratch buffers need (blk_x, carry: tiles * B * n).
int64_t nf_num_tiles(int64_t B, int64_t m, int64_t n) {
  const int64_t C = B * n;
  const int tc = next_pow2(C) < 32 ? next_pow2(C) : 32;
  const int64_t tile_rows = (int64_t)(kThreads / tc) * kRowsPerThread;
  return (m + tile_rows - 1) / tile_rows;
}

int nf_launch_f32(const float* data, const float* dscale, const float* w,
                  const uint8_t* first, const float* coef_a, const float* coef_b,
                  const float* emit_scale, int64_t B, int64_t m, int64_t n,
                  float* emitted, float* s_incl, float* blk_x, uint8_t* blk_f,
                  float* carry, void* stream) {
  return launch<float>(data, dscale, w, first, coef_a, coef_b, emit_scale, B, m, n,
                       emitted, s_incl, blk_x, blk_f, carry, (cudaStream_t)stream);
}

int nf_launch_f64(const double* data, const double* dscale, const double* w,
                  const uint8_t* first, const double* coef_a, const double* coef_b,
                  const double* emit_scale, int64_t B, int64_t m, int64_t n,
                  double* emitted, double* s_incl, double* blk_x, uint8_t* blk_f,
                  double* carry, void* stream) {
  return launch<double>(data, dscale, w, first, coef_a, coef_b, emit_scale, B, m, n,
                        emitted, s_incl, blk_x, blk_f, carry, (cudaStream_t)stream);
}

}  // extern "C"
