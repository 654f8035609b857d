// head_tail: the segmented generalized-tail transform, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/head_tail/kernel.py:68
// segmented_tail_kernel (body _segtail_kernel at :36). For data and wa of
// shape [B, m, n] and per-row vectors first, coef_a, coef_b of length m it
// computes, per column,
//
//   out = coef_a * data + coef_b * (segmented exclusive prefix sum of wa)
//
// where segments restart wherever first is set. With the coefficients of
// core/heads_tails.py:segmented_head_tail this is the generalized tail
// T(A, v) of every key segment at once. The B batch matrices share the row
// vectors and fold into C = B * n independent columns.
//
// What bounds it: bytes (data, wa and out, a few flops per element). It is a
// strict subset of node_fused (no mask, no emit scale, no s_incl output, wa
// given), so it runs the same three-phase segmented scan (seg_scan.cuh):
// tile aggregates, a warp-per-column scan of them, then ht_emit rescans each
// tile from its carry-in. wa is read twice (phases 1 and 3), data once, out
// written once. Accumulation is in the I/O type, as in the TPU kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_scan.cuh"

namespace {

using segscan::kRowsPerThread;
using segscan::kThreads;

template <typename T>
struct GivenWa {
  const T* wa;
  __device__ T operator()(int64_t at, int64_t) const { return wa[at]; }
};

template <typename T>
__global__ void ht_emit(GivenWa<T> wa_at, const T* __restrict__ data,
                        const uint8_t* __restrict__ first, const T* __restrict__ coef_a,
                        const T* __restrict__ coef_b, const T* __restrict__ carry,
                        int64_t m, int64_t n, int64_t C, T* __restrict__ out) {
  __shared__ T sx[kThreads];
  __shared__ int sf[kThreads];
  const int64_t c = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  const int64_t r0 = ((int64_t)blockIdx.x * blockDim.y + threadIdx.y) * kRowsPerThread;
  const bool live = c < C;
  const int64_t off0 = live ? segscan::col_offset(c, m, n) : 0;
  T run = segscan::seg_thread_carry(wa_at, first, carry, off0, r0, m, n, C, c, live, sx, sf);
  if (!live) return;  // no barrier follows
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t r = r0 + k;
    if (r >= m) break;
    const int64_t at = off0 + r * n;
    const T wa = wa_at.wa[at];
    run = first[r] ? wa : run + wa;
    out[at] = coef_a[r] * data[at] + coef_b[r] * (run - wa);
  }
}

template <typename T>
int launch(const T* data, const T* wa, const uint8_t* first, const T* coef_a,
           const T* coef_b, int64_t B, int64_t m, int64_t n, T* out, T* blk_x,
           uint8_t* blk_f, T* carry, cudaStream_t stream) {
  const int64_t C = B * n;
  const segscan::Geometry g = segscan::geometry(B, m, n);
  const GivenWa<T> wa_at{wa};
  cudaError_t err = segscan::reduce_and_carry(g, wa_at, first, m, n, C, blk_x, blk_f,
                                              carry, stream);
  if (err != cudaSuccess) return (int)err;
  ht_emit<T><<<g.grid, g.block, 0, stream>>>(wa_at, data, first, coef_a, coef_b, carry,
                                             m, n, C, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of row tiles the scratch buffers need (blk_x, carry: tiles * B * n).
int64_t ht_num_tiles(int64_t B, int64_t m, int64_t n) {
  return segscan::geometry(B, m, n).nblk;
}

int ht_launch_f32(const float* data, const float* wa, const uint8_t* first,
                  const float* coef_a, const float* coef_b, int64_t B, int64_t m,
                  int64_t n, float* out, float* blk_x, uint8_t* blk_f, float* carry,
                  void* stream) {
  return launch<float>(data, wa, first, coef_a, coef_b, B, m, n, out, blk_x, blk_f,
                       carry, (cudaStream_t)stream);
}

int ht_launch_f64(const double* data, const double* wa, const uint8_t* first,
                  const double* coef_a, const double* coef_b, int64_t B, int64_t m,
                  int64_t n, double* out, double* blk_x, uint8_t* blk_f, double* carry,
                  void* stream) {
  return launch<double>(data, wa, first, coef_a, coef_b, B, m, n, out, blk_x, blk_f,
                        carry, (cudaStream_t)stream);
}

}  // extern "C"
