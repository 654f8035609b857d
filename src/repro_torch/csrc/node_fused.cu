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
// order, so this kernel uses the three-phase segmented scan of seg_scan.cuh
// (tile aggregates, a warp-per-column scan of them, then a rescan from each
// tile's carry-in); nf_emit is the third phase and writes both outputs.
//
// So data is read twice (phases 1 and 3) and both outputs written once; the
// tile aggregates are m / tile_rows times smaller. Accumulation is in the
// I/O type (float for float, double for double), as in the TPU kernel. Dead
// capacity rows (weights = data_scale = 0, never segment starts) add exactly
// zero to the running sum and emit exactly zero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_scan.cuh"

namespace {

using segscan::kRowsPerThread;
using segscan::kThreads;

// wa = (data * data_scale) * weights at element `at` of row r.
template <typename T>
struct MaskedWa {
  const T* data;
  const T* dscale;
  const T* w;
  __device__ T operator()(int64_t at, int64_t r) const { return data[at] * dscale[r] * w[r]; }
};

template <typename T>
__global__ void nf_emit(MaskedWa<T> wa_at, const uint8_t* __restrict__ first,
                        const T* __restrict__ coef_a, const T* __restrict__ coef_b,
                        const T* __restrict__ emit_scale, const T* __restrict__ carry,
                        int64_t m, int64_t n, int64_t C,
                        T* __restrict__ emitted, T* __restrict__ s_incl) {
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
    const T d = wa_at.data[at] * wa_at.dscale[r];
    const T wa = d * wa_at.w[r];
    run = first[r] ? wa : run + wa;
    s_incl[at] = run;
    emitted[at] = emit_scale[r] * (coef_a[r] * d + coef_b[r] * (run - wa));
  }
}

template <typename T>
int launch(const T* data, const T* dscale, const T* w, const uint8_t* first,
           const T* coef_a, const T* coef_b, const T* emit_scale,
           int64_t B, int64_t m, int64_t n, T* emitted, T* s_incl,
           T* blk_x, uint8_t* blk_f, T* carry, cudaStream_t stream) {
  const int64_t C = B * n;
  const segscan::Geometry g = segscan::geometry(B, m, n);
  const MaskedWa<T> wa_at{data, dscale, w};
  cudaError_t err = segscan::reduce_and_carry(g, wa_at, first, m, n, C, blk_x, blk_f,
                                              carry, stream);
  if (err != cudaSuccess) return (int)err;
  nf_emit<T><<<g.grid, g.block, 0, stream>>>(wa_at, first, coef_a, coef_b, emit_scale,
                                             carry, m, n, C, emitted, s_incl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of row tiles the scratch buffers need (blk_x, carry: tiles * B * n).
int64_t nf_num_tiles(int64_t B, int64_t m, int64_t n) {
  return segscan::geometry(B, m, n).nblk;
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
