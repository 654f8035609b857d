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
// vectors.
//
// It is the tail mode of the single-pass segmented scan of seg_scan.cuh (wa
// given, no mask, no s_incl stored): one launch that reads data and wa once
// and writes out once. The same scan's cumsum mode (ht_cumsum_*) is the
// segmented inclusive prefix sum itself, which segmented_head_tail runs on the
// squared weights for its c_incl (the JAX package runs XLA's associative scan
// there, src/repro/core/heads_tails.py:82 segmented_cumsum).
//
// What bounds it: bytes (data, wa and out, a few flops per element).
// Accumulation is in the I/O type, as in the TPU kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_scan.cuh"

namespace {

using segscan::Params;

template <typename T, int kMode>
int run(Params<T>& p, int64_t B, int64_t m, int64_t n, void* scratch, int* error,
        cudaStream_t stream) {
  p.m = m;
  p.out_bs = m * n;
  p.out_rs = n;
  p.out_w = (int)n;
  p.g = segscan::geometry(B, m, n, sizeof(T), kMode);
  p.error = error;
  cudaError_t err = segscan::carve(p, scratch, kMode, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)segscan::launch<T, kMode>(p, stream);
}

template <typename T>
int tail(const T* data, const T* wa, const uint8_t* first, const T* ca, const T* cb,
         int64_t B, int64_t m, int64_t n, T* out, void* scratch, int* error,
         cudaStream_t stream) {
  Params<T> p = {};
  p.x = wa;
  p.x2 = data;
  p.first = first;
  p.ca = ca;
  p.cb = cb;
  p.out = out;
  return run<T, segscan::kTail>(p, B, m, n, scratch, error, stream);
}

template <typename T>
int cumsum(const T* x, const uint8_t* first, int64_t B, int64_t m, int64_t n, T* out,
           void* scratch, int* error, cudaStream_t stream) {
  Params<T> p = {};
  p.x = x;
  p.first = first;
  p.out = out;
  return run<T, segscan::kCumsum>(p, B, m, n, scratch, error, stream);
}

}  // namespace

extern "C" {

// The scan's shape for [B, m, n] in the tail (mode 2) or cumsum (mode 3)
// mode; see nf_geometry.
void ht_geometry(int64_t B, int64_t m, int64_t n, int item, int mode, int64_t* out) {
  const segscan::Geometry g = segscan::geometry(B, m, n, item, mode);
  const int64_t v[9] = {g.tpc, g.rpt, g.tile_rows, g.rw, g.pitch, g.lanes, g.tiles,
                        (int64_t)segscan::scratch_bytes(g, m, item, mode),
                        (int64_t)segscan::smem_bytes(g, item, mode)};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

int ht_launch_f32(const float* data, const float* wa, const uint8_t* first,
                  const float* coef_a, const float* coef_b, int64_t B, int64_t m,
                  int64_t n, float* out, void* scratch, int* error, void* stream) {
  return tail<float>(data, wa, first, coef_a, coef_b, B, m, n, out, scratch, error,
                     (cudaStream_t)stream);
}

int ht_launch_f64(const double* data, const double* wa, const uint8_t* first,
                  const double* coef_a, const double* coef_b, int64_t B, int64_t m,
                  int64_t n, double* out, void* scratch, int* error, void* stream) {
  return tail<double>(data, wa, first, coef_a, coef_b, B, m, n, out, scratch, error,
                      (cudaStream_t)stream);
}

int ht_cumsum_f32(const float* x, const uint8_t* first, int64_t B, int64_t m, int64_t n,
                  float* out, void* scratch, int* error, void* stream) {
  return cumsum<float>(x, first, B, m, n, out, scratch, error, (cudaStream_t)stream);
}

int ht_cumsum_f64(const double* x, const uint8_t* first, int64_t B, int64_t m, int64_t n,
                  double* out, void* scratch, int* error, void* stream) {
  return cumsum<double>(x, first, B, m, n, out, scratch, error, (cudaStream_t)stream);
}

}  // extern "C"
