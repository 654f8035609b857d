// node_fused: one fused FiGaRo head/tail pass over a join-tree node, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/node_fused/kernel.py:130
// node_fused_kernel (body _node_fused_body at :94) and the O(m) work its
// wrapper (src/repro/kernels/node_fused/ops.py:26 fused_node_pass) leaves to
// XLA. For data [B, m, n] and per-row vectors of length m the node pass
// computes, per column,
//
//   d       = data * data_scale                  (data_scale optional)
//   wa      = d * w,   w2 = w * w
//   s_incl  = segmented inclusive prefix sum of wa (restart where pos == 0)
//   c_incl  = segmented inclusive prefix sum of w2
//   c_excl  = first ? 1 : c_incl - w2
//   coef_a  = sqrt(c_excl / c_incl),   coef_b = -w / sqrt(c_excl * c_incl)
//   slab    = (first ? 0 : emit_scale) * (coef_a * d + coef_b * (s_incl - wa))
//
// and, per live segment slot k ending at row L = last_of_seg[k] (clamped),
// norms[k] = sqrt(c_incl[L]) and heads[k] = s_incl[L] / (norms[k] or 1);
// dead slots get zeros. The slab goes to a strided destination: its band of
// R0, written as whole R0 rows (the slab at its columns, zeros in the rest),
// so every write is a full, coalesced span and R0 needs no zero fill. It runs as one memset of the scratch's status words and row marks and
// two launches: nf_prep (O(K): marks each live slot's last row with the slot,
// zeroes the dead slots) and the single-pass scan of seg_scan.cuh in its
// node-pass mode, which carries c_incl as one more lane, forms the
// coefficients per row in shared memory and writes heads and norms at the
// marked rows. s_incl is never stored.
//
// The TPU kernel's own contract stays callable (nf_launch_*: data, data_scale,
// weights, first, coef_a, coef_b, emit_scale -> emitted, s_incl) as the same
// scan's contract mode.
//
// What bounds it: bytes. Each element of data is read once and the slab
// written once, with a few flops per element; the per-row vectors (weights,
// data_scale, emit_scale, pos_in_seg, the slot mark) weigh as much as the data
// in the one-column passes. Accumulation is in the I/O type, as in the TPU
// kernel. Dead capacity rows (weights = data_scale = 0, never segment starts)
// add exactly zero to both sums and emit exactly zero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_scan.cuh"

namespace {

using segscan::Params;

// mark[L] = k + 1 for every live slot k with last row L (clamped); zero the
// heads and norms of dead slots. The marks start zeroed.
template <typename T>
__global__ void nf_prep(const void* last, int last64, const uint8_t* live, int64_t K,
                        int64_t m, int64_t B, int64_t n, int* mark, T* heads, T* norms) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < K; k += stride) {
    if (live[k]) {
      int64_t l = segscan::load_index(last, last64, k);
      l = l < 0 ? 0 : (l > m - 1 ? m - 1 : l);
      mark[l] = (int)(k + 1);
    } else {
      norms[k] = T(0);
      for (int64_t b = 0; b < B; ++b)
        for (int64_t c = 0; c < n; ++c) heads[(b * K + k) * n + c] = T(0);
    }
  }
}

template <typename T>
int pass(const T* data, const T* dscale, const T* w, const void* pos, int pos64,
         const T* es, const void* last, int last64, const uint8_t* live, int64_t B,
         int64_t m, int64_t n, int64_t K, T* out, int64_t out_bs, int64_t out_rs,
         int64_t out_w, int64_t out_col, T* heads, T* norms, void* scratch, int* error,
         cudaStream_t stream) {
  Params<T> p = {};
  p.x = data;
  p.dscale = dscale;
  p.w = w;
  p.es = es;
  p.pos = pos;
  p.pos64 = pos64;
  p.K = K;
  p.out = out;
  p.out_bs = out_bs;
  p.out_rs = out_rs;
  p.out_w = (int)out_w;
  p.out_col = (int)out_col;
  p.heads = heads;
  p.norms = norms;
  p.m = m;
  p.g = segscan::geometry(B, m, n, sizeof(T), segscan::kPass);
  p.error = error;
  cudaError_t err = segscan::carve(p, scratch, segscan::kPass, stream);
  if (err != cudaSuccess) return (int)err;
  if (K > 0) {
    const int64_t blocks = (K + 255) / 256 < 1024 ? (K + 255) / 256 : 1024;
    nf_prep<T><<<(unsigned)blocks, 256, 0, stream>>>(last, last64, live, K, m, B, n, p.mark,
                                                     heads, norms);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)segscan::launch<T, segscan::kPass>(p, stream);
}

template <typename T>
int contract(const T* data, const T* dscale, const T* w, const uint8_t* first,
             const T* ca, const T* cb, const T* es, int64_t B, int64_t m, int64_t n,
             T* emitted, T* s_incl, void* scratch, int* error, cudaStream_t stream) {
  Params<T> p = {};
  p.x = data;
  p.dscale = dscale;
  p.w = w;
  p.first = first;
  p.ca = ca;
  p.cb = cb;
  p.es = es;
  p.out = emitted;
  p.out_bs = m * n;
  p.out_rs = n;
  p.out_w = (int)n;
  p.out2 = s_incl;
  p.m = m;
  p.g = segscan::geometry(B, m, n, sizeof(T), segscan::kContract);
  p.error = error;
  cudaError_t err = segscan::carve(p, scratch, segscan::kContract, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)segscan::launch<T, segscan::kContract>(p, stream);
}

}  // namespace

extern "C" {

// The scan's shape for [B, m, n] in the node-pass (mode 0) or contract (mode
// 1) mode: {tpc, rpt, tile_rows, rw, pitch, lanes, tiles, scratch bytes,
// shared bytes}.
void nf_geometry(int64_t B, int64_t m, int64_t n, int item, int mode, int64_t* out) {
  const segscan::Geometry g = segscan::geometry(B, m, n, item, mode);
  const int64_t v[9] = {g.tpc, g.rpt, g.tile_rows, g.rw, g.pitch, g.lanes, g.tiles,
                        (int64_t)segscan::scratch_bytes(g, m, item, mode),
                        (int64_t)segscan::smem_bytes(g, item, mode)};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

int nf_pass_f32(const float* data, const float* dscale, const float* w, const void* pos,
                int pos64, const float* es, const void* last, int last64,
                const uint8_t* live, int64_t B, int64_t m, int64_t n, int64_t K, float* out,
                int64_t out_bs, int64_t out_rs, int64_t out_w, int64_t out_col, float* heads,
                float* norms, void* scratch, int* error, void* stream) {
  return pass<float>(data, dscale, w, pos, pos64, es, last, last64, live, B, m, n, K, out,
                     out_bs, out_rs, out_w, out_col, heads, norms, scratch, error,
                     (cudaStream_t)stream);
}

int nf_pass_f64(const double* data, const double* dscale, const double* w, const void* pos,
                int pos64, const double* es, const void* last, int last64,
                const uint8_t* live, int64_t B, int64_t m, int64_t n, int64_t K, double* out,
                int64_t out_bs, int64_t out_rs, int64_t out_w, int64_t out_col, double* heads,
                double* norms, void* scratch, int* error, void* stream) {
  return pass<double>(data, dscale, w, pos, pos64, es, last, last64, live, B, m, n, K, out,
                      out_bs, out_rs, out_w, out_col, heads, norms, scratch, error,
                      (cudaStream_t)stream);
}

int nf_launch_f32(const float* data, const float* dscale, const float* w,
                  const uint8_t* first, const float* coef_a, const float* coef_b,
                  const float* emit_scale, int64_t B, int64_t m, int64_t n, float* emitted,
                  float* s_incl, void* scratch, int* error, void* stream) {
  return contract<float>(data, dscale, w, first, coef_a, coef_b, emit_scale, B, m, n,
                         emitted, s_incl, scratch, error, (cudaStream_t)stream);
}

int nf_launch_f64(const double* data, const double* dscale, const double* w,
                  const uint8_t* first, const double* coef_a, const double* coef_b,
                  const double* emit_scale, int64_t B, int64_t m, int64_t n, double* emitted,
                  double* s_incl, void* scratch, int* error, void* stream) {
  return contract<double>(data, dscale, w, first, coef_a, coef_b, emit_scale, B, m, n,
                          emitted, s_incl, scratch, error, (cudaStream_t)stream);
}

#ifdef SEG_TRACE
// The node pass's per-tile phase times of the last launch
// (tools/seg_scan_trace.py): [kMaxTraced, 8] global-timer values.
int nf_trace_copy(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, segscan::g_trace, sizeof(segscan::g_trace));
}
#endif

}  // extern "C"
