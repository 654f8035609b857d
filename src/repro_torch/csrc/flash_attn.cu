// flash_attn: fused attention forward with an online softmax, float32 and
// float64 (bfloat16 runs on the tensor cores, in flash_attn_sm90.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/kernel.py:84
// flash_attention_kernel (body _flash_kernel at :40). For q [B, Tq, Hq, hd],
// k and v [B, Tk, Hkv, hd] (GQA: query head h reads KV head h / (Hq / Hkv))
// and position vectors q_pos [Tq], k_pos [Tk] it computes, per query row,
//
//   s    = q . k^T * hd^-1/2                     over the visible keys
//   out  = sum_j exp(s_j - max s) v_j / sum_j exp(s_j - max s)
//
// where key j is visible when k_pos[j] >= 0, and (causal) k_pos[j] <= q_pos,
// and (window) k_pos[j] > q_pos - window. The softmax is the online form of
// the TPU kernel: a running max m, a running sum l and an accumulator, each
// rescaled by exp(m_old - m_new) when a tile raises the max, and the output
// is acc / max(l, 1e-30). Accumulation is in the I/O type.
//
// Masked keys contribute exactly 0 (p = 0, not exp(-1e30 - m)). On a row with
// at least one visible key that is the TPU kernel's result, since there
// exp(-1e30 - m) underflows to 0 once m is finite; a row with no visible key
// comes out as zeros (l = 0) instead of the TPU kernel's average of V over
// the padded block.
//
// What bounds it: operations (two [64 x hd] x [hd x 64] products per tile),
// far above the card's balance point at these sizes. This first design is
// simple: one block of 16 x 16 threads per (batch, query head, 64 query
// rows); the Q tile and each K and V tile in shared memory; scalar FMA.
// Thread (ty, tx) owns query rows ty + 16 i and, for the scores, key
// columns tx + 16 j (for the output, head dimensions tx + 16 j), so the row
// max and row sum are reductions over the 16 lanes of one half-warp. A KV tile in which no key can be visible to any
// query row of the block (wholly above the causal diagonal, outside the
// window, or padding) is skipped: its contribution is exactly zero. GQA is
// folded by indexing KV head h / G, with no copies of K and V. float64 takes
// 32 x 32 tiles to stay within 227 KiB of shared memory. Tensor cores would
// mean TF32 (too coarse for float32's 2e-5 check) or DMMA here.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTx = 16, kTy = 16;  // 256 threads per block

template <typename T, int HD, int BQ, int BK>
constexpr int64_t smem_bytes() {
  // Q [BQ][HD+1], K [BK][HD+1], V [BK][HD], P [BQ][BK+1] in T, k_pos [BK] int.
  return (int64_t)(BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1)) * sizeof(T) +
         BK * sizeof(int);
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kTx* kTy)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int32_t* __restrict__ q_pos, const int32_t* __restrict__ k_pos,
              T* __restrict__ out, int Tq, int Tk, int Hq, int Hkv, int causal,
              int has_window, int window, T scale) {
  constexpr int RQ = BQ / kTy;  // query rows per thread
  constexpr int RK = BK / kTx;  // key columns per thread (scores)
  constexpr int RD = HD / kTx;  // head dimensions per thread (output)
  constexpr int LQ = HD + 1, LP = BK + 1;
  const T kNeg = T(-1e30);

  extern __shared__ unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * LQ;
  T* Vs = Ks + BK * LQ;
  T* Ps = Vs + BK * HD;
  int* kp_s = reinterpret_cast<int*>(Ps + BQ * LP);
  __shared__ int q_ext[2];

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTx + tx;
  const int nq = (Tq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // the longest rows first
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int64_t q_step = (int64_t)Hq * HD, kv_step = (int64_t)Hkv * HD;
  const T* q_b = q + ((int64_t)b * Tq * Hq + h) * HD;
  const T* k_b = k + ((int64_t)b * Tk * Hkv + hk) * HD;
  const T* v_b = v + ((int64_t)b * Tk * Hkv + hk) * HD;
  T* o_b = out + ((int64_t)b * Tq * Hq + h) * HD;

  if (tid == 0) {
    q_ext[0] = INT_MAX;
    q_ext[1] = INT_MIN;
  }
  for (int e = tid; e < BQ * HD; e += kTx * kTy) {
    const int r = e / HD, d = e % HD;
    const int t = q0 + r;
    Qs[r * LQ + d] = t < Tq ? q_b[(int64_t)t * q_step + d] : T(0);
  }
  __syncthreads();
  if (tid < BQ && q0 + tid < Tq) {
    const int p = q_pos[q0 + tid];
    atomicMin(&q_ext[0], p);
    atomicMax(&q_ext[1], p);
  }
  int qp[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int t = q0 + ty + kTy * i;
    qp[i] = t < Tq ? q_pos[t] : 0;
  }
  __syncthreads();
  const int q_min = q_ext[0], q_max = q_ext[1];

  T m_i[RQ], l_i[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_i[i] = kNeg;
    l_i[i] = T(0);
#pragma unroll
    for (int d = 0; d < RD; ++d) acc[i][d] = T(0);
  }

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    int kp = -1;
    if (tid < BK && k0 + tid < Tk) kp = k_pos[k0 + tid];
    const bool maybe = kp >= 0 && (!causal || kp <= q_max) &&
                       (!has_window || kp > q_min - window);
    if (tid < BK) kp_s[tid] = kp;
    // Also the barrier after the previous tile's last reads of K, V and P.
    if (!__syncthreads_or(maybe)) continue;

    for (int e = tid; e < BK * HD; e += kTx * kTy) {
      const int r = e / HD, d = e % HD;
      const int t = k0 + r;
      const bool in = t < Tk;
      Ks[r * LQ + d] = in ? k_b[(int64_t)t * kv_step + d] : T(0);
      Vs[r * HD + d] = in ? v_b[(int64_t)t * kv_step + d] : T(0);
    }
    __syncthreads();

    T s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = T(0);
    for (int d = 0; d < HD; ++d) {
      T qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + kTy * i) * LQ + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = Ks[(tx + kTx * j) * LQ + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      bool ok[RK];
      T mx = m_i[i];
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kpc = kp_s[tx + kTx * j];
        ok[j] = kpc >= 0 && (!causal || kpc <= qp[i]) &&
                (!has_window || kpc > qp[i] - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNeg;
        mx = s[i][j] > mx ? s[i][j] : mx;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {  // the 16 lanes of this row
        const T o = __shfl_xor_sync(0xffffffffu, mx, off);
        mx = o > mx ? o : mx;
      }
      const T corr = exp(m_i[i] - mx);
      T psum = T(0);
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const T p = ok[j] ? exp(s[i][j] - mx) : T(0);
        Ps[(ty + kTy * i) * LP + tx + kTx * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_i[i] = l_i[i] * corr + psum;
      m_i[i] = mx;
#pragma unroll
      for (int d = 0; d < RD; ++d) acc[i][d] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      T pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + kTy * i) * LP + c];
#pragma unroll
      for (int d = 0; d < RD; ++d) {
        const T vv = Vs[c * HD + tx + kTx * d];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][d] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int t = q0 + ty + kTy * i;
    if (t >= Tq) continue;
    const T l = l_i[i] > T(1e-30) ? l_i[i] : T(1e-30);
#pragma unroll
    for (int d = 0; d < RD; ++d) o_b[(int64_t)t * q_step + tx + kTx * d] = acc[i][d] / l;
  }
}

template <typename T, int HD, int BQ, int BK>
int launch_hd(const void* q, const void* k, const void* v, const int32_t* q_pos,
              const int32_t* k_pos, void* out, int64_t B, int64_t Tq, int64_t Tk, int64_t Hq,
              int64_t Hkv, int causal, int has_window, int64_t window, cudaStream_t stream) {
  constexpr int64_t bytes = smem_bytes<T, HD, BQ, BK>();
  static_assert(bytes <= 232448, "tiles exceed one block's shared memory");
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, HD, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((Tq + BQ - 1) / BQ), (unsigned)(B * Hq));
  const T scale = T(1.0 / sqrt((double)HD));  // as the TPU kernel: a double, then T's
  flash_fwd<T, HD, BQ, BK><<<grid, dim3(kTx, kTy), (size_t)bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
      k_pos, static_cast<T*>(out), (int)Tq, (int)Tk, (int)Hq, (int)Hkv, causal, has_window,
      (int)window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int BQ, int BK>
int launch_io(int64_t hd, const void* q, const void* k, const void* v, const int32_t* q_pos,
              const int32_t* k_pos, void* out, int64_t B, int64_t Tq, int64_t Tk, int64_t Hq,
              int64_t Hkv, int causal, int has_window, int64_t window, cudaStream_t stream) {
#define FA_CASE(D)                                                                          \
  case D:                                                                                   \
    return launch_hd<T, D, BQ, BK>(q, k, v, q_pos, k_pos, out, B, Tq, Tk, Hq, Hkv, causal, \
                                   has_window, window, stream);
  switch (hd) {
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

extern "C" {

// dtype: 1 float32, 2 float64. q [B, Tq, Hq, hd], k and v
// [B, Tk, Hkv, hd], out like q, all contiguous; q_pos [Tq], k_pos [Tk] int32.
// window is read only when has_window is set; hd is 32, 64, 128 or 256.
// Returns a CUDA error code.
int fa_launch(int dtype, const void* q, const void* k, const void* v, const int32_t* q_pos,
              const int32_t* k_pos, void* out, int64_t B, int64_t Tq, int64_t Tk, int64_t Hq,
              int64_t Hkv, int64_t hd, int causal, int has_window, int64_t window,
              void* stream) {
  if (B == 0 || Tq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 1:
      return launch_io<float, 64, 64>(hd, q, k, v, q_pos, k_pos, out, B, Tq, Tk, Hq, Hkv, causal,
                                      has_window, window, s);
    case 2:
      return launch_io<double, 32, 32>(hd, q, k, v, q_pos, k_pos, out, B, Tq, Tk, Hq, Hkv,
                                       causal, has_window, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
