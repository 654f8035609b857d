// panel_qr: Householder factorization of a batch of [m, nb] panels, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/panel_qr/kernel.py:71
// panel_qr_kernel (body _panel_kernel at :25). For every panel of a
// [B, m, nb] batch it runs min(m, nb) Householder steps, each the same as the
// TPU kernel's: the norm of column k below the diagonal, the sign choice
// sgn = xk >= 0 ? 1 : -1, a reflector with unit diagonal (guarded by
// |vk| > 0), beta = 2 / v'v (guarded by v'v > 0), and the rank-1 update
// A -= beta v (v'A). It writes V [B, m, nb], beta [B, nb] and the panel's R
// [B, m, nb] with everything below the diagonal zeroed.
//
// What bounds it: neither bytes nor flops but the chain of dependent steps
// inside one panel (two block reductions and a rank-1 update per column).
// The design keeps the whole panel in shared memory, one block per panel, so
// device memory is touched once on the way in and once on the way out, and
// the card's 132 SMs work on many panels at once: TSQR hands its leaves and
// each combine level over as one batch. The panel is stored column-major in
// shared memory with a leading dimension of m + 1, so the column reductions
// and the rank-1 update read consecutive addresses. Accumulation is in the
// I/O type (float for float, double for double), as in the TPU kernel.
// A panel whose shared-memory footprint exceeds what a block may use
// (227 KiB) is refused by the caller before launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxSmem = 232448;  // bytes one block may opt into on sm_90

template <typename T>
__device__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block; every thread gets the total. red holds >= 33 entries.
template <typename T>
__device__ T block_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T t = lane < nw ? red[lane] : T(0);
    t = warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  const T total = red[32];
  __syncthreads();  // red is reused by the next reduction
  return total;
}

int64_t smem_bytes(int64_t m, int64_t nb, int64_t elem) {
  // panel (nb columns of m + 1) + v (m) + reduction scratch (33) + w (nb)
  return (nb * (m + 1) + m + 33 + nb) * elem;
}

template <typename T>
__global__ void panel_qr_kernel(const T* __restrict__ a, T* __restrict__ v_out,
                                T* __restrict__ beta_out, T* __restrict__ r_out,
                                int m, int nb) {
  extern __shared__ unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // column j at As + j * ld
  const int ld = m + 1;
  T* vs = As + (int64_t)nb * ld;  // [m] current reflector
  T* red = vs + m;                // [33] reduction scratch
  T* ws = red + 33;               // [nb] w = v'A

  const int64_t panel = (int64_t)m * nb;
  const T* a_b = a + blockIdx.x * panel;
  T* v_b = v_out + blockIdx.x * panel;
  T* r_b = r_out + blockIdx.x * panel;
  T* beta_b = beta_out + (int64_t)blockIdx.x * nb;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;

  for (int64_t e = tid; e < panel; e += nt) {
    const int i = (int)(e / nb), j = (int)(e % nb);
    As[j * ld + i] = a_b[e];
  }
  __syncthreads();

  const int steps = m < nb ? m : nb;
  for (int k = 0; k < steps; ++k) {
    const T* col = As + k * ld;
    T part = T(0);
    for (int i = k + tid; i < m; i += nt) part += col[i] * col[i];
    const T sigma = sqrt(block_sum(part, red));
    const T xk = col[k];
    const T sgn = xk >= T(0) ? T(1) : T(-1);
    const T alpha = -sgn * sigma;
    const T vk = xk - alpha;
    const bool safe = fabs(vk) > T(0);
    for (int i = tid; i < m; i += nt) {
      T vi = i < k ? T(0) : (i == k ? vk : col[i]);
      if (safe) vi = vi / vk;  // unit diagonal
      vs[i] = vi;
    }
    __syncthreads();
    part = T(0);
    for (int i = k + tid; i < m; i += nt) part += vs[i] * vs[i];
    const T vv = block_sum(part, red);
    const T beta = vv > T(0) ? T(2) / vv : T(0);
    for (int j = k + warp; j < nb; j += nw) {
      const T* cj = As + j * ld;
      T s = T(0);
      for (int i = k + lane; i < m; i += 32) s += vs[i] * cj[i];
      s = warp_sum(s);
      if (lane == 0) ws[j] = s;
    }
    __syncthreads();
    const int rows = m - k, cols = nb - k;
    for (int e = tid; e < rows * cols; e += nt) {
      const int i = k + e % rows, j = k + e / rows;
      As[j * ld + i] -= beta * vs[i] * ws[j];
    }
    for (int i = tid; i < m; i += nt) v_b[(int64_t)i * nb + k] = vs[i];
    if (tid == 0) beta_b[k] = beta;
    __syncthreads();
  }
  for (int k = steps; k < nb; ++k) {  // fewer rows than columns: no reflector
    for (int i = tid; i < m; i += nt) v_b[(int64_t)i * nb + k] = T(0);
    if (tid == 0) beta_b[k] = T(0);
  }
  for (int64_t e = tid; e < panel; e += nt) {
    const int i = (int)(e / nb), j = (int)(e % nb);
    r_b[e] = i <= j ? As[j * ld + i] : T(0);
  }
}

template <typename T>
int launch(const T* a, T* v, T* beta, T* r, int64_t B, int64_t m, int64_t nb,
           cudaStream_t stream) {
  const int64_t bytes = smem_bytes(m, nb, sizeof(T));
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        panel_qr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  panel_qr_kernel<T><<<(unsigned)B, kThreads, (size_t)bytes, stream>>>(
      a, v, beta, r, (int)m, (int)nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one panel block needs, and the most a block may use.
int64_t pq_smem_bytes(int64_t m, int64_t nb, int64_t elem) { return smem_bytes(m, nb, elem); }
int64_t pq_smem_limit() { return kMaxSmem; }

int pq_launch_f32(const float* a, float* v, float* beta, float* r, int64_t B,
                  int64_t m, int64_t nb, void* stream) {
  return launch<float>(a, v, beta, r, B, m, nb, (cudaStream_t)stream);
}

int pq_launch_f64(const double* a, double* v, double* beta, double* r, int64_t B,
                  int64_t m, int64_t nb, void* stream) {
  return launch<double>(a, v, beta, r, B, m, nb, (cudaStream_t)stream);
}

}  // extern "C"
