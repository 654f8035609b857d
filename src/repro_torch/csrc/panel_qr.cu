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
//
// A panel whose shared-memory footprint exceeds what a block may use
// (227 KiB: in float64 with nb = 32, more than ~870 rows, which the TSQR
// combine reaches at N > ~435 columns) goes to panel_qr_gmem_kernel instead:
// the same steps, one block per panel, with the working panel, the reflector
// and w = v'A in a device-memory scratch buffer (column-major, leading
// dimension m) and only the block reductions in shared memory. It is slower
// (every step reads and writes the trailing panel in device memory, mostly
// from L2), but it has no size limit. The wrapper picks the variant by
// smem_bytes against kMaxSmem, which kernels/panel_qr/kernel.py mirrors; the
// shared-memory launch still refuses a panel over kMaxSmem.

#include <cuda_runtime.h>
#include <limits.h>
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

// The Householder steps on a column-major working copy of one panel (column j
// at As + j * ld), with the reflector in vs [m] and w = v'A in ws [nb];
// red is the block-reduction scratch (33 entries, shared memory). As, vs and
// ws lie in shared memory (panel_qr_kernel) or in device memory
// (panel_qr_gmem_kernel); the barriers order both for the block. Offsets
// inside a panel are 32-bit (the launchers refuse m * nb > INT_MAX): the
// rank-1 update's index arithmetic is on the critical path, and 64-bit
// division there made the kernel measurably slower.
template <typename T>
__device__ void householder_steps(const T* __restrict__ a_b, T* As, int ld, T* vs, T* ws,
                                  T* red, T* __restrict__ v_b, T* __restrict__ beta_b,
                                  T* __restrict__ r_b, int m, int nb) {
  const int panel = m * nb;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;

  for (int e = tid; e < panel; e += nt) {
    const int i = e / nb, j = e % nb;
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
  for (int e = tid; e < panel; e += nt) {
    const int i = e / nb, j = e % nb;
    r_b[e] = i <= j ? As[j * ld + i] : T(0);
  }
}

template <typename T>
__global__ void panel_qr_kernel(const T* __restrict__ a, T* __restrict__ v_out,
                                T* __restrict__ beta_out, T* __restrict__ r_out,
                                int m, int nb) {
  extern __shared__ unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // nb columns of m + 1
  const int ld = m + 1;
  T* vs = As + (int64_t)nb * ld;  // [m] current reflector
  T* red = vs + m;                // [33] reduction scratch
  T* ws = red + 33;               // [nb] w = v'A
  const int64_t panel = (int64_t)m * nb;
  householder_steps(a + blockIdx.x * panel, As, ld, vs, ws, red,
                    v_out + blockIdx.x * panel, beta_out + (int64_t)blockIdx.x * nb,
                    r_out + blockIdx.x * panel, m, nb);
}

// Scratch elements one panel needs in device memory: the panel (nb columns of
// m), the reflector (m) and w (nb).
__host__ __device__ int64_t gmem_scratch_elems(int64_t m, int64_t nb) {
  return nb * m + m + nb;
}

template <typename T>
__global__ void panel_qr_gmem_kernel(const T* __restrict__ a, T* __restrict__ v_out,
                                     T* __restrict__ beta_out, T* __restrict__ r_out,
                                     T* scratch, int m, int nb) {
  __shared__ T red[33];
  T* As = scratch + blockIdx.x * gmem_scratch_elems(m, nb);
  T* vs = As + (int64_t)nb * m;
  T* ws = vs + m;
  const int64_t panel = (int64_t)m * nb;
  householder_steps(a + blockIdx.x * panel, As, m, vs, ws, red,
                    v_out + blockIdx.x * panel, beta_out + (int64_t)blockIdx.x * nb,
                    r_out + blockIdx.x * panel, m, nb);
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

template <typename T>
int launch_gmem(const T* a, T* v, T* beta, T* r, T* scratch, int64_t B, int64_t m,
                int64_t nb, cudaStream_t stream) {
  if (gmem_scratch_elems(m, nb) > INT_MAX) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  panel_qr_gmem_kernel<T><<<(unsigned)B, kThreads, 0, stream>>>(
      a, v, beta, r, scratch, (int)m, (int)nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pq_launch_f32(const float* a, float* v, float* beta, float* r, int64_t B,
                  int64_t m, int64_t nb, void* stream) {
  return launch<float>(a, v, beta, r, B, m, nb, (cudaStream_t)stream);
}

int pq_launch_f64(const double* a, double* v, double* beta, double* r, int64_t B,
                  int64_t m, int64_t nb, void* stream) {
  return launch<double>(a, v, beta, r, B, m, nb, (cudaStream_t)stream);
}

// The device-memory variant, for panels over kMaxSmem; scratch holds
// B * pq_gmem_scratch_elems(m, nb) elements.
int64_t pq_gmem_scratch_elems(int64_t m, int64_t nb) { return gmem_scratch_elems(m, nb); }

int pq_launch_gmem_f32(const float* a, float* v, float* beta, float* r, float* scratch,
                       int64_t B, int64_t m, int64_t nb, void* stream) {
  return launch_gmem<float>(a, v, beta, r, scratch, B, m, nb, (cudaStream_t)stream);
}

int pq_launch_gmem_f64(const double* a, double* v, double* beta, double* r,
                       double* scratch, int64_t B, int64_t m, int64_t nb, void* stream) {
  return launch_gmem<double>(a, v, beta, r, scratch, B, m, nb, (cudaStream_t)stream);
}

}  // extern "C"
