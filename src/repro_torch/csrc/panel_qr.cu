// panel_qr: Householder factorization of a batch of [m, nb] panels, for Hopper,
// with the compact-WY factor T formed in the kernel.
//
// Replaces the TPU kernel src/repro/kernels/panel_qr/kernel.py:71
// panel_qr_kernel (body _panel_kernel at :25). For every panel of a
// [B, m, nb] batch (nb <= 32) it runs min(m, nb) Householder steps, each the
// same as the TPU kernel's: the norm of column k below the diagonal, the sign
// choice sgn = xk >= 0 ? 1 : -1, a reflector with unit diagonal (guarded by
// |vk| > 0), beta = 2 / v'v (guarded by v'v > 0), and the rank-1 update
// A -= beta v (v'A), accumulating in the I/O type. It writes R over the panel
// in place (zero below the diagonal), V [B, m, nb] (unit diagonal), beta
// [B, nb], and T [B, nb, nb] with Q = H_1 ... H_nb = I - V T V' (LAPACK's
// larft, forward and column-wise: the recurrence of
// core/postprocess.py:_panel_to_wy). The panel is read through a row stride
// and a batch stride, so a column block of a larger matrix needs no copy.
//
// What bounds it: neither bytes nor flops but the chain of dependent steps
// inside one panel, and on a batch of thousands of panels the instructions
// each step issues per row. The design cuts barriers, passes and launches:
//
//   * Each thread owns kRowsPerThread rows of the panel and keeps them in
//     registers (nb is a template parameter, NBT in {4, 8, 16, 32}, wider
//     columns masked). The rank-1 update is local to the thread: no index
//     arithmetic and no barrier. A 256-row panel takes four warps, a 70-row
//     one two, not a fixed 256 threads. The step loop stays rolled so its
//     code fits the instruction cache; registers are indexed only in
//     unrolled column loops, column k picked by a tree of selects.
//   * Two reductions per step, one barrier each: sigma^2 (with the pivot
//     x_k), then u = v'P over all NBT columns together with v'v. P holds R
//     above the diagonal and, below it, the reflectors of the earlier steps
//     (LAPACK's compact storage), so u[j] for j < k is z = V[:, :k]' v_k, the
//     vector T's recurrence needs, and u[j] for j >= k is w = v'A. Lanes
//     reduce u over a warp by a butterfly that leaves lane j with column j
//     (31 shuffles for 32 columns); warps meet in shared memory, one area per
//     reduction kind, so no trailing barrier is needed. w reaches every
//     lane through a per-warp slot read as 16-byte vectors.
//   * T: z and beta of every step are kept in shared memory; after the last
//     step lane r of warp 0 forms row r of T (T[r, k] = -beta_k T[r, :k] z_k,
//     each row its own recurrence), so T costs no barrier and no launch.
//   * Loads and stores go through a per-warp staging tile, so a warp moves
//     32 whole rows at a time, coalesced, from the strided view.
//
// Variants, chosen from m alone (kernels/panel_qr/kernel.py:variant mirrors
// pq_variant_of below):
//
//   reg      m <= kCtaRows: one block per panel.
//   cluster  m <= kCtaRows * kMaxCluster: a thread-block cluster of
//            ceil(m / kCtaRows) CTAs per panel (non-portable above 8), each
//            holding its share of the rows in registers. The partial sums
//            cross the cluster through distributed shared memory
//            (map_shared_rank) after a barrier.cluster arrive/wait, so a
//            [1024, 32] float64 panel runs on four SMs with no round trip
//            through L2 per step.
//   gmem     taller panels: one block per panel with the working panel, the
//            reflector and u in a device-memory scratch buffer, and only the
//            block reductions and T in shared memory. Slow, but it has no
//            size limit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxNb = 32;          // widest panel
constexpr int kCtaRows = 256;       // rows of one CTA
constexpr int kRowsPerThread = 2;   // so a 256-row CTA has four warps
constexpr int kMinBlocks = 3;       // CTAs per SM that ptxas budgets registers for
constexpr int kMaxCluster = 16;     // CTAs of one panel (above 8: non-portable)
constexpr int kSlot = 34;           // per-warp reduction slot: 32 lanes, 1 scalar, pad
constexpr int kGmemThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoClusterFits = -1;  // no cluster of the size fits one GPC

enum Variant { kReg = 0, kCluster = 1, kGmem = 2 };

__host__ __device__ int pq_variant_of(int64_t m) {
  if (m <= kCtaRows) return kReg;
  if (m <= (int64_t)kCtaRows * kMaxCluster) return kCluster;
  return kGmem;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The sum over the panel's rows of a per-lane column value (lane l holds the
// warp's partial of column l) and of a warp-uniform scalar. red is this
// reduction kind's area (MW slots; those of absent warps hold zeros)
// and cred its per-CTA total, read by the other CTAs of a cluster. Every
// lane gets (total of column lane, total of the scalar).
template <bool CLUSTER, int MW, typename T>
__device__ __forceinline__ void panel_sum(T col, T scalar, T* red, T* cred, int cs,
                                          T& col_total, T& scalar_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  red[warp * kSlot + lane] = col;
  if (lane == 0) red[warp * kSlot + 32] = scalar;
  __syncthreads();
  T c = T(0), s = T(0);
#pragma unroll
  for (int w = 0; w < MW; ++w) {
    c += red[w * kSlot + lane];
    s += red[w * kSlot + 32];
  }
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    if (warp == 0) {
      cred[lane] = c;
      if (lane == 0) cred[32] = s;
    }
    cluster.sync();
    c = T(0);
    s = T(0);
#pragma unroll 4
    for (int r = 0; r < cs; ++r) {
      const T* rc = cluster.map_shared_rank(cred, r);
      c += rc[lane];
      s += rc[32];
    }
  }
  col_total = c;
  scalar_total = s;
}

// p[k] for a runtime k, by a tree of selects on k's bits (depth log2 NBT),
// so p stays in registers.
template <typename T, int NBT>
__device__ __forceinline__ T pick(const T (&p)[NBT], int k) {
  T x[NBT];
#pragma unroll
  for (int j = 0; j < NBT; ++j) x[j] = p[j];
#pragma unroll
  for (int h = 1; h < NBT; h *= 2) {
    const bool bit = k & h;
#pragma unroll
    for (int j = 0; j < NBT; j += 2 * h) x[j] = bit ? x[j + h] : x[j];
  }
  return x[0];
}

// One butterfly level per call: lanes that differ in bit H swap halves of
// x[0, 2H), each keeping the half its bit selects, summed with its partner's.
template <typename T, int H>
__device__ __forceinline__ void butterfly(T* x, int lane) {
  if constexpr (H >= 1) {
    const bool up = lane & H;
#pragma unroll
    for (int t = 0; t < H; ++t) {
      const T send = up ? x[t] : x[t + H];
      const T keep = up ? x[t + H] : x[t];
      x[t] = keep + __shfl_xor_sync(kFull, send, H);
    }
    butterfly<T, H / 2>(x, lane);
  }
}

// Lane l gets the warp's sum of vi[r] * p[r][l % NBT] over its RPT rows and
// the warp's lanes: a butterfly that halves the columns a lane carries at
// each level (the first level forms the products).
template <typename T, int NBT, int RPT>
__device__ __forceinline__ T reduce_scatter(const T (&vi)[RPT], const T (&p)[RPT][NBT]) {
  const int lane = threadIdx.x & 31;
  constexpr int H = NBT / 2;
  T x[H];
  const bool up = lane & H;
#pragma unroll
  for (int t = 0; t < H; ++t) {
    T lo = T(0), hi = T(0);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      lo += vi[r] * p[r][t];
      hi += vi[r] * p[r][t + H];
    }
    x[t] = (up ? hi : lo) + __shfl_xor_sync(kFull, up ? lo : hi, H);
  }
  butterfly<T, H / 2>(x, lane);
  T s = x[0];
#pragma unroll
  for (int off = NBT; off < 32; off <<= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// Rows row0 .. row0 + 31 of a panel (row stride ld) into p of each lane,
// through the warp's staging tile (32 rows of NBT + 1): the warp reads
// consecutive columns of consecutive rows.
template <typename T, int NBT>
__device__ __forceinline__ void load_rows(const T* src, int64_t ld, int row0, int m, int nb,
                                          T* stage, T (&p)[NBT]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int it = 0; it < NBT; ++it) {
    const int e = it * 32 + lane, r = e / NBT, j = e % NBT;
    const int row = row0 + r;
    stage[r * (NBT + 1) + j] = row < m && j < nb ? src[(int64_t)row * ld + j] : T(0);
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NBT; ++j) p[j] = stage[lane * (NBT + 1) + j];
  __syncwarp();
}

template <typename T, int NBT>
__device__ __forceinline__ void store_rows(T* dst, int64_t ld, int row0, int m, int nb,
                                           T* stage, const T (&p)[NBT]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NBT; ++j) stage[lane * (NBT + 1) + j] = p[j];
  __syncwarp();
#pragma unroll
  for (int it = 0; it < NBT; ++it) {
    const int e = it * 32 + lane, r = e / NBT, j = e % NBT;
    const int row = row0 + r;
    if (row < m && j < nb) dst[(int64_t)row * ld + j] = stage[r * (NBT + 1) + j];
  }
  __syncwarp();
}

__host__ __device__ int64_t reg_smem_elems(int nw, int mw, int nbt) {
  // two reduction areas of mw slots, two CTA totals, w of each warp, z of
  // every step and beta (T's inputs), and one staging tile per warp
  return 2 * mw * kSlot + 2 * kSlot + (int64_t)mw * nbt +
         nbt * (nbt + 1) + nbt + (int64_t)nw * 32 * (nbt + 1);
}

// 16 bytes of T, for the broadcast reads of w.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// One panel per cluster of cs CTAs (CLUSTER false: a plain block, cs = 1).
// Warp w of CTA r holds rows r * rows_per_cta + (w * RPT + i) * 32 + lane,
// i < RPT.
template <typename T, int NBT, int RPT, bool CLUSTER>
__global__ void __launch_bounds__(kCtaRows / RPT, kMinBlocks)
    panel_qr_reg_kernel(T* __restrict__ a, int64_t lda, int64_t bstride,
                        T* __restrict__ v_out, T* __restrict__ beta_out,
                        T* __restrict__ t_out, int m, int nb, int cs) {
  constexpr int MW = kCtaRows / RPT / 32;     // most warps of a CTA
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);   // [2][MW][kSlot]
  T* cred = red + 2 * MW * kSlot;             // [2][kSlot]
  T* wsh = cred + 2 * kSlot;                  // [MW][NBT]: w, per warp
  T* zs = wsh + MW * NBT;                     // [NBT][NBT + 1]: z of step k in row k
  T* bs = zs + NBT * (NBT + 1);               // [NBT]: beta of step k
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T* stage = bs + NBT + warp * 32 * (NBT + 1);
  T* wsh_w = wsh + warp * NBT;

  const int rank = CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
  const int64_t panel = blockIdx.x / cs;
  const int row0 = rank * blockDim.x * RPT + warp * RPT * 32;
  const bool t_warp = rank == 0 && warp == 0;
  T* a_b = a + panel * bstride;
  // reduction slots of absent warps read as zeros (ordered by the first
  // reduction's barrier)
  for (int e = nw * kSlot + threadIdx.x; e < MW * kSlot; e += blockDim.x) {
    red[e] = T(0);
    red[MW * kSlot + e] = T(0);
  }

  T p[RPT][NBT];
  int row[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    row[i] = row0 + i * 32 + lane;
    load_rows<T, NBT>(a_b, lda, row0 + i * 32, m, nb, stage, p[i]);
  }

  // The step loop stays rolled (its code is what every warp of the SM
  // executes, so it must fit the instruction cache); p is indexed only by
  // unrolled column loops, and column k is picked by a select tree.
  const int steps = m < nb ? m : nb;
  unsigned safe_mask = 0;
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    // sigma^2 over rows >= k, and the pivot x_k (column 0 of the sum)
    T xcol[RPT];
    T s2 = T(0), xk_w = T(0);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      xcol[i] = pick<T, NBT>(p[i], k);
      const T x = row[i] >= k ? xcol[i] : T(0);
      s2 += x * x;
      if (row[i] == k) xk_w = x;
    }
    s2 = warp_sum(s2);
    xk_w = warp_sum(xk_w);
    T xk_col, sigma2;
    panel_sum<CLUSTER, MW>(lane == 0 ? xk_w : T(0), s2, red, cred, cs, xk_col, sigma2);
    const T xk = __shfl_sync(kFull, xk_col, 0);
    const T sigma = sqrt(sigma2);
    const T sgn = xk >= T(0) ? T(1) : T(-1);
    const T alpha = -sgn * sigma;
    const T vk = xk - alpha;
    const bool safe = fabs(vk) > T(0);
    T vi[RPT];
    T vv_w = T(0);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      vi[i] = row[i] > k ? xcol[i] : (row[i] == k ? vk : T(0));
      if (safe) vi[i] = vi[i] / vk;  // unit diagonal
      vv_w += vi[i] * vi[i];
    }

    // u = v'P over all columns (z for j < k, w for j >= k), with v'v
    const T part = reduce_scatter<T, NBT, RPT>(vi, p);
    vv_w = warp_sum(vv_w);
    T u, vv;
    panel_sum<CLUSTER, MW>(part, vv_w, red + MW * kSlot, cred + kSlot, cs, u, vv);
    const T beta = vv > T(0) ? T(2) / vv : T(0);
    if (t_warp) {  // T's inputs; T itself is formed after the last step
      if (lane < k) zs[k * (NBT + 1) + lane] = u;
      if (lane == 0) bs[k] = beta;
    }

    // w to every lane of the warp (zero for the columns before k), through
    // the warp's slot: one store and NBT / (16 / sizeof(T)) vector loads
    if (lane < NBT) wsh_w[lane] = lane >= k ? u : T(0);
    __syncwarp();
    T w[NBT];
    using V = typename Vec16<T>::type;
    constexpr int kPer = sizeof(V) / sizeof(T);
#pragma unroll
    for (int q = 0; q < NBT / kPer; ++q) {
      const V x = reinterpret_cast<const V*>(wsh_w)[q];
      const T* xs = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int e = 0; e < kPer; ++e) w[q * kPer + e] = xs[e];
    }

    // the rank-1 update p -= beta v w' over all columns (those before k see
    // w = 0); column k below the diagonal keeps v instead
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const T c = beta * vi[i];
      const bool keep_v = row[i] > k;
#pragma unroll
      for (int j = 0; j < NBT; ++j) {
        const T upd = p[i][j] - c * w[j];
        p[i][j] = j == k && keep_v ? vi[i] : upd;
      }
    }
    safe_mask |= (unsigned)safe << k;
  }

  // R over the panel (zero below the diagonal), then V (unit diagonal)
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    T out[NBT];
#pragma unroll
    for (int j = 0; j < NBT; ++j) out[j] = j >= row[i] ? p[i][j] : T(0);
    store_rows<T, NBT>(a_b, lda, row0 + i * 32, m, nb, stage, out);
#pragma unroll
    for (int j = 0; j < NBT; ++j) {
      const T diag = (safe_mask >> j) & 1u ? T(1) : T(0);
      out[j] = j >= steps ? T(0) : (j < row[i] ? p[i][j] : (j == row[i] ? diag : T(0)));
    }
    store_rows<T, NBT>(v_out + panel * m * nb, nb, row0 + i * 32, m, nb, stage, out);
  }
  if (t_warp) {
    // Row r of T (lane r): T[r, r] = beta_r and, for k > r,
    // T[r, k] = -beta_k * sum_c T[r, c] z_k[c]: each row is its own
    // recurrence, so the lanes form T at once.
    __syncwarp();
    T trow[NBT];
#pragma unroll
    for (int k = 0; k < NBT; ++k) {
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < k; ++c) acc += trow[c] * zs[k * (NBT + 1) + c];
      const T b = k < steps ? bs[k] : T(0);
      trow[k] = k >= steps ? T(0) : (lane < k ? -b * acc : (lane == k ? b : T(0)));
    }
    if (lane < nb) {
      T* t_r = t_out + (panel * nb + lane) * nb;
#pragma unroll
      for (int k = 0; k < NBT; ++k)
        if (k < nb) t_r[k] = trow[k];
      beta_out[panel * nb + lane] = lane < steps ? bs[lane] : T(0);
    }
  }
  if constexpr (CLUSTER) cg::this_cluster().sync();  // no CTA leaves while others read it
}

// Sum over the block; every thread gets the total. red holds >= 33 entries.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
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

// Scratch elements one panel of the gmem variant needs in device memory: the
// panel (nb columns of m), the reflector (m) and u (nb).
__host__ __device__ int64_t gmem_scratch_elems(int64_t m, int64_t nb) {
  return nb * m + m + nb;
}

// The gmem variant: the same steps with one block per panel, the working
// panel column-major in scratch. u[j] = v'A[:, j] for j >= k and
// z[j] = V[:, j]'v for j < k (from the V columns already stored), so T is
// formed as in the register variant.
template <typename T>
__global__ void panel_qr_gmem_kernel(T* __restrict__ a, int64_t lda, int64_t bstride,
                                     T* __restrict__ v_out, T* __restrict__ beta_out,
                                     T* __restrict__ t_out, T* __restrict__ scratch,
                                     int m, int nb) {
  __shared__ T red[33];
  __shared__ T ts[kMaxNb * (kMaxNb + 1)];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int64_t panel = blockIdx.x;
  T* a_b = a + panel * bstride;
  T* As = scratch + panel * gmem_scratch_elems(m, nb);  // column j at As + j * m
  T* vs = As + (int64_t)nb * m;
  T* us = vs + m;
  T* v_b = v_out + panel * m * nb;
  T* beta_b = beta_out + panel * nb;
  const int elems = m * nb;

  for (int e = tid; e < elems; e += nt) {
    const int i = e / nb, j = e % nb;
    As[j * m + i] = a_b[(int64_t)i * lda + j];
  }
  for (int e = tid; e < kMaxNb * (kMaxNb + 1); e += nt) ts[e] = T(0);
  __syncthreads();

  const int steps = m < nb ? m : nb;
  for (int k = 0; k < steps; ++k) {
    const T* col = As + k * m;
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
    for (int j = warp; j < nb; j += nw) {
      T s = T(0);
      if (j >= k) {
        const T* cj = As + j * m;
        for (int i = k + lane; i < m; i += 32) s += vs[i] * cj[i];
      } else {
        for (int i = k + lane; i < m; i += 32) s += vs[i] * v_b[(int64_t)i * nb + j];
      }
      s = warp_sum(s);
      if (lane == 0) us[j] = s;
    }
    __syncthreads();
    if (warp == 0) {
      T acc = T(0);
      if (lane < k)
        for (int c = 0; c < k; ++c) acc += ts[lane * (kMaxNb + 1) + c] * us[c];
      if (lane < k) ts[lane * (kMaxNb + 1) + k] = -beta * acc;
      else if (lane == k) ts[k * (kMaxNb + 1) + k] = beta;
    }
    const int rows = m - k, cols = nb - k;
    for (int e = tid; e < rows * cols; e += nt) {
      const int i = k + e % rows, j = k + e / rows;
      As[j * m + i] -= beta * vs[i] * us[j];
    }
    for (int i = tid; i < m; i += nt) v_b[(int64_t)i * nb + k] = vs[i];
    if (tid == 0) beta_b[k] = beta;
    __syncthreads();
  }
  for (int k = steps; k < nb; ++k) {  // fewer rows than columns: no reflector
    for (int i = tid; i < m; i += nt) v_b[(int64_t)i * nb + k] = T(0);
    if (tid == 0) beta_b[k] = T(0);
  }
  for (int e = tid; e < elems; e += nt) {
    const int i = e / nb, j = e % nb;
    a_b[(int64_t)i * lda + j] = i <= j ? As[j * m + i] : T(0);
  }
  T* t_b = t_out + panel * nb * nb;
  for (int e = tid; e < nb * nb; e += nt) t_b[e] = ts[(e / nb) * (kMaxNb + 1) + e % nb];
}

template <typename T, int NBT>
int launch_reg(T* a, int64_t lda, int64_t bstride, T* v, T* beta, T* t, int64_t B,
               int m, int nb, cudaStream_t stream) {
  const int cs = (m + kCtaRows - 1) / kCtaRows;
  const int rows = (m + cs - 1) / cs;
  constexpr int kWarpRows = 32 * kRowsPerThread;
  const int threads = (rows + kWarpRows - 1) / kWarpRows * 32;
  const size_t bytes = (size_t)reg_smem_elems(threads / 32, kCtaRows / kWarpRows, NBT) * sizeof(T);
  if (cs == 1) {
    auto kern = panel_qr_reg_kernel<T, NBT, kRowsPerThread, false>;
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)B, threads, bytes, stream>>>(a, lda, bstride, v, beta, t, m, nb, 1);
    return (int)cudaGetLastError();
  }
  auto kern = panel_qr_reg_kernel<T, NBT, kRowsPerThread, true>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (cs > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * cs));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters == 0) return kNoClusterFits;
  err = cudaLaunchKernelEx(&cfg, kern, a, lda, bstride, v, beta, t, m, nb, cs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(T* a, int64_t lda, int64_t bstride, T* v, T* beta, T* t, T* scratch,
           int64_t B, int64_t m, int64_t nb, cudaStream_t stream) {
  if (nb < 1 || nb > kMaxNb || m < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (pq_variant_of(m) == kGmem) {
    if (m * nb > INT_MAX || gmem_scratch_elems(m, nb) > INT_MAX)
      return (int)cudaErrorInvalidValue;
    panel_qr_gmem_kernel<T><<<(unsigned)B, kGmemThreads, 0, stream>>>(
        a, lda, bstride, v, beta, t, scratch, (int)m, (int)nb);
    return (int)cudaGetLastError();
  }
  const int mi = (int)m, ni = (int)nb;
  if (nb <= 4) return launch_reg<T, 4>(a, lda, bstride, v, beta, t, B, mi, ni, stream);
  if (nb <= 8) return launch_reg<T, 8>(a, lda, bstride, v, beta, t, B, mi, ni, stream);
  if (nb <= 16) return launch_reg<T, 16>(a, lda, bstride, v, beta, t, B, mi, ni, stream);
  return launch_reg<T, 32>(a, lda, bstride, v, beta, t, B, mi, ni, stream);
}

}  // namespace

extern "C" {

// 0 = reg, 1 = cluster, 2 = gmem, for an [m, nb] panel.
int pq_variant(int64_t m) { return pq_variant_of(m); }

// Scratch the gmem variant needs: B * pq_gmem_scratch_elems(m, nb) elements.
int64_t pq_gmem_scratch_elems(int64_t m, int64_t nb) { return gmem_scratch_elems(m, nb); }

// Factor B panels a[b * bstride + i * lda + j] (i < m, j < nb <= 32) in
// place: R over a, V [B, m, nb], beta [B, nb] and T [B, nb, nb] out.
// scratch is used by the gmem variant only. Returns a CUDA error code,
// or -1 when no cluster of the size the panel needs fits the card.
int pq_wy_launch_f32(float* a, int64_t lda, int64_t bstride, float* v, float* beta,
                     float* t, float* scratch, int64_t B, int64_t m, int64_t nb,
                     void* stream) {
  return launch<float>(a, lda, bstride, v, beta, t, scratch, B, m, nb, (cudaStream_t)stream);
}

int pq_wy_launch_f64(double* a, int64_t lda, int64_t bstride, double* v, double* beta,
                     double* t, double* scratch, int64_t B, int64_t m, int64_t nb,
                     void* stream) {
  return launch<double>(a, lda, bstride, v, beta, t, scratch, B, m, nb,
                        (cudaStream_t)stream);
}

}  // extern "C"
