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
// What bounds the reg and cluster variants (panels up to 4,096 rows): neither
// bytes nor flops but the chain of dependent steps inside one panel, and on a
// batch of thousands of panels the instructions each step issues per row.
// Their design cuts barriers, passes and launches:
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
//   grid     taller panels (up to a whole R0 of 2.4e7 rows): no cluster holds
//            them on chip, so every step sweeps the panel through device
//            memory, and the sweeps bound it (a pass over a few columns costs
//            nearly what a wide one does: the panel's rows lie 35 elements
//            apart in R0). A cooperative grid of every co-resident CTA
//            spreads the panels' rows in contiguous ranges, one per CTA, and
//            works on `a` in place (LAPACK's compact storage; nothing else
//            holds the panel). One pass per step applies reflector k and adds
//            up, by look-ahead, the partial sums step k + 1 needs; one
//            grid-wide barrier and a reduction in a fixed order (no atomics)
//            give every CTA the same reflector. Inner blocks of kInner columns
//            keep the steps' passes to the block's columns; the block then
//            reaches the columns right of it in compact-WY form. The last
//            pass writes R and V and adds up V'V, from which T is formed.
//            Batches larger than the grid run in waves inside the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxNb = 32;          // widest panel
constexpr int kCtaRows = 256;       // rows of one CTA
constexpr int kRowsPerThread = 2;   // so a 256-row CTA has four warps
constexpr int kMinBlocks = 3;       // CTAs per SM that ptxas budgets registers for
constexpr int kMaxCluster = 16;     // CTAs of one panel (above 8: non-portable)
constexpr int kSlot = 34;           // per-warp reduction slot: 32 lanes, 1 scalar, pad
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoClusterFits = -1;  // no cluster of the size fits one GPC

enum Variant { kReg = 0, kCluster = 1, kGrid = 2 };

__host__ __device__ int pq_variant_of(int64_t m) {
  if (m <= kCtaRows) return kReg;
  if (m <= (int64_t)kCtaRows * kMaxCluster) return kCluster;
  return kGrid;
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

// ---- the grid variant ------------------------------------------------------

constexpr int kGridThreads = 512;       // threads of one CTA of the grid variant
constexpr int kGridWarps = kGridThreads / 32;
constexpr int kGridUnroll = 8;          // row groups a warp holds per iteration of a pass
constexpr int kGridMinRows = kCtaRows;  // fewest rows worth a CTA of their own
constexpr int kInner = 8;               // columns of an inner block

// How the grid variant spreads B panels of m rows over `resident` co-resident
// CTAs: `per` CTAs to a panel (at least one), `wave` panels at once, in
// `waves` rounds inside the launch.
struct GridShape {
  int per, wave, waves;
};

__host__ __device__ GridShape grid_shape(int64_t B, int64_t m, int64_t resident) {
  int64_t per = resident / B;
  const int64_t useful = (m + kGridMinRows - 1) / kGridMinRows;
  if (per > useful) per = useful;
  if (per < 1) per = 1;
  int64_t wave = resident / per;
  if (wave > B) wave = B;
  return {(int)per, (int)wave, (int)((B + wave - 1) / wave)};
}

// Workspace of one panel of a wave: each CTA's partial sums and the pivot row,
// for two steps in turn, and each CTA's kInner x kMaxNb sums at an inner
// block's end (the block's rows of V'V and its V_b' A).
__host__ __device__ int64_t grid_slot_elems(int per) {
  return (int64_t)kMaxNb * (2 * (int64_t)per + 2 + (int64_t)per * kInner);
}

// Reflectors first .. last of the inner block [j0, hi), applied in order to
// the row groups x of a warp (lane: column c of row base + u * 32 / W + sub;
// column s sits in lane s - col0 of the row group): the scalars of step s are
// vsc[s] (1 / v_p), vdiag[s] (v_s's diagonal) and bus[s - j0][c] (beta u).
// Column s keeps v below the diagonal, and the columns right of the block
// are left as they are. Re-applying reflectors to the columns as memory holds
// them gives the bits a pass that stored every step would have stored, so
// most of a block's steps read the panel and write nothing.
template <typename T, int NBT, int W>
__device__ __forceinline__ void apply_block(T (&x)[kGridUnroll], int j0, int first, int last,
                                            int hi, int col0, int c, int base, int sub,
                                            const T* vsc, const T* vdiag, const T (*bus)[NBT]) {
  constexpr int RW = 32 / W;
  for (int s = first; s <= last; ++s) {
    const T vs = vsc[s], dk = vdiag[s], bc = bus[s - j0][c];
#pragma unroll
    for (int u = 0; u < kGridUnroll; ++u) {
      const int i = base + u * RW + sub;
      const T xs = __shfl_sync(kFull, x[u], s - col0, W);
      const T vi = i > s ? xs * vs : (i == s ? dk : T(0));
      const T upd = x[u] - vi * bc;
      x[u] = c < s || i < s || c >= hi ? x[u] : (c == s && i > s ? vi : upd);
    }
  }
}

// A step pass of an inner block [j0, hi) over the CTA's rows [r0, r1), lane l
// holding column j0 + l % W of row l / W of a group of 32 / W rows: read the
// block's columns, apply its reflectors j0 .. k (k >= 0), and add to h this
// lane's column of step k + 1's tail sums (x the updated column k + 1); the
// row k + 1 goes to piv_next. k = -1 only reads. The block's last step pass
// (k = hi - 2, `store`) writes the block's columns back, so the pass that
// closes the block, whose lanes hold whole rows, applies one reflector only.
template <typename T, int NBT, int W>
__device__ __forceinline__ void grid_step(T* a_b, int64_t lda, int k, int j0, int hi, int r0,
                                          int r1, bool store, const T* vsc, const T* vdiag,
                                          const T (*bus)[NBT], T* piv_next, T& h) {
  constexpr int RW = 32 / W;                 // rows a warp holds side by side
  constexpr int kTile = kGridUnroll * RW;    // rows of one warp iteration
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = j0 + lane % W, sub = lane / W;
  const int lo = store ? j0 : k;  // the first row read
  for (int base = r0 + warp * kTile; base < r1; base += kGridWarps * kTile) {
    T x[kGridUnroll];
#pragma unroll
    for (int u = 0; u < kGridUnroll; ++u) {
      const int i = base + u * RW + sub;
      x[u] = i < r1 && c < hi && i >= lo ? a_b[(int64_t)i * lda + c] : T(0);
    }
    apply_block<T, NBT, W>(x, j0, j0, k, hi, j0, c, base, sub, vsc, vdiag, bus);
    if (store) {
#pragma unroll
      for (int u = 0; u < kGridUnroll; ++u) {
        const int i = base + u * RW + sub;
        if (i < r1 && c < hi && i >= j0) a_b[(int64_t)i * lda + c] = x[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kGridUnroll; ++u) {
      const int i = base + u * RW + sub;
      const T xn = __shfl_sync(kFull, x[u], k + 1 - j0, W);
      if (i > k + 1 && i < r1 && c > k && c < hi) h += xn * x[u];
      if (i == k + 1 && i < r1) piv_next[c] = x[u];
    }
  }
}

// The two passes that close an inner block [j0, hi) (hi < nb), over the rows
// >= j0, lane l holding column l % NBT of a row; each row's V_b
// (the block's reflectors, unit diagonal) is gathered from the block's lanes.
// Not TRAIL: read the columns left of the block too, apply the block's last
// reflector k = hi - 1, write column k, and add to s[r] (lane c)
// V_b[i, j0 + r] Y[i, c] with Y = V left of and in the block and A right of
// it: the block's rows of V'V and its V_b' A.
// TRAIL: A[:, hi:] -= V_b M with M = T_b' V_b' A[:, hi:] (mm), and add to h this
// lane's column of step hi's tail sums; the row hi goes to piv_next.
template <typename T, int NBT, bool TRAIL>
__device__ __forceinline__ void grid_block(T* a_b, int64_t lda, int nb, int j0, int hi, int r0,
                                           int r1, const T* vsc, const T* vdiag,
                                           const T (*bus)[NBT], const T (*mm)[NBT],
                                           T* piv_next, T& h, T (&s)[kInner]) {
  constexpr int RW = 32 / NBT;
  constexpr int kTile = kGridUnroll * RW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % NBT, sub = lane / NBT;
  const bool col_in = (!TRAIL || c >= j0) && c < nb;
  const bool in_block = c >= j0 && c < hi, right = c >= hi && c < nb;
  const T dc = in_block ? vdiag[c] : T(0);
  T mr[kInner];
#pragma unroll
  for (int r = 0; r < kInner; ++r) mr[r] = TRAIL && right ? mm[r][c] : T(0);
  for (int base = r0 + warp * kTile; base < r1; base += kGridWarps * kTile) {
    T x[kGridUnroll];
#pragma unroll
    for (int u = 0; u < kGridUnroll; ++u) {
      const int i = base + u * RW + sub;
      x[u] = i < r1 && col_in && i >= j0 ? a_b[(int64_t)i * lda + c] : T(0);
    }
    if constexpr (!TRAIL) {
      apply_block<T, NBT, NBT>(x, j0, hi - 1, hi - 1, hi, 0, c, base, sub, vsc, vdiag, bus);
#pragma unroll
      for (int u = 0; u < kGridUnroll; ++u) {
        const int i = base + u * RW + sub;
        if (c == hi - 1 && i < r1 && i >= hi - 1) a_b[(int64_t)i * lda + c] = x[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kGridUnroll; ++u) {
      const int i = base + u * RW + sub;
      const bool row_in = i < r1 && i >= j0;
      T val = x[u];
      const T y = !row_in ? T(0) : (in_block && c >= i ? (c == i ? dc : T(0)) : val);
      if constexpr (!TRAIL) {
#pragma unroll
        for (int r = 0; r < kInner; ++r) s[r] += __shfl_sync(kFull, y, j0 + r, NBT) * y;
      } else {
        T upd = val;
#pragma unroll
        for (int r = 0; r < kInner; ++r) upd -= __shfl_sync(kFull, y, j0 + r, NBT) * mr[r];
        if (right && row_in) {
          val = upd;
          a_b[(int64_t)i * lda + c] = val;
        }
        const T xn = __shfl_sync(kFull, val, hi, NBT);
        if (i > hi && i < r1 && c >= hi) h += xn * val;
        if (i == hi && i < r1) piv_next[c] = val;
      }
    }
  }
}

// The last pass, over whole rows: apply the last inner block [j0, nb)'s
// reflectors first .. nb - 1, write R (zero below the diagonal) over the panel
// and V (unit diagonal) to v_b, and add to s[r] (lane c) V[i, j0 + r] V[i, c]:
// the last block's rows of V'V.
template <typename T, int NBT, int R>
__device__ __forceinline__ void grid_final(T* a_b, int64_t lda, T* v_b, int nb, int j0,
                                           int first, int r0, int r1, const T* vsc,
                                           const T* vdiag, const T (*bus)[NBT], T (&s)[R]) {
  constexpr int RW = 32 / NBT;
  constexpr int kTile = kGridUnroll * RW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % NBT, sub = lane / NBT;
  const T dc = c < nb ? vdiag[c] : T(0);
  for (int base = r0 + warp * kTile; base < r1; base += kGridWarps * kTile) {
    T x[kGridUnroll];
#pragma unroll
    for (int u = 0; u < kGridUnroll; ++u) {
      const int i = base + u * RW + sub;
      x[u] = i < r1 && c < nb ? a_b[(int64_t)i * lda + c] : T(0);
    }
    apply_block<T, NBT, NBT>(x, j0, first, nb - 1, nb, 0, c, base, sub, vsc, vdiag, bus);
#pragma unroll
    for (int u = 0; u < kGridUnroll; ++u) {
      const int i = base + u * RW + sub;
      const bool row_in = i < r1;
      const T val = x[u];
      const T vrow = !row_in || c >= nb ? T(0) : (c < i ? val : (c == i ? dc : T(0)));
      if (row_in && c < nb) {
        a_b[(int64_t)i * lda + c] = c >= i ? val : T(0);
        v_b[(int64_t)i * nb + c] = vrow;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] += vrow * __shfl_sync(kFull, vrow, j0 + r, NBT);
    }
  }
}

// The CTA's h (lane c % W's column col0 + c): over the warp's row groups, then
// over the warps in order, stored to dst[col0 ..].
template <typename T, int NBT, int W>
__device__ __forceinline__ void cta_put_h(T h, int col0, T (*warp_part)[NBT], T* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = W; off < 32; off <<= 1) h += __shfl_xor_sync(kFull, h, off);
  if (lane < W) warp_part[warp][lane] = h;
  __syncthreads();
  if (threadIdx.x < W) {
    T s = T(0);
    for (int ww = 0; ww < kGridWarps; ++ww) s += warp_part[ww][threadIdx.x];
    dst[col0 + threadIdx.x] = s;
  }
}

// The CTA's sums acc[r] (lane c: column c): over the warp's row groups, then
// added warp by warp into sum[r][c], and stored to dst[r * kMaxNb + c].
template <typename T, int NBT, int R>
__device__ __forceinline__ void cta_put_sums(T (&acc)[R], T (*sum)[NBT + 1], T* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = NBT; off < 32; off <<= 1) acc[r] += __shfl_xor_sync(kFull, acc[r], off);
  }
  for (int ww = 0; ww < kGridWarps; ++ww) {
    if (warp == ww && lane < NBT) {
#pragma unroll
      for (int r = 0; r < R; ++r) sum[r][lane] = (ww == 0 ? T(0) : sum[r][lane]) + acc[r];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < R * NBT; e += kGridThreads)
    dst[(e / NBT) * kMaxNb + e % NBT] = sum[e / NBT][e % NBT];
}

// sum[r][c] = the panel's CTAs' slots src[x][r * kMaxNb + c] (r < R, slots
// kInner * kMaxNb apart) added in one fixed order, in four interleaved partial
// sums so the loads overlap.
template <typename T, int NBT, int R>
__device__ __forceinline__ void panel_sums(const T* src, int per, T (*sum)[NBT + 1]) {
  for (int e = threadIdx.x; e < R * NBT; e += kGridThreads) {
    const T* p = src + (e / NBT) * kMaxNb + e % NBT;
    T s[4] = {T(0), T(0), T(0), T(0)};
    int x = 0;
    for (; x + 4 <= per; x += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] += __ldcg(p + (int64_t)(x + j) * kInner * kMaxNb);
    }
    for (int j = 0; x < per; ++x, ++j) s[j] += __ldcg(p + (int64_t)x * kInner * kMaxNb);
    sum[e / NBT][e % NBT] = (s[0] + s[1]) + (s[2] + s[3]);
  }
  __syncthreads();
}

// T's rows in lanes: lane r (r < n) gets row r of T for the reflectors with
// betas[0 ..] and Gram gram(cc, kk) = v_cc' v_kk, by the forward recurrence
// T[r, kk] = -beta_kk sum_cc T[r, cc] G[cc, kk] (each row its own recurrence).
template <typename T, int N, typename G>
__device__ __forceinline__ void t_rows(int n, const T* betas, G gram, T (&trow)[N]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    T acc = T(0);
#pragma unroll
    for (int cc = 0; cc < kk; ++cc) acc += trow[cc] * gram(cc, kk);
    const T b = kk < n ? betas[kk] : T(0);
    trow[kk] = kk >= n ? T(0) : (lane < kk ? -b * acc : (lane == kk ? b : T(0)));
  }
}

// Built with -DPQ_TRACE (tools/panel_qr_grid_trace.py), CTA 0 of the grid
// variant records (label, %globaltimer) after each phase of a launch in
// pq_trace_buf, read back by pq_trace_read; label 100 * (k + 1) + phase.
#ifdef PQ_TRACE
__device__ unsigned long long pq_trace_buf[1024];
__device__ __forceinline__ void pq_mark(int& n, int label) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && n < 512) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    pq_trace_buf[2 * n] = label;
    pq_trace_buf[2 * n + 1] = t;
  }
  ++n;
}
#define PQ_MARK(label) pq_mark(trace_n, (label))
#else
#define PQ_MARK(label)
#endif

// One panel per `per` consecutive CTAs of a cooperative grid. CTA r of a
// panel owns the rows [r * rows_per, (r + 1) * rows_per) and touches no other
// row of `a`. A warp reads whole rows (the columns a pass needs), coalesced,
// straight from the strided panel, lane l holding one column of one row, so a
// column's partial sums stay in the lane that holds it.
//
// The columns go in inner blocks of kInner. A step k of block [j0, hi) has
// one pass over the block's columns >= k: it applies reflector k and adds up,
// by look-ahead, what step k + 1 needs, with x the updated column k + 1: the
// tail sums h[j] = sum_{i > k+1} x_i P[i, j] (h[k + 1] is sigma^2 less the
// pivot's square) and, in the CTA that holds it, the pivot row P[k + 1, :].
// After one grid barrier every CTA adds the CTAs' slots in the same order, so
// all derive the same bits of
//   alpha = -sgn(x_p) sigma,  v_p = x_p - alpha,
//   v'v = h[k] / v_p^2 + 1,  u[j] = v'P[:, j] = h[j] / v_p + P[k, j]
// for the unit-diagonal v (v unscaled where |v_p| = 0: the TPU kernel's
// guards). The block's last step adds up V_b'[V A] (its reflectors against
// those up to its end, and against the columns right of the block); after a
// barrier every CTA forms T_b and M = T_b' V_b' A, and one pass applies the
// block to the columns right of it (A -= V_b M) with the look-ahead of the
// next block's first step. So the columns right of a block are read twice per
// block, not twice per step. The last pass reads whole rows, writes R (zero
// below the diagonal) over `a` and V to v_out, and adds up the last block's
// rows of V'V; after one more grid barrier the panel's first CTA forms T from
// V'V. Partial sums are read with ld.global.cg: their slots are rewritten,
// and L1 is not coherent across SMs.
template <typename T, int NBT>
__global__ void __launch_bounds__(kGridThreads, 1)
    panel_qr_grid_kernel(T* __restrict__ a, int64_t lda, int64_t bstride,
                         T* __restrict__ v_out, T* __restrict__ beta_out,
                         T* __restrict__ t_out, T* __restrict__ work, int64_t B, int m,
                         int nb, int per, int wave) {
  constexpr int kGroups = kGridThreads / NBT;
  constexpr int kStepW = NBT < kInner ? NBT : kInner;  // lanes per row in a step pass
  constexpr int kRows = kStepW;                       // V'V rows the last pass adds up
  // the block's last step pass stores it when the pass closing the block
  // (whole rows per warp) would re-apply its reflectors at a higher cost
  constexpr bool kStoreLast = NBT > kStepW;
  __shared__ T warp_part[kGridWarps][NBT];  // h of each warp
  __shared__ T grp[kGridThreads];           // h over a group of CTAs
  __shared__ T bus[kInner][NBT];            // beta * u of each step of the block
  __shared__ T vsc[NBT];                    // 1 / v_p of each step (1 where no reflector)
  __shared__ T vdiag[NBT];                  // V's diagonal of each step (v_k)
  __shared__ T betas[NBT];
  __shared__ T sb[kInner][NBT + 1];         // a block's rows of V'V and its V_b' A
  __shared__ T gram[NBT][NBT + 1];          // V'V, a block's rows at a time
  __shared__ T tb[kInner][kInner + 1];      // T_b of a block
  __shared__ T mm[kInner][NBT];             // M = T_b' V_b' A of a block

  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane % NBT;
  const int q = blockIdx.x / per, rank = blockIdx.x % per;
  const int64_t rows_per = ((int64_t)m + per - 1) / per;
  const int64_t start = rank * rows_per, end = start + rows_per;
  const int r0 = (int)(start < m ? start : m);
  const int r1 = (int)(end < m ? end : m);
  const int groups = per < kGroups ? per : kGroups;
  T* hpart = work + q * grid_slot_elems(per);    // [2][per][kMaxNb]
  T* pivot = hpart + 2 * (int64_t)per * kMaxNb;  // [2][kMaxNb]
  T* gpart = pivot + 2 * kMaxNb;                 // [per][kInner][kMaxNb]
  T* gmine = gpart + (int64_t)rank * kInner * kMaxNb;
  const int64_t waves = (B + wave - 1) / wave;
#ifdef PQ_TRACE
  int trace_n = 0;
#endif
  PQ_MARK(0);

  for (int64_t w = 0; w < waves; ++w) {
    const int64_t panel = w * wave + q;
    const bool live = panel < B;  // the last wave may hold fewer panels
    T* a_b = a + (live ? panel : 0) * bstride;
    T* v_b = v_out + (live ? panel : 0) * (int64_t)m * nb;
    for (int k = -1; k < nb; ++k) {
      if (live && k >= 0) {
        // step k's sums over the panel, added in one fixed order in every CTA
        const T* hp = hpart + (k & 1) * (int64_t)per * kMaxNb;
        const int g = threadIdx.x / NBT;
        if (g < groups) {
          T s = T(0);
          for (int r = g; r < per; r += groups) s += __ldcg(hp + (int64_t)r * kMaxNb + c);
          grp[threadIdx.x] = s;
        }
        __syncthreads();
        if (threadIdx.x < NBT) {
          T hk = T(0), hc = T(0);
          for (int gg = 0; gg < groups; ++gg) {
            hk += grp[gg * NBT + k];
            hc += grp[gg * NBT + threadIdx.x];
          }
          const T* pv = pivot + (k & 1) * kMaxNb;
          const T xp = __ldcg(pv + k), pc = __ldcg(pv + threadIdx.x);
          const T sigma = sqrt(hk + xp * xp);
          const T sgn = xp >= T(0) ? T(1) : T(-1);
          const T alpha = -sgn * sigma;
          const T vk = xp - alpha;
          const bool safe = fabs(vk) > T(0);
          const T inv = safe ? T(1) / vk : T(1);
          const T vv = safe ? hk * inv * inv + T(1) : hk + vk * vk;
          const T u = safe ? hc * inv + pc : hc + vk * pc;
          const T beta = vv > T(0) ? T(2) / vv : T(0);
          bus[k % kInner][threadIdx.x] = beta * u;
          if (threadIdx.x == 0) {
            vsc[k] = inv;
            vdiag[k] = safe ? T(1) : vk;
            betas[k] = beta;
          }
        }
        __syncthreads();
      }

      PQ_MARK(100 * (k + 1) + 1);  // scalars done
      const int j0 = k < 0 ? 0 : k / kInner * kInner;  // the inner block of step k
      const int hi = j0 + kInner < nb ? j0 + kInner : nb;
      const bool block_end = k == hi - 1 && hi < nb;   // the same in every CTA
      T* piv_next = pivot + ((k + 1) & 1) * kMaxNb;
      T* h_next = hpart + (((k + 1) & 1) * (int64_t)per + rank) * kMaxNb;
      if (live) {
        if (k < hi - 1) {
          T h = T(0);
          grid_step<T, NBT, kStepW>(a_b, lda, k, j0, hi, r0, r1,
                                    kStoreLast && k >= 0 && k == hi - 2, vsc, vdiag, bus,
                                    piv_next, h);
          cta_put_h<T, NBT, kStepW>(h, j0, warp_part, h_next);
        } else if (!block_end) {
          T s[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) s[r] = T(0);
          grid_final<T, NBT, kRows>(a_b, lda, v_b, nb, j0, kStoreLast ? k : j0, r0, r1, vsc,
                                    vdiag, bus, s);
          cta_put_sums<T, NBT, kRows>(s, sb, gmine);
        }
      }
      PQ_MARK(100 * (k + 1) + 2);  // pass done
      if constexpr (NBT > kInner) {
        if (block_end) {
          T h = T(0), s[kInner];
#pragma unroll
          for (int r = 0; r < kInner; ++r) s[r] = T(0);
          if (live) {
            grid_block<T, NBT, false>(a_b, lda, nb, j0, hi, r0, r1, vsc, vdiag, bus, mm,
                                      piv_next, h, s);
            cta_put_sums<T, NBT, kInner>(s, sb, gmine);
          }
          PQ_MARK(100 * (k + 1) + 6);
          grid.sync();  // the block's sums are in
          PQ_MARK(100 * (k + 1) + 3);
          if (live) {
            panel_sums<T, NBT, kInner>(gpart, per, sb);
            for (int e = threadIdx.x; e < kInner * NBT; e += kGridThreads)
              gram[j0 + e / NBT][e % NBT] = sb[e / NBT][e % NBT];
            if (warp == 0) {  // T_b, from the block's own rows of V'V
              T trow[kInner];
              t_rows<T, kInner>(kInner, betas + j0,
                                [&](int cc, int kk) { return sb[kk][j0 + cc]; }, trow);
              if (lane < kInner) {
#pragma unroll
                for (int kk = 0; kk < kInner; ++kk) tb[lane][kk] = trow[kk];
              }
            }
            __syncthreads();
            for (int e = threadIdx.x; e < kInner * NBT; e += kGridThreads) {
              const int r = e / NBT, cc = e % NBT;
              T acc = T(0);
#pragma unroll
              for (int sr = 0; sr < kInner; ++sr) acc += tb[sr][r] * sb[sr][cc];
              mm[r][cc] = acc;
            }
            __syncthreads();
            PQ_MARK(100 * (k + 1) + 4);
            grid_block<T, NBT, true>(a_b, lda, nb, j0, hi, r0, r1, vsc, vdiag, bus, mm,
                                     piv_next, h, s);
            cta_put_h<T, NBT, NBT>(h, 0, warp_part, h_next);
            PQ_MARK(100 * (k + 1) + 5);
          }
        }
      }
      grid.sync();  // step k + 1's partial sums (after the last pass: V'V's last rows) are in
      PQ_MARK(100 * (k + 1) + 9);
    }

    if (live && rank == 0) {
      const int j0 = (nb - 1) / kInner * kInner;  // the last block
      panel_sums<T, NBT, kRows>(gpart, per, sb);
      for (int e = threadIdx.x; e < kRows * NBT; e += kGridThreads)
        if (j0 + e / NBT < nb) gram[j0 + e / NBT][e % NBT] = sb[e / NBT][e % NBT];
      __syncthreads();
      if (warp == 0) {
        T trow[NBT];
        t_rows<T, NBT>(nb, betas, [&](int cc, int kk) { return gram[kk][cc]; }, trow);
        if (lane < nb) {
          T* t_r = t_out + (panel * nb + lane) * nb;
#pragma unroll
          for (int kk = 0; kk < NBT; ++kk)
            if (kk < nb) t_r[kk] = trow[kk];
          beta_out[panel * nb + lane] = betas[lane];
        }
      }
      PQ_MARK(9999);
    }
  }
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

// f(std::integral_constant<int, NBT>) for the narrowest NBT in {4, 8, 16, 32}
// that holds nb columns.
template <typename F>
int by_width(int nb, F&& f) {
  if (nb <= 4) return f(std::integral_constant<int, 4>{});
  if (nb <= 8) return f(std::integral_constant<int, 8>{});
  if (nb <= 16) return f(std::integral_constant<int, 16>{});
  return f(std::integral_constant<int, 32>{});
}

// The grid variant's co-resident CTAs on the current device, its shape for B
// panels of m rows and its workspace elements.
template <typename T, int NBT>
int grid_plan(int64_t B, int64_t m, int* resident, GridShape* shape, int64_t* work_elems) {
  auto kern = panel_qr_grid_kernel<T, NBT>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kGridThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *resident = per_sm * sms;
  *shape = grid_shape(B, m, *resident);
  *work_elems = shape->wave * grid_slot_elems(shape->per);
  return 0;
}

template <typename T, int NBT>
int launch_grid(T* a, int64_t lda, int64_t bstride, T* v, T* beta, T* t, T* work,
                int64_t work_elems, int64_t B, int m, int nb, cudaStream_t stream) {
  int resident = 0;
  GridShape shape;
  int64_t need = 0;
  const int err = grid_plan<T, NBT>(B, m, &resident, &shape, &need);
  if (err != 0) return err;
  if (work == nullptr || work_elems < need || m < nb) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(shape.wave * shape.per));
  cfg.blockDim = dim3(kGridThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto kern = panel_qr_grid_kernel<T, NBT>;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a, lda, bstride, v, beta, t, work, B, m,
                                           nb, shape.per, shape.wave);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(T* a, int64_t lda, int64_t bstride, T* v, T* beta, T* t, T* work,
           int64_t work_elems, int64_t B, int64_t m, int64_t nb, cudaStream_t stream) {
  if (nb < 1 || nb > kMaxNb || m < 1 || m > INT_MAX) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int mi = (int)m, ni = (int)nb;
  if (pq_variant_of(m) == kGrid)
    return by_width(ni, [&](auto w) {
      return launch_grid<T, decltype(w)::value>(a, lda, bstride, v, beta, t, work, work_elems, B,
                                                mi, ni, stream);
    });
  return by_width(ni, [&](auto w) {
    return launch_reg<T, decltype(w)::value>(a, lda, bstride, v, beta, t, B, mi, ni, stream);
  });
}

template <typename T>
int grid_query(int64_t B, int64_t m, int64_t nb, int64_t* out) {
  if (nb < 1 || nb > kMaxNb || m < 1 || m > INT_MAX || B < 1) return (int)cudaErrorInvalidValue;
  return by_width((int)nb, [&](auto w) {
    int resident = 0;
    GridShape shape;
    int64_t work = 0;
    const int err = grid_plan<T, decltype(w)::value>(B, m, &resident, &shape, &work);
    out[0] = resident;
    out[1] = shape.per;
    out[2] = shape.wave;
    out[3] = shape.waves;
    out[4] = work;
    return err;
  });
}

}  // namespace

extern "C" {

// 0 = reg, 1 = cluster, 2 = grid, for an [m, nb] panel.
int pq_variant(int64_t m) { return pq_variant_of(m); }

// The grid variant for B panels [m, nb] of float64 (f64 != 0) or float32 on
// the current device: out = {co-resident CTAs, CTAs per panel, panels per
// wave, waves, workspace elements}. Returns a CUDA error code.
int pq_grid_shape(int64_t B, int64_t m, int64_t nb, int f64, int64_t* out) {
  return f64 ? grid_query<double>(B, m, nb, out) : grid_query<float>(B, m, nb, out);
}

const char* pq_error_name(int err) { return cudaGetErrorName((cudaError_t)err); }

#ifdef PQ_TRACE
int pq_trace_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, pq_trace_buf, sizeof(pq_trace_buf));
}
#endif

// Factor B panels a[b * bstride + i * lda + j] (i < m, j < nb <= 32) in
// place: R over a, V [B, m, nb], beta [B, nb] and T [B, nb, nb] out. The grid
// variant takes `work` (work_elems >= pq_grid_shape's out[4]) for its partial
// sums; the others take none. Returns a CUDA error code, or -1 when no
// cluster of the size the panel needs fits the card.
int pq_wy_launch_f32(float* a, int64_t lda, int64_t bstride, float* v, float* beta, float* t,
                     float* work, int64_t work_elems, int64_t B, int64_t m, int64_t nb,
                     void* stream) {
  return launch<float>(a, lda, bstride, v, beta, t, work, work_elems, B, m, nb,
                       (cudaStream_t)stream);
}

int pq_wy_launch_f64(double* a, int64_t lda, int64_t bstride, double* v, double* beta,
                     double* t, double* work, int64_t work_elems, int64_t B, int64_t m,
                     int64_t nb, void* stream) {
  return launch<double>(a, lda, bstride, v, beta, t, work, work_elems, B, m, nb,
                        (cudaStream_t)stream);
}

}  // extern "C"
