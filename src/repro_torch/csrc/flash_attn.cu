// flash_attn: attention forward in float32 and float64 on Hopper's tensor
// cores (bfloat16 runs in flash_attn_sm90.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/kernel.py:84
// flash_attention_kernel (body _flash_kernel at :40). For q [B, Tq, Hq, hd],
// k and v [B, Tk, Hkv, hd] (GQA: query head h reads KV head h / (Hq / Hkv),
// by index, no copies) and position vectors q_pos [Tq], k_pos [Tk] it
// computes, per query row,
//
//   s    = q . k^T * hd^-1/2                     over the visible keys
//   out  = sum_j exp(s_j - max s) v_j / sum_j exp(s_j - max s)
//
// where key j is visible when k_pos[j] >= 0, and (causal) k_pos[j] <= q_pos,
// and (window) k_pos[j] > q_pos - window. The softmax is the online form of
// the TPU kernel: a running max m, a running sum l and an accumulator, each
// rescaled by exp(m_old - m_new) when a tile raises the max; the output is
// acc / max(l, 1e-30). Masked keys contribute exactly 0 (p = 0, not
// exp(-1e30 - m)), so a row with no visible key comes out as zeros.
//
// What bounds it: operations. At the LM's shapes (Tq = Tk = 4096, hd 128) a
// (batch, KV head) pair does 4.4e9 flops of products on 12 MB of inputs, far
// above the card's balance point, so the products run on the tensor cores:
//
// - float32 as 3xTF32. TF32 keeps 10 of float32's 23 mantissa bits, too few
//   for the 2e-5 check (one pass misses it; tests/test_torch_flash.py
//   emulates both). Each operand x is split into x_hi = cvt.rna.tf32(x) and
//   x_lo = cvt.rna.tf32(x - x_hi) (never the raw float32: the tensor core
//   would truncate its low 13 bits), and lo.hi + hi.lo + hi.hi go into one
//   float32 accumulator, for S = Q.K^T and for O += P.V. The dropped lo.lo
//   term is 2^-22 of the product. Up to hd 128 on wgmma, at hd 256 on
//   mma.sync (m16n8k8).
// - float64 on the FP64 tensor cores (DMMA, mma.sync m16n8k8), one product
//   each, the exponentials by the exact double exp.
//
// The tensor core's float32 accumulation truncates instead of rounding, so
// a sum that takes many products drifts toward zero: on the LM's rows of
// 4,096 keys, P.V summed straight into O (~1.5e3 mma per row) missed the
// 2e-5 check by 3.8x. Each tile's P.V therefore goes into a zeroed
// accumulator and is added to the rescaled O in IEEE arithmetic; S starts
// from zero in every tile.
//
// Design. One block per (batch, KV head, BP query positions of GB query
// heads of its group): the GQA group is folded into the block's R = 16 * NW
// rows (row r is position q0 + r / GB of query head r % GB), so each K/V
// tile is fetched, and in float32 split, once for all GB heads. GB is the
// largest power of two dividing the group (at most R); a larger group takes
// several blocks along grid.y. grid.x walks the position tiles from the
// last (the longest causal rows) first. Each warp owns 16 rows; S and O
// stay in the accumulators. K and V tiles of BK keys arrive by cp.async
// into one padded raw stage: in float32 the next visible tile loads into it
// while the warps compute on the split of the last one; float64 computes
// from the stage and loads the next tile after it.
//
// float32 on wgmma: two warpgroups of 64 rows. Q is split once into TF32 hi
// and lo, and every K/V tile once per block, into shared memory in the
// layout wgmma reads (K-major, 128-byte swizzle): Q and K as they are, V
// transposed. S takes three wgmma (A = Q, B = K) per k-step of 8 columns;
// P goes from S's accumulators into registers as the A operand of P.V (B =
// V^T): the accumulator holds keys 2t, 2t+1 of a row where the A fragment
// wants k = t, t+4, so V^T keeps its keys in that order within each 8.
// float32 on mma.sync (hd 256) splits the tiles into the order its
// fragments are read instead; float64 reads its fragments straight from the
// raw stage (row pitch hd + 4 for K and Q, hd + 2 for V: conflict-free
// 8-byte loads). l is summed from unrounded P.
//
// Masking and skipping. Tiles are taken in order, skipping those in which no
// key can be visible to any row of the block (the keys' positions against
// the block's least and greatest query position; one ballot per 32 keys, a
// window of 32 tiles at a time). Inside a tile the rows that compute
// together (a warp, or on wgmma a warpgroup) skip all work when none of
// them can see a key, and mask key by key only when some key may be hidden
// from some of them; both tests go by position extremes, never row indices.
//
// Tiles per (type, hd), with shared memory in bytes (the Python mirror is
// kernels/flash_attn/kernel.py mma_smem_bytes):
//
//   type    hd  warps  BK  O cols  products  shared memory
//   float   32    8    32    32     wgmma          59,800
//   float   64    8    32    64     wgmma         117,144
//   float  128    8    32   128     wgmma         231,832
//   float  256    4    16   256     mma           165,576
//   double  32    8    64    32     mma            73,480
//   double  64    8    32    64     mma           104,328
//   double 128    8    32   128     mma           202,632
//   double 256    4    16   128     mma           183,240   (O in two column halves)
//
// At double hd 256 a block computes O for 128 of the 256 columns (the O
// accumulator would take 256 registers), so S is formed twice.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSmemLimit = 232448;

// Tile shape of one (type, head dim): kNW warps of 16 rows, kBK keys per
// tile, kHDO output columns per block, and the products on wgmma (kWG,
// float32: two warpgroups) or mma.sync.
template <typename T, int HD>
struct Cfg;
#define FA_CFG(T_, HD_, NW_, BK_, HDO_, WG_)                    \
  template <>                                                   \
  struct Cfg<T_, HD_> {                                         \
    static constexpr int kNW = NW_, kBK = BK_, kHDO = HDO_;     \
    static constexpr bool kWG = WG_;                            \
  };
FA_CFG(float, 32, 8, 32, 32, true)
FA_CFG(float, 64, 8, 32, 64, true)
FA_CFG(float, 128, 8, 32, 128, true)
FA_CFG(float, 256, 4, 16, 256, false)
FA_CFG(double, 32, 8, 64, 32, false)
FA_CFG(double, 64, 8, 32, 64, false)
FA_CFG(double, 128, 8, 32, 128, false)
FA_CFG(double, 256, 4, 16, 128, false)
#undef FA_CFG

template <typename T, int HD>
struct Tile {
  using C = Cfg<T, HD>;
  static constexpr bool kSplit = std::is_same<T, float>::value;
  static constexpr bool kWG = C::kWG && kSplit;
  static constexpr int kNW = C::kNW, kBK = C::kBK, kHDO = C::kHDO;
  static constexpr int kThreads = 32 * kNW;
  static constexpr int kR = 16 * kNW;                          // rows of a block
  static constexpr int kKP = HD + 4;                           // raw K (and Q) row pitch
  static constexpr int kVP = kHDO + (sizeof(T) == 4 ? 4 : 2);  // raw V row pitch
  // wgmma: 1 KiB of alignment slack, then swizzled Q hi and lo [R][HD], K hi
  // and lo [BK][HD] and V^T hi and lo [HD][BK]; mma.sync: K hi/lo and V hi/lo
  // in fragment order.
  static constexpr int kSplitElems = kWG     ? 256 + 2 * kR * HD + 4 * kBK * HD
                                     : kSplit ? 2 * kBK * (HD + kHDO)
                                              : 0;
  static constexpr int kStageElems = kBK * kKP + kBK * kVP;
  static constexpr int kQElems = kWG ? 0 : kR * kKP;
  // key positions of the stage and of the tile computed, ballots, the
  // query position extremes of the block (and of each warpgroup)
  static constexpr int kInts = 3 * kBK + 2 + (kWG ? 4 : 0);
  static constexpr int kSmem =
      (int)sizeof(T) * (kSplitElems + kStageElems + kQElems) + 4 * kInts;
  static_assert(kSmem <= kSmemLimit, "tiles exceed one block's shared memory");
  static_assert(kBK == 16 || kBK == 32 || kBK == 64, "BK is 16, 32 or 64");
  static_assert(kBK <= kThreads && HD % kHDO == 0, "tile shape");
  static_assert(!kWG || (HD <= 128 && kNW == 8 && kBK == 32 && kHDO == HD),
                "wgmma: two warpgroups, 32-key tiles");
};

// -- PTX wrappers ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory; src_bytes < size zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// volatile: the split of Q is the same for every tile, and hoisted out of
// the tile loop its hi and lo parts would not fit the registers.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 of x, both TF32 (round to nearest, ties away).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a.b on one m16n8k8 tile: a fragment (g, t), (g+8, t), (g, t+4),
// (g+8, t+4); b (k t, n g), (k t+4, n g); d (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1) — g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The three products of a split operand pair, the small ones first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float4 b) {
  const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4], double b0,
                                        double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// -- wgmma (float32, hd <= 128) ----------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of a register that an
// asynchronous wgmma reads or writes across the wait.
__device__ __forceinline__ void keep(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// A K-major TF32 operand with the 128-byte swizzle: 32 columns (128 bytes)
// per row of a chunk, `rows` rows per chunk, 8-row atoms of 1,024 bytes whose
// 16-byte units are permuted by unit ^ (row % 8). Byte offset of (row, col):
__device__ __forceinline__ uint32_t swz(int rows, int row, int col) {
  return (uint32_t)((col >> 5) * rows * 128 + row * 128 + ((((col >> 2) & 7) ^ (row & 7)) << 4) +
                    (col & 3) * 4);
}
// Its wgmma descriptor at k-step ks (8 columns, 32 bytes): start address,
// leading byte offset (unused by swizzled K-major layouts), stride byte
// offset 1,024 between 8-row atoms, swizzle mode 1 (128 bytes).
__device__ __forceinline__ uint64_t swz_desc(uint32_t base, int rows, int ks) {
  const uint32_t addr = base + (ks >> 2) * rows * 128 + (ks & 3) * 32;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

#define FA_D4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FA_D16_AT(d, i) FA_D4(d, i), FA_D4(d, i + 4), FA_D4(d, i + 8), FA_D4(d, i + 12)
#define FA_D16(d) FA_D16_AT(d, 0)
#define FA_D32(d) FA_D16_AT(d, 0), FA_D16_AT(d, 16)
#define FA_D64(d) FA_D32(d), FA_D16_AT(d, 32), FA_D16_AT(d, 48)

// wgmma m64nNk8, TF32 in, float32 accumulators, B K-major in shared memory;
// `ss`: A K-major in shared memory, `rs`: A in registers (m16n8k8's
// fragment per warp). Accumulator register i of a thread holds row
// 16 w + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
// of the warpgroup's 64 x N tile (w: its warp in the warpgroup). accumulate
// 0 starts the sum.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da, uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : FA_D16(d)
        : "l"(da), "l"(db), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : FA_D16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : FA_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : FA_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

__device__ __forceinline__ float exp_of(float x) { return __expf(x); }
__device__ __forceinline__ double exp_of(double x) { return exp(x); }

// Built with -DFA_TRACE (tools/flash_mma_trace.py), lane 0 of every warp
// sums the clock cycles its warp spends in each phase of the tile loop and
// adds the sums to fa_trace_cycles at the end: 0 waiting for a stage (and
// the barrier after it; the prologue too), 1 splitting it, 2 the barrier
// after the split, the visible-tile scan and issuing the next stage's
// copies, 3 Q.K^T, 4 the softmax, 5 P.V, 6 the epilogue.
#ifdef FA_TRACE
__device__ unsigned long long fa_trace_cycles[7];
#define FA_MARK(i)                            \
  do {                                        \
    const long long now_ = clock64();         \
    trace_sum[i] += (unsigned long long)(now_ - trace_t); \
    trace_t = now_;                           \
  } while (0)
#else
#define FA_MARK(i) \
  do {             \
  } while (0)
#endif

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* q_pos;
  const int32_t* k_pos;
  void* out;
  int Tq, Tk, Hq, Hkv, causal, has_window, window;
  int gb_log;  // log2 of the query heads folded into one block
};

template <typename T, int HD>
__global__ void __launch_bounds__(Tile<T, HD>::kThreads, 1) flash_fwd_mma(const Args a) {
  using L = Tile<T, HD>;
  constexpr int NW = L::kNW, BK = L::kBK, HDO = L::kHDO;
  constexpr int NT = L::kThreads, R = L::kR, KP = L::kKP, VP = L::kVP;
  constexpr int NKS = HD / 8;   // k-steps of Q.K^T
  constexpr int NTK = BK / 8;   // key tiles of S = k-steps of P.V
  constexpr int NDT = HDO / 8;  // column tiles of O
  constexpr bool kSplit = L::kSplit, kWG = L::kWG;
  const T kNeg = T(-1e30);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* split_buf = reinterpret_cast<T*>(smem_raw);      // float32: K hi/lo, then V hi/lo
  T* raw = split_buf + L::kSplitElems;                // the stage: K [BK][KP], V [BK][VP]
  T* Qs = raw + L::kStageElems;                       // Q [R][KP] (mma.sync)
  int* kp_s = reinterpret_cast<int*>(Qs + L::kQElems);  // [BK], the stage's
  int* kp_cur = kp_s + BK;                            // [BK], the tile being computed
  uint32_t* ballots = reinterpret_cast<uint32_t*>(kp_cur + BK);  // [BK]
  int* q_ext = reinterpret_cast<int*>(ballots + BK);  // least, greatest query position
  int* wg_ext = q_ext + 2;                            // the same per warpgroup (wgmma)
  // wgmma operands (swizzled, 1 KiB aligned): Q hi, Q lo, K hi, K lo, V^T hi, V^T lo.
  const uint32_t s_qh = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_ql = s_qh + R * HD * 4, s_kh = s_ql + R * HD * 4;
  const uint32_t s_kl = s_kh + BK * HD * 4, s_vh = s_kl + BK * HD * 4, s_vl = s_vh + BK * HD * 4;
  unsigned char* const qh_p = smem_raw + (s_qh - smem_u32(smem_raw));
  unsigned char* const ql_p = qh_p + (s_ql - s_qh);
  unsigned char* const kh_p = qh_p + (s_kh - s_qh);
  unsigned char* const kl_p = qh_p + (s_kl - s_qh);
  unsigned char* const vh_p = qh_p + (s_vh - s_qh);
  unsigned char* const vl_p = qh_p + (s_vl - s_qh);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Tq = a.Tq, Tk = a.Tk, causal = a.causal, has_window = a.has_window,
            window = a.window;
  const int GB = 1 << a.gb_log, BP = R >> a.gb_log;
  const int G = a.Hq / a.Hkv, n_gc = G >> a.gb_log, n_oc = HD / HDO;
  const int nq = (Tq + BP - 1) / BP;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BP;  // the longest rows first
  int y = blockIdx.y;
  const int oc = y % n_oc;
  y /= n_oc;
  const int jc = y % n_gc;
  y /= n_gc;
  const int hk = y % a.Hkv, b = y / a.Hkv;
  const int h0 = hk * G + jc * GB;  // first query head of the block
  const int d0 = oc * HDO;          // first output column of the block
  const int64_t q_step = (int64_t)a.Hq * HD, kv_step = (int64_t)a.Hkv * HD;
  const T* q_b = static_cast<const T*>(a.q) + ((int64_t)b * Tq * a.Hq + h0) * HD;
  const T* k_b = static_cast<const T*>(a.k) + ((int64_t)b * Tk * a.Hkv + hk) * HD;
  const T* v_b = static_cast<const T*>(a.v) + ((int64_t)b * Tk * a.Hkv + hk) * HD + d0;
  T* o_b = static_cast<T*>(a.out) + ((int64_t)b * Tq * a.Hq + h0) * HD + d0;

  // The query rows this thread holds: row rw + g + 8 h of its warp.
  const int rw = warp * 16;
  int qp[2];
  bool q_ok[2];
  int64_t q_off[2];  // element offset of the row in q (and out)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw + g + 8 * h;
    const int p = q0 + (r >> a.gb_log);
    q_ok[h] = p < Tq;
    q_off[h] = (int64_t)p * q_step + (int64_t)(r & (GB - 1)) * HD;
    qp[h] = q_ok[h] ? a.q_pos[p] : 0;
  }
  // The warp's least and greatest query position (over rows that exist).
  const int qmin_w = __reduce_min_sync(
      0xffffffffu, min(q_ok[0] ? qp[0] : INT_MAX, q_ok[1] ? qp[1] : INT_MAX));
  const int qmax_w = __reduce_max_sync(
      0xffffffffu, max(q_ok[0] ? qp[0] : INT_MIN, q_ok[1] ? qp[1] : INT_MIN));
  if (tid == 0) {
    q_ext[0] = INT_MAX;
    q_ext[1] = INT_MIN;
    if constexpr (kWG) {
      wg_ext[0] = wg_ext[2] = INT_MAX;
      wg_ext[1] = wg_ext[3] = INT_MIN;
    }
  }

  // Q: split into shared memory (wgmma), or the rows in shared memory (by
  // cp.async, zeros past Tq).
  if constexpr (kWG) {
    // Split once into swizzled hi and lo, the A operand of every tile's
    // Q.K^T; a thread takes four columns of one row, rows across the lanes.
#pragma unroll
    for (int i = 0; i < R * HD / 4 / NT; ++i) {
      const int e = tid + i * NT, r = e % R, c = 4 * (e / R);
      const int p = q0 + (r >> a.gb_log);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p < Tq)
        x = *reinterpret_cast<const float4*>(q_b + (int64_t)p * q_step +
                                             (int64_t)(r & (GB - 1)) * HD + c);
      uint32_t hi[4], lo[4];
      split_tf32(x.x, hi[0], lo[0]);
      split_tf32(x.y, hi[1], lo[1]);
      split_tf32(x.z, hi[2], lo[2]);
      split_tf32(x.w, hi[3], lo[3]);
      const uint32_t off = swz(R, r, c);
      *reinterpret_cast<uint4*>(qh_p + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(ql_p + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    fence_async_smem();
  } else {
    constexpr int CH = HD * (int)sizeof(T) / 16;  // 16-byte chunks per row
    for (int e = tid; e < R * CH; e += NT) {
      const int r = e / CH, c = e % CH;
      const int p = q0 + (r >> a.gb_log);
      const bool in = p < Tq;
      const T* src = in ? q_b + (int64_t)p * q_step + (int64_t)(r & (GB - 1)) * HD : q_b;
      cp_async16(Qs + r * KP + c * (16 / (int)sizeof(T)), src + c * (16 / (int)sizeof(T)),
                 in ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  if (lane == 0 && qmin_w <= qmax_w) {
    atomicMin(&q_ext[0], qmin_w);
    atomicMax(&q_ext[1], qmax_w);
    if constexpr (kWG) {
      atomicMin(&wg_ext[2 * (warp >> 2)], qmin_w);
      atomicMax(&wg_ext[2 * (warp >> 2) + 1], qmax_w);
    }
  }
  __syncthreads();
  const int q_min = q_ext[0], q_max = q_ext[1];
  // The rows that compute together, their least and greatest position: the
  // warp (mma.sync) or its warpgroup (wgmma, which the four warps issue
  // together).
  const int qmin_c = kWG ? wg_ext[2 * (warp >> 2)] : qmin_w;
  const int qmax_c = kWG ? wg_ext[2 * (warp >> 2) + 1] : qmax_w;
  const bool live_c = qmin_c <= qmax_c;

  // Visible-tile scan: bit i of `wmask` says whether tile wbase + i holds a
  // key that may be visible to some row of the block.
  const int ntk = (Tk + BK - 1) / BK;
  int wbase = -64;
  uint32_t wmask = 0;
  auto scan_window = [&](int base) {
    for (int w = warp; w < BK; w += NW) {  // 32 * BK keys, one ballot per 32
      const int key = base * BK + w * 32 + lane;
      const int kp = key < Tk ? a.k_pos[key] : -1;
      const bool maybe = kp >= 0 && (!causal || kp <= q_max) &&
                         (!has_window || kp > q_min - window);
      const uint32_t bits = __ballot_sync(0xffffffffu, maybe);
      if (lane == 0) ballots[w] = bits;
    }
    __syncthreads();
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      bool any;
      if constexpr (BK >= 32) {
        any = false;
#pragma unroll
        for (int w = 0; w < BK / 32; ++w) any |= ballots[i * (BK / 32) + w] != 0u;
      } else {
        any = ((ballots[i >> 1] >> (16 * (i & 1))) & 0xffffu) != 0u;
      }
      m |= (any ? 1u : 0u) << i;
    }
    __syncthreads();  // before the ballots are written again
    wbase = base;
    wmask = m;
  };
  auto next_tile = [&](int j) {  // the first tile >= j that may be visible
    while (j < ntk) {
      if (j < wbase || j >= wbase + 32) scan_window(j);
      const uint32_t rest = wmask >> (j - wbase);
      if (rest) return j + __ffs(rest) - 1;
      j = wbase + 32;
    }
    return ntk;
  };

  // One K/V tile (and its key positions) into the raw stage by cp.async.
  // The loops run a fixed count per thread (unrolled, every copy in flight).
  auto load_tile = [&](int j) {
    T* Kr = raw;
    T* Vr = Kr + BK * KP;
    const int k0 = j * BK;
    constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
    constexpr int KCH = HD / EPC, VCH = HDO / EPC;
#pragma unroll
    for (int i = 0; i < (BK * KCH + NT - 1) / NT; ++i) {
      const int e = tid + i * NT, r = e / KCH, c = e % KCH;
      const bool in = k0 + r < Tk;
      if (e < BK * KCH)
        cp_async16(Kr + r * KP + c * EPC,
                   (in ? k_b + (int64_t)(k0 + r) * kv_step : k_b) + c * EPC, in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < (BK * VCH + NT - 1) / NT; ++i) {
      const int e = tid + i * NT, r = e / VCH, c = e % VCH;
      const bool in = k0 + r < Tk;
      if (e < BK * VCH)
        cp_async16(Vr + r * VP + c * EPC,
                   (in ? v_b + (int64_t)(k0 + r) * kv_step : v_b) + c * EPC, in ? 16 : 0);
    }
    if (tid < BK) {
      const bool in = k0 + tid < Tk;
      cp_async4(kp_s + tid, a.k_pos + (in ? k0 + tid : 0), in ? 4 : 0);
    }
  };

  // float32: split the raw stage into hi/lo in fragment order. K entry
  // (ks, nt, lane) holds K[nt*8+g][ks*8+t], K[..][ks*8+t+4] as hi, hi, lo,
  // lo; V entry (kk, dt, lane) holds V[kk*8+2t][dt*8+g], V[kk*8+2t+1][dt*8+g].
  // The key positions go along.
  auto split_tile = [&]() {
    if constexpr (kWG) {
      // Swizzled K hi/lo [key][hd] and V^T hi/lo [hd][key], the keys of V^T
      // in P's order within each group of 8 (2t at t, 2t + 1 at t + 4). A
      // thread takes four columns of one key, the keys across the lanes (no
      // bank conflicts on either side).
      const float* Kr = reinterpret_cast<const float*>(raw);
      const float* Vr = Kr + BK * KP;
#pragma unroll
      for (int i = 0; i < BK * HD / 4 / NT; ++i) {
        const int e = tid + i * NT, r = e % BK, c = 4 * (e / BK);
        const float4 kx = *reinterpret_cast<const float4*>(Kr + r * KP + c);
        const float4 vx = *reinterpret_cast<const float4*>(Vr + r * VP + c);
        uint32_t kh[4], kl[4], vh[4], vl[4];
        split_tf32(kx.x, kh[0], kl[0]);
        split_tf32(kx.y, kh[1], kl[1]);
        split_tf32(kx.z, kh[2], kl[2]);
        split_tf32(kx.w, kh[3], kl[3]);
        split_tf32(vx.x, vh[0], vl[0]);
        split_tf32(vx.y, vh[1], vl[1]);
        split_tf32(vx.z, vh[2], vl[2]);
        split_tf32(vx.w, vh[3], vl[3]);
        const uint32_t ko = swz(BK, r, c);
        *reinterpret_cast<uint4*>(kh_p + ko) = make_uint4(kh[0], kh[1], kh[2], kh[3]);
        *reinterpret_cast<uint4*>(kl_p + ko) = make_uint4(kl[0], kl[1], kl[2], kl[3]);
        const int pos = (r & ~7) + ((r & 7) >> 1) + 4 * (r & 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t vo = swz(HD, c + j, pos);
          *reinterpret_cast<uint32_t*>(vh_p + vo) = vh[j];
          *reinterpret_cast<uint32_t*>(vl_p + vo) = vl[j];
        }
      }
      fence_async_smem();
    } else if constexpr (kSplit) {
      static_assert(BK * HD / 2 % NT == 0 && BK * HDO / 2 % NT == 0, "whole split rounds");
      const float* Kr = reinterpret_cast<const float*>(raw);
      const float* Vr = Kr + BK * KP;
      float4* Ksp = reinterpret_cast<float4*>(split_buf);
      float4* Vsp = Ksp + BK * HD / 2;
#pragma unroll
      for (int i = 0; i < BK * HD / 2 / NT; ++i) {
        const int e = tid + i * NT, l = e & 31, f = e >> 5, nt = f % NTK, ks = f / NTK;
        const float* src = Kr + (nt * 8 + (l >> 2)) * KP + ks * 8 + (l & 3);
        uint32_t h0, l0, h1, l1;
        split_tf32(src[0], h0, l0);
        split_tf32(src[4], h1, l1);
        Ksp[e] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                             __uint_as_float(l1));
      }
#pragma unroll
      for (int i = 0; i < BK * HDO / 2 / NT; ++i) {
        const int e = tid + i * NT, l = e & 31, f = e >> 5, dt = f % NDT, kk = f / NDT;
        const float* src = Vr + (kk * 8 + 2 * (l & 3)) * VP + dt * 8 + (l >> 2);
        uint32_t h0, l0, h1, l1;
        split_tf32(src[0], h0, l0);
        split_tf32(src[VP], h1, l1);
        Vsp[e] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                             __uint_as_float(l1));
      }
    }
    if (tid < BK) kp_cur[tid] = kp_s[tid];
  };

#ifdef FA_TRACE
  unsigned long long trace_sum[7] = {};
  long long trace_t = clock64();
#endif
  T m_i[2] = {kNeg, kNeg}, l_i[2] = {T(0), T(0)};
  T o[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = T(0);

  // One tile: S = Q.K^T, the online softmax, O += P.V, for this warp's rows.
  // Kr/Vr: the raw stage (float64); sb: the split buffer (float32); kp: the
  // tile's key positions.
  auto compute = [&](int j, const T* Kr, const T* Vr, const int* kp, const T* sb) {
    const int k0 = j * BK;
    // The tile's keys against the warp's rows: any visible, all visible.
    int kmin = INT_MAX, kmax = INT_MIN;
    bool all_valid = true;
#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += 32) {
      if (c0 + lane < BK) {
        const int kpc = kp[c0 + lane];
        const bool valid = k0 + c0 + lane < Tk && kpc >= 0;
        all_valid &= valid;
        if (valid) {
          kmin = min(kmin, kpc);
          kmax = max(kmax, kpc);
        }
      }
    }
    kmin = __reduce_min_sync(0xffffffffu, kmin);
    kmax = __reduce_max_sync(0xffffffffu, kmax);
    all_valid = __all_sync(0xffffffffu, all_valid);
    const bool any = live_c && kmin <= kmax && (!causal || kmin <= qmax_c) &&
                     (!has_window || kmax > qmin_c - window);
    if (!any) {
      FA_MARK(3);
      return;
    }
    const bool full = all_valid && (!causal || kmax <= qmin_c) &&
                      (!has_window || kmin > qmax_c - window);

    T s[NTK][4];
    if constexpr (kWG) {
      // S for the warpgroup's 64 rows: three wgmma per k-step, all issued
      // before one wait, even and odd k-steps into two accumulators (two
      // chains in flight, each half as long), summed at the end.
      float acc[2][16];
      const uint32_t qrow = (warp >> 2) * 64 * 128;  // the warpgroup's rows of Q
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        const uint64_t qh = swz_desc(s_qh + qrow, R, ks), ql = swz_desc(s_ql + qrow, R, ks);
        const uint64_t kh = swz_desc(s_kh, BK, ks), kl = swz_desc(s_kl, BK, ks);
        Wgmma<32>::ss(acc[ks & 1], ql, kh, ks > 1);
        Wgmma<32>::ss(acc[ks & 1], qh, kl, 1);
        Wgmma<32>::ss(acc[ks & 1], qh, kh, 1);
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        keep(acc[0][i]);
        keep(acc[1][i]);
        s[i >> 2][i & 3] = acc[0][i] + acc[1][i];
      }
    } else {
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = T(0);
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      T qa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = Qs[(rw + g + 8 * (i & 1)) * KP + ks * 8 + t + 4 * (i >> 1)];
      if constexpr (kSplit) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(qa[i], ah[i], al[i]);
        const float4* Ksp = reinterpret_cast<const float4*>(sb) + ks * NTK * 32 + lane;
#pragma unroll
        for (int nt = 0; nt < NTK; ++nt) mma_3xtf32(s[nt], ah, al, Ksp[nt * 32]);
      } else {
#pragma unroll
        for (int nt = 0; nt < NTK; ++nt) {
          const T* kr = Kr + (nt * 8 + g) * KP + ks * 8 + t;
          mma_f64(s[nt], qa, kr[0], kr[4]);
        }
      }
    }
    }
    FA_MARK(3);

    const T scale = T(1.0 / sqrt((double)HD));  // as the TPU kernel: a double, then T's
    T corr_h[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t ok = 0xffffffffu;
      if (!full) {
        ok = 0;
#pragma unroll
        for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = nt * 8 + 2 * t + e;
            const int kpc = kp[c];
            const bool vis = k0 + c < Tk && kpc >= 0 && (!causal || kpc <= qp[h]) &&
                             (!has_window || kpc > qp[h] - window);
            ok |= (vis ? 1u : 0u) << (2 * nt + e);
          }
      }
      T mx = m_i[h];
#pragma unroll
      for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          T& x = s[nt][2 * h + e];
          x = (ok >> (2 * nt + e)) & 1u ? x * scale : kNeg;
          mx = x > mx ? x : mx;
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the four lanes of this row
        const T other = __shfl_xor_sync(0xffffffffu, mx, off);
        mx = other > mx ? other : mx;
      }
      const T corr = exp_of(m_i[h] - mx);
      T psum = T(0);
#pragma unroll
      for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          T& x = s[nt][2 * h + e];
          x = (ok >> (2 * nt + e)) & 1u ? exp_of(x - mx) : T(0);
          psum += x;
        }
      l_i[h] = l_i[h] * corr + psum;  // this lane's share; the row's sum at the end
      m_i[h] = mx;
      if constexpr (std::is_same<T, float>::value) {
        corr_h[h] = corr;  // applied as P.V is added
      } else {
#pragma unroll
        for (int dt = 0; dt < NDT; ++dt) {
          o[dt][2 * h] *= corr;
          o[dt][2 * h + 1] *= corr;
        }
      }
    }
    FA_MARK(4);

    // O += P.V, key k = t of k-step kk being key kk*8 + 2t, k = t + 4 key
    // kk*8 + 2t + 1; float32: each tile's P.V into a zeroed accumulator,
    // added to the rescaled O (see the note at the top; on mma.sync sixteen
    // output column tiles at a time, to bound the registers).
    if constexpr (kWG) {
      // P.V for the warpgroup: P in registers (hi and lo of all four k-steps
      // live until the wait), V^T from shared memory, into a zeroed
      // accumulator added to the rescaled O.
      uint32_t ph[NTK][4], pl[NTK][4];
#pragma unroll
      for (int kk = 0; kk < NTK; ++kk) {
        split_tf32(s[kk][0], ph[kk][0], pl[kk][0]);
        split_tf32(s[kk][2], ph[kk][1], pl[kk][1]);
        split_tf32(s[kk][1], ph[kk][2], pl[kk][2]);
        split_tf32(s[kk][3], ph[kk][3], pl[kk][3]);
      }
      float pv[NDT * 4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NTK; ++kk) {
        const uint64_t vh = swz_desc(s_vh, HD, kk), vl = swz_desc(s_vl, HD, kk);
        Wgmma<HD>::rs(pv, pl[kk], vh, kk > 0);
        Wgmma<HD>::rs(pv, ph[kk], vl, 1);
        Wgmma<HD>::rs(pv, ph[kk], vh, 1);
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int kk = 0; kk < NTK; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          keep(ph[kk][i]);
          keep(pl[kk][i]);
        }
#pragma unroll
      for (int i = 0; i < NDT * 4; ++i) {
        keep(pv[i]);
        o[i >> 2][i & 3] = o[i >> 2][i & 3] * corr_h[(i >> 1) & 1] + pv[i];
      }
    } else if constexpr (std::is_same<T, float>::value) {
      constexpr int NH = NDT < 16 ? NDT : 16;  // column tiles per pass
#pragma unroll
      for (int d0 = 0; d0 < NDT; d0 += NH) {
        float pv[NH][4];
#pragma unroll
        for (int dt = 0; dt < NH; ++dt)
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[dt][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NTK; ++kk) {
          uint32_t ph[4], pl[4];
          split_tf32(s[kk][0], ph[0], pl[0]);
          split_tf32(s[kk][2], ph[1], pl[1]);
          split_tf32(s[kk][1], ph[2], pl[2]);
          split_tf32(s[kk][3], ph[3], pl[3]);
#pragma unroll
          for (int dt = 0; dt < NH; ++dt)
            mma_3xtf32(pv[dt], ph, pl,
                       reinterpret_cast<const float4*>(sb)[BK * HD / 2 +
                                                           (kk * NDT + d0 + dt) * 32 + lane]);
        }
#pragma unroll
        for (int dt = 0; dt < NH; ++dt)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[d0 + dt][i] = o[d0 + dt][i] * corr_h[i >> 1] + pv[dt][i];
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NTK; ++kk) {
        const T pa[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
        const T* vr = Vr + (kk * 8 + 2 * t) * VP + g;
#pragma unroll
        for (int dt = 0; dt < NDT; ++dt) mma_f64(o[dt], pa, vr[dt * 8], vr[VP + dt * 8]);
      }
    }
    FA_MARK(5);
  };

  int cur = next_tile(0);
  if (cur < ntk) load_tile(cur);
  cp_async_commit();
  while (cur < ntk) {
    cp_async_wait<0>();
    __syncthreads();  // the stage landed (float32: the split buffer is free)
    FA_MARK(0);
    if constexpr (kSplit) {
      split_tile();
      FA_MARK(1);
      __syncthreads();  // the split is visible; the stage is free
      const int nxt = next_tile(cur + 1);
      if (nxt < ntk) load_tile(nxt);
      cp_async_commit();
      FA_MARK(2);
      compute(cur, nullptr, nullptr, kp_cur, split_buf);
      cur = nxt;
    } else {
      const int nxt = next_tile(cur + 1);
      FA_MARK(2);
      compute(cur, raw, raw + BK * KP, kp_s, nullptr);
      __syncthreads();  // every warp is done with the stage
      if (nxt < ntk) load_tile(nxt);
      cp_async_commit();
      FA_MARK(2);
      cur = nxt;
    }
  }
  cp_async_wait<0>();

  // out = O / max(l, 1e-30), l summed over the four lanes of each row.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    T l = l_i[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = l > T(1e-30) ? l : T(1e-30);
    if (!q_ok[h]) continue;
    T* dst = o_b + q_off[h] + 2 * t;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      dst[dt * 8] = o[dt][2 * h] / l;
      dst[dt * 8 + 1] = o[dt][2 * h + 1] / l;
    }
  }
#ifdef FA_TRACE
  FA_MARK(6);
  if (lane == 0)
    for (int i = 0; i < 7; ++i) atomicAdd(&fa_trace_cycles[i], trace_sum[i]);
#endif
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, const int32_t* q_pos,
              const int32_t* k_pos, void* out, int64_t B, int64_t Tq, int64_t Tk, int64_t Hq,
              int64_t Hkv, int causal, int has_window, int64_t window, cudaStream_t stream) {
  using L = Tile<T, HD>;
  constexpr int bytes = L::kSmem;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t G = Hq / Hkv;
  int gb_log = 0;  // the largest power of two dividing G, at most R
  while ((G >> gb_log) % 2 == 0 && (2 << gb_log) <= L::kR) ++gb_log;
  const int64_t bp = L::kR >> gb_log;
  const int64_t gy = B * Hkv * (G >> gb_log) * (HD / L::kHDO);
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((Tq + bp - 1) / bp), (unsigned)gy);
  Args a{q, k, v, q_pos, k_pos, out, (int)Tq, (int)Tk, (int)Hq, (int)Hkv, causal,
         has_window, (int)window, gb_log};
  flash_fwd_mma<T, HD><<<grid, L::kThreads, (size_t)bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_io(int64_t hd, const void* q, const void* k, const void* v, const int32_t* q_pos,
              const int32_t* k_pos, void* out, int64_t B, int64_t Tq, int64_t Tk, int64_t Hq,
              int64_t Hkv, int causal, int has_window, int64_t window, cudaStream_t stream) {
#define FA_CASE(D)                                                                           \
  case D:                                                                                    \
    return launch_hd<T, D>(q, k, v, q_pos, k_pos, out, B, Tq, Tk, Hq, Hkv, causal, has_window, \
                           window, stream);
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

template <typename T>
int smem_of(int64_t hd) {
  switch (hd) {
    case 32:
      return Tile<T, 32>::kSmem;
    case 64:
      return Tile<T, 64>::kSmem;
    case 128:
      return Tile<T, 128>::kSmem;
    case 256:
      return Tile<T, 256>::kSmem;
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 1 float32, 2 float64. q [B, Tq, Hq, hd], k and v
// [B, Tk, Hkv, hd], out like q, all contiguous and 16-byte aligned; q_pos
// [Tq], k_pos [Tk] int32. window is read only when has_window is set; hd is
// 32, 64, 128 or 256. Returns a CUDA error code.
int fa_launch(int dtype, const void* q, const void* k, const void* v, const int32_t* q_pos,
              const int32_t* k_pos, void* out, int64_t B, int64_t Tq, int64_t Tk, int64_t Hq,
              int64_t Hkv, int64_t hd, int causal, int has_window, int64_t window,
              void* stream) {
  if (B == 0 || Tq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 1:
      return launch_io<float>(hd, q, k, v, q_pos, k_pos, out, B, Tq, Tk, Hq, Hkv, causal,
                              has_window, window, s);
    case 2:
      return launch_io<double>(hd, q, k, v, q_pos, k_pos, out, B, Tq, Tk, Hq, Hkv, causal,
                               has_window, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#ifdef FA_TRACE
// The phase sums since the last call (tools/flash_mma_trace.py), then zeroed.
int fa_trace_take(unsigned long long* host7) {
  cudaError_t err = cudaMemcpyFromSymbol(host7, fa_trace_cycles, 7 * sizeof(unsigned long long));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zeros[7] = {};
  return (int)cudaMemcpyToSymbol(fa_trace_cycles, zeros, sizeof(zeros));
}
#endif

// Shared memory one block takes for (dtype, hd), as above; -1 if none.
int fa_smem_bytes(int dtype, int64_t hd) {
  return dtype == 1 ? smem_of<float>(hd) : dtype == 2 ? smem_of<double>(hd) : -1;
}

}  // extern "C"
