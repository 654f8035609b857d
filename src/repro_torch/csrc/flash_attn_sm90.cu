// flash_attn_sm90: bfloat16 attention forward on Hopper's tensor cores.
//
// Replaces, for bfloat16 inputs, the TPU kernel
// src/repro/kernels/flash_attn/kernel.py:84 flash_attention_kernel (body
// _flash_kernel at :40); float32 and float64 stay on flash_attn.cu. It
// computes what flash_attn.cu computes: for q [B, Tq, Hq, hd], k and v
// [B, Tk, Hkv, hd] (GQA: query head h reads KV head h / (Hq / Hkv), by index,
// no copies) and position vectors q_pos [Tq], k_pos [Tk], per query row
//
//   s    = q . k^T * hd^-1/2                     over the visible keys
//   out  = sum_j exp(s_j - max s) v_j / sum_j exp(s_j - max s)
//
// where key j is visible when k_pos[j] >= 0, and (causal) k_pos[j] <= q_pos,
// and (window) k_pos[j] > q_pos - window. Softmax and accumulation are in
// float32 (online: running max m, running sum l, both rescaled when a tile
// raises the max), a masked key contributes exactly 0, a row with no visible
// key comes out as zeros, and the output acc / max(l, 1e-30) is rounded once
// to bfloat16.
//
// What bounds it: operations. At the LM's shapes (Tq = Tk = 4096, hd 128) a
// (batch, head) pair does 2.2e9 flops of products on 4 MB of inputs, far
// above the card's balance point, so the products have to run on the tensor
// cores (wgmma), fed without stalls (TMA into a ring of shared-memory stages).
//
// Design. One block per (batch, query head, BQ = 128 query rows), grid.y
// walking the query blocks from the last (the longest causal rows) first.
// 384 threads: two consumer warpgroups of 64 query rows each (the wgmma M)
// and one producer warpgroup, of which one warp starts the TMA loads;
// setmaxnreg moves registers from the producer (40 a thread) to the
// consumers (232). Q reaches shared memory once, K and V tiles [BK, hd]
// through a ring of kStages stages with a "full" and an "empty" mbarrier
// each, all by TMA (4-d tensor maps over [B, T, H, hd], encoded on the host
// per call, passed as __grid_constant__ parameters), into tiles swizzled
// like wgmma reads them: rows of 128 bytes (64 bytes for hd 32) in 8-row
// atoms, hd split into column chunks of that width. TMA fills rows past T
// with zeros; the masks still come from the positions.
//
// Per KV tile each consumer warpgroup computes S = Q.K^T with wgmma from
// shared memory (both operands K-major, float32 accumulators in registers),
// the softmax in registers (row max and row sum over the four lanes that
// share an accumulator row; the hardware's exp2 with the scale times
// log2(e) folded in), then O += P.V with wgmma taking P from registers and
// V's tile as the B operand in its natural [key, hd] layout (MN-major, the
// transposed form).
//
// Why P is split. wgmma takes bfloat16 operands, and P rounded once to
// bfloat16 loses up to 2^-9 of each weight: on the short rows at the top of a
// causal triangle a few weights of order 0.3 carry the output, and the error
// reaches 16 times the check's one-bfloat16-step bound (emulated in
// tests/test_torch_flash.py). So P = P_hi + P_lo, both bfloat16 (P_lo the
// rounding residue of P_hi), and two wgmma products go into the one float32
// accumulator: P.V then agrees with float32 P to about 2^-16 relative, at
// 1.5 times the tensor work of the unsplit kernel. l is summed from float32 P.
//
// Masking and skipping. A tile in which no key can be visible to any row of
// the block (tested key by key against the block's least and greatest query
// position, as flash_attn.cu does) is skipped by producer and consumers
// alike. A warpgroup masks a tile only when some key of it may be hidden from
// some of its rows: a padded or out-of-range key, or a key past its least
// query position (causal) or at or before its greatest query position minus
// the window. Both tests use position extremes, never row indices, so any
// position vectors stay correct.
//
// Tiles, with shared memory (1 KB alignment slack, Q, two K/V stages and
// the barriers; the Python mirror is kernels/flash_attn/kernel.py
// sm90_smem_bytes):
//
//   hd    BQ   BK   swizzle   shared memory
//   32    128  128  64 B       42,048
//   64    128  128  128 B      83,008
//   128   128  128  128 B     164,928
//   256   128   64  128 B     197,696   (BK 64: O is 128 registers a thread)
//
// A wait on an mbarrier that lasts ~10 s traps, so a protocol fault ends the
// launch with an error instead of hanging the card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStages = 2;
constexpr int kConsumers = 2;  // consumer warpgroups, 64 query rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kSmemLimit = 232448;
constexpr long long kHangCycles = 20000000000LL;

template <int HD>
struct Tile {
  static constexpr int kBQ = 64 * kConsumers;
  static constexpr int kBK = HD == 256 ? 64 : 128;
  static constexpr int kSW = HD * 2 < 128 ? HD * 2 : 128;  // swizzled row, bytes
  static constexpr int kCW = kSW / 2;                      // bf16 columns per chunk
  static constexpr int kNC = HD / kCW;                     // column chunks
  static constexpr uint64_t kLayout = kSW == 128 ? 1 : 2;  // wgmma: 128 B / 64 B swizzle
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = kBK * HD * 2;  // one of K or V, one stage
  static constexpr int kSmem = 1024 + kQBytes + kStages * 2 * kKVBytes + 64;
  static_assert(kSmem <= kSmemLimit, "tiles exceed one block's shared memory");
  static_assert(8 * (1 + 2 * kStages) <= 64, "barriers exceed their slot");
};

// -- PTX wrappers ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) {
      start = clock64();
    } else if ((spin & 1023) == 0 && clock64() - start > kHangCycles) {
      __trap();
    }
  }
}

// One TMA tile load of a 4-d tensor map into shared memory, completing on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of a register that an
// asynchronous wgmma reads or writes across the wait.
__device__ __forceinline__ void keep(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand (Q or K): ``rows`` rows per column chunk from ``base``; the
// 16 columns of k-step ``kk`` sit 32 bytes apart inside a swizzled row, and
// 8-row atoms are 8 rows apart.
template <int HD>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int rows, int kk) {
  using C = Tile<HD>;
  constexpr int steps = C::kCW / 16;  // k-steps per column chunk
  const uint32_t addr = base + (kk / steps) * rows * C::kSW + (kk % steps) * 32;
  return make_desc(addr, 16, 8 * C::kSW, C::kLayout);
}

// V as an MN-major B operand: keys 16 kk .. 16 kk + 15 of the stage at
// ``base``; 8-key atoms are SBO apart, column chunks (64 or 32 hd values) LBO.
template <int HD>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int kk) {
  using C = Tile<HD>;
  return make_desc(base + kk * 16 * C::kSW, C::kBK * C::kSW, 8 * C::kSW, C::kLayout);
}

#define FA_D4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FA_D16_AT(d, i) FA_D4(d, i), FA_D4(d, i + 4), FA_D4(d, i + 8), FA_D4(d, i + 12)
#define FA_D16(d) FA_D16_AT(d, 0)
#define FA_D32(d) FA_D16_AT(d, 0), FA_D16_AT(d, 16)
#define FA_D64(d) FA_D32(d), FA_D16_AT(d, 32), FA_D16_AT(d, 48)
#define FA_D128(d)                                                                      \
  FA_D64(d), FA_D16_AT(d, 64), FA_D16_AT(d, 80), FA_D16_AT(d, 96), FA_D16_AT(d, 112)

// wgmma m64nNk16, bfloat16 in, float32 accumulators: ``ss`` reads A and B from
// shared memory (both K-major), ``rs`` takes A from registers and B MN-major.
// Accumulator register i of a thread holds row 16 w + lane / 4 + 8 ((i / 2) % 2)
// and column 8 (i / 4) + 2 (lane % 4) + i % 2 of the warpgroup's 64 x N tile
// (w: the thread's warp in the warpgroup).
template <int N>
struct Mma;

template <>
struct Mma<32> {
  // D[64 x 32] (+)= A[64 x 16] . B[16 x 32]; A in registers, B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : FA_D16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <>
struct Mma<64> {
  // D[64 x 64] (+)= A[64 x 16] . B[16 x 64]; A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : FA_D32(d)
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // D[64 x 64] (+)= A[64 x 16] . B[16 x 64]; A in registers, B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : FA_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <>
struct Mma<128> {
  // D[64 x 128] (+)= A[64 x 16] . B[16 x 128]; A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : FA_D64(d)
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // D[64 x 128] (+)= A[64 x 16] . B[16 x 128]; A in registers, B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : FA_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <>
struct Mma<256> {
  // D[64 x 256] (+)= A[64 x 16] . B[16 x 256]; A in registers, B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : FA_D128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

// 2^x by the hardware's approximation (MUFU.EX2: relative error near 2^-22,
// results below 2^-126 flushed to 0, 2^-inf = 0), for the softmax.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- the kernel -------------------------------------------------------------------

__device__ __forceinline__ bool visible(int kp, int qp, int causal, int has_window,
                                        int window) {
  return kp >= 0 && (!causal || kp <= qp) &&
         (!has_window || (long long)kp > (long long)qp - window);
}

// The least and greatest position of query rows [lo, lo + n) below Tq, reduced
// over the warp (INT_MAX and INT_MIN when there is none).
__device__ __forceinline__ void q_extremes(const int32_t* __restrict__ q_pos, int lo, int n,
                                           int Tq, int lane, int& q_min, int& q_max) {
  q_min = INT_MAX;
  q_max = INT_MIN;
  for (int r = lane; r < n; r += 32) {
    if (lo + r < Tq) {
      const int p = __ldg(q_pos + lo + r);
      q_min = min(q_min, p);
      q_max = max(q_max, p);
    }
  }
  q_min = __reduce_min_sync(0xffffffffu, q_min);
  q_max = __reduce_max_sync(0xffffffffu, q_max);
}

// P = hi + lo for two neighbouring weights, both parts packed as bfloat16x2
// (low half: the lower column).
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h2);
  const __nv_bfloat162 l2 = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = *reinterpret_cast<const uint32_t*>(&l2);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const int32_t* __restrict__ q_pos,
                   const int32_t* __restrict__ k_pos, __nv_bfloat16* __restrict__ out, int Tq,
                   int Tk, int Hq, int Hkv, int causal, int has_window, int window,
                   float scale_log2) {
  using C = Tile<HD>;
  constexpr int BQ = C::kBQ, BK = C::kBK, SW = C::kSW;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_kv = s_q + C::kQBytes;  // stage s: K at + 2 s kKVBytes, V after it
  const uint32_t s_bar = s_kv + kStages * 2 * C::kKVBytes;
  // barriers: Q arrived at s_bar, stage s full at full(s), empty at empty(s)
  auto full = [&](int s) -> uint32_t { return s_bar + 8u * (1 + s); };
  auto empty = [&](int s) -> uint32_t { return s_bar + 8u * (1 + kStages + s); };

  const int tid = threadIdx.x, lane = tid & 31;
  const int nq = (Tq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;  // the longest causal rows first
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int nk = (Tk + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(s_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // Every warp computes the block's query extremes itself, so the producer
  // and the consumers skip the same tiles without another barrier.
  int q_min, q_max;
  q_extremes(q_pos, q0, BQ, Tq, lane, q_min, q_max);

  if (tid >= 128 * kConsumers) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid >= 128 * kConsumers + 32) return;  // one warp starts the loads
    if (lane == 0) {
      mbar_expect_tx(s_bar, C::kQBytes);
      for (int c = 0; c < C::kNC; ++c)
        tma_load(s_q + c * BQ * SW, &map_q, s_bar, c * C::kCW, h, q0, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * BK;
      bool maybe = false;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int t = k0 + lane + 32 * j;
        const int kp = t < Tk ? __ldg(k_pos + t) : -1;
        maybe |= kp >= 0 && (!causal || kp <= q_max) &&
                 (!has_window || (long long)kp > (long long)q_min - window);
      }
      if (!__any_sync(0xffffffffu, maybe)) continue;
      if (lane == 0) {
        mbar_wait(empty(stage), phase ^ 1u);
        mbar_expect_tx(full(stage), 2 * C::kKVBytes);
        const uint32_t s_k = s_kv + stage * 2 * C::kKVBytes, s_v = s_k + C::kKVBytes;
        for (int c = 0; c < C::kNC; ++c) {
          tma_load(s_k + c * BK * SW, &map_k, full(stage), c * C::kCW, hk, k0, b);
          tma_load(s_v + c * BK * SW, &map_v, full(stage), c * C::kCW, hk, k0, b);
        }
      }
      __syncwarp();
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    return;
  }

  // -- a consumer warpgroup: query rows q0 + 64 wg .. q0 + 64 wg + 63 --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int t0 = q0 + 64 * wg + 16 * warp + (lane >> 2), t1 = t0 + 8;  // this thread's rows
  const int qp0 = t0 < Tq ? __ldg(q_pos + t0) : 0, qp1 = t1 < Tq ? __ldg(q_pos + t1) : 0;
  int g_min, g_max;  // the warpgroup's query extremes
  q_extremes(q_pos, q0 + 64 * wg, 64, Tq, lane, g_min, g_max);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's share
  const uint32_t q_base = s_q + 64 * wg * SW;

  mbar_wait(s_bar, 0);
  __syncwarp();
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    bool maybe = false, all = true;
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      const int t = k0 + lane + 32 * j;
      const int kp = t < Tk ? __ldg(k_pos + t) : -1;
      maybe |= kp >= 0 && (!causal || kp <= q_max) &&
               (!has_window || (long long)kp > (long long)q_min - window);
      all &= kp >= 0 && (!causal || kp <= g_min) &&
             (!has_window || (long long)kp > (long long)g_max - window);
    }
    if (!__any_sync(0xffffffffu, maybe)) continue;  // as the producer decides
    const bool need_mask = !__all_sync(0xffffffffu, all);
    mbar_wait(full(stage), phase);
    __syncwarp();
    const uint32_t s_k = s_kv + stage * 2 * C::kKVBytes, s_v = s_k + C::kKVBytes;

    // S = Q . K^T
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      Mma<BK>::ss(s, kmajor_desc<HD>(q_base, BQ, kk), kmajor_desc<HD>(s_k, BK, kk), 1);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) keep(s[i]);

    if (need_mask) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = k0 + 8 * j + 2 * (lane & 3) + e;
          const int kp = t < Tk ? __ldg(k_pos + t) : -1;
          if (!visible(kp, qp0, causal, has_window, window)) s[4 * j + e] = -INFINITY;
          if (!visible(kp, qp1, causal, has_window, window)) s[4 * j + 2 + e] = -INFINITY;
        }
      }
    }

    // online softmax, rows t0 (registers 4j, 4j+1) and t1 (4j+2, 4j+3)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the four lanes of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float base0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
    const float corr0 = exp2_approx(m0 * scale_log2 - base0);
    const float corr1 = exp2_approx(m1 * scale_log2 - base1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], scale_log2, -base0));
        s[4 * j + 2 + e] = exp2_approx(fmaf(s[4 * j + 2 + e], scale_log2, -base1));
        sum0 += s[4 * j + e];
        sum1 += s[4 * j + 2 + e];
      }
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }

    // P as wgmma A fragments: k-step kk takes accumulator registers
    // 8 kk .. 8 kk + 7 in pairs, hi and lo parts apart.
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_pair(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], p_hi[kk][r], p_lo[kk][r]);

    // O += P_hi . V + P_lo . V
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) keep(o[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = mnmajor_desc<HD>(s_v, kk);
      Mma<HD>::rs(o, p_hi[kk], dv, 1);
      Mma<HD>::rs(o, p_lo[kk], dv, 1);
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) keep(o[i]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        keep(p_hi[kk][r]);
        keep(p_lo[kk][r]);
      }
    if (lane == 0) mbar_arrive(empty(stage));
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }

  // epilogue: O / max(l, 1e-30), rounded once to bfloat16
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int64_t row_step = (int64_t)Hq * HD;
  __nv_bfloat16* o_b = out + ((int64_t)b * Tq * Hq + h) * HD + 2 * (lane & 3);
  if (t0 < Tq) {
    __nv_bfloat16* row = o_b + (int64_t)t0 * row_step;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
  }
  if (t1 < Tq) {
    __nv_bfloat16* row = o_b + (int64_t)t1 * row_step;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// -- host side ------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kEncodeError = 10000;  // + the CUresult of the encoding

// A 4-d map over [B, T, H, hd] bfloat16 (innermost first: hd, H, T, B) whose
// box is one column chunk of ``rows`` rows of one head.
template <int HD>
int make_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t T, int64_t H, int rows) {
  using C = Tile<HD>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)(H * HD * 2),
                                 (cuuint64_t)(T * H * HD * 2)};
  const cuuint32_t box[4] = {(cuuint32_t)C::kCW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      C::kSW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const int32_t* q_pos,
              const int32_t* k_pos, void* out, int64_t B, int64_t Tq, int64_t Tk, int64_t Hq,
              int64_t Hkv, int causal, int has_window, int64_t window, cudaStream_t stream) {
  using C = Tile<HD>;
  CUtensorMap mq, mk, mv;
  int err = make_map<HD>(&mq, q, B, Tq, Hq, C::kBQ);
  if (err == 0) err = make_map<HD>(&mk, k, B, Tk, Hkv, C::kBK);
  if (err == 0) err = make_map<HD>(&mv, v, B, Tk, Hkv, C::kBK);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Tq + C::kBQ - 1) / C::kBQ));
  // scale and log2(e), as the scalar kernel's scale: a double, then float
  const float scale_log2 = (float)(1.0 / sqrt((double)HD) * 1.4426950408889634);
  flash_fwd_sm90<HD><<<grid, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, q_pos, k_pos, static_cast<__nv_bfloat16*>(out), (int)Tq, (int)Tk, (int)Hq,
      (int)Hkv, causal, has_window, (int)window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block takes at head dim ``hd`` (-1 for an unsupported hd).
int fa_sm90_smem_bytes(int64_t hd) {
  switch (hd) {
    case 32:
      return Tile<32>::kSmem;
    case 64:
      return Tile<64>::kSmem;
    case 128:
      return Tile<128>::kSmem;
    case 256:
      return Tile<256>::kSmem;
    default:
      return -1;
  }
}

// bfloat16 q [B, Tq, Hq, hd], k and v [B, Tk, Hkv, hd], out like q, all
// contiguous and 16-byte aligned; q_pos [Tq], k_pos [Tk] int32. window is read
// only when has_window is set; hd is 32, 64, 128 or 256. Returns a CUDA error
// code, or 10000 + the CUresult when a tensor map cannot be encoded.
int fa_sm90_launch(const void* q, const void* k, const void* v, const int32_t* q_pos,
                   const int32_t* k_pos, void* out, int64_t B, int64_t Tq, int64_t Tk,
                   int64_t Hq, int64_t Hkv, int64_t hd, int causal, int has_window,
                   int64_t window, void* stream) {
  if (B == 0 || Tq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B * Hq > INT_MAX || (Tq + 127) / 128 > 65535 ||
      Tq > INT_MAX || Tk > INT_MAX || window > INT_MAX || window < INT_MIN)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, (const void*)out})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (Tk == 0)  // no key: every row comes out as zeros
    return (int)cudaMemsetAsync(out, 0, (size_t)(B * Tq * Hq * hd * 2), s);
  switch (hd) {
    case 32:
      return launch_hd<32>(q, k, v, q_pos, k_pos, out, B, Tq, Tk, Hq, Hkv, causal, has_window,
                           window, s);
    case 64:
      return launch_hd<64>(q, k, v, q_pos, k_pos, out, B, Tq, Tk, Hq, Hkv, causal, has_window,
                           window, s);
    case 128:
      return launch_hd<128>(q, k, v, q_pos, k_pos, out, B, Tq, Tk, Hq, Hkv, causal,
                            has_window, window, s);
    case 256:
      return launch_hd<256>(q, k, v, q_pos, k_pos, out, B, Tq, Tk, Hq, Hkv, causal,
                            has_window, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
