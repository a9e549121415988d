// Flash attention forward, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py, flash_attention
// (Pallas): online-softmax attention over q (B, S, H, D) and k/v
// (B, S, KVH, D) with GQA (q head h reads kv head h / (H/KVH), nothing
// repeated), causal / sliding-window / chunked masks with positions equal
// to the row indices, dead tiles skipped by the same block-level liveness
// test, float32 running max, sum and accumulator, a running denominator of
// 0 replaced by 1 (a row with no live key gives 0), scale 1/sqrt(D), output
// cast to the input type. Reads and writes the layers' BSHD layout
// directly, so the wrapper moves no axes. Plain version:
// repro_torch.kernels.flash_attention.ops.flash_attention_plain (the full
// masked softmax in float32).
//
// Bound: at the serving path's prefill (B=1, H=32, KVH=8, S=512, D=128,
//   causal) the function reads q, k, v once and writes out once, 10.5 MB
//   in bf16 (3.1 us at 3.35 TB/s) and 21.0 MB in float32 (6.3 us), and does
//   ~2.15 GFLOP of live causal work: 2.2 us at 989 TFLOP/s dense bf16; in
//   float32 32.1 us on the CUDA cores (67 TFLOP/s) or 13.0 us as the three
//   TF32 products below (3 x 2.15 GFLOP at 495 TFLOP/s dense TF32). In
//   bf16 what sets the time instead is latency: the block that owns the
//   last causal q tile walks 8 kv tiles one after another (Q K^T, softmax,
//   P V, each step waiting on the one before), after the loads' first trip
//   to device memory. The softmax's exponentials (4096 a tile, 16 a clock
//   on an SM) are the longest span of a step.
//
// Two kernels, picked by dtype, in one skeleton: one block owns one 64-row
//   q tile of one head. One thread sets up the mbarriers and brings the q
//   tile and every live K/V tile by TMA (cp.async.bulk.tensor, 128-byte
//   swizzle, from tensor maps over the BSHD tensors seen as (B*S rows,
//   heads, D), encoded on the host per call), each tile on a "full"
//   mbarrier, each refilled once an "empty" one says it has been read. A
//   consumer warpgroup computes S = Q K^T with wgmma (Q and K from shared
//   memory, float32 accumulator in registers); only a tile that is not
//   fully live (diagonal, window edge, chunk edge) pays for the mask, an
//   interval test per element on the accumulator fragment; the online
//   softmax runs in registers (row max and sum over the 4 lanes that share
//   a row, exponentials on the special-function unit, the scale folded
//   into one FMA); P feeds O += P V from registers as wgmma's A operand,
//   with V from shared memory as B. Blocks start longest (causal) q tile
//   first. The output tile goes through the q tile's shared memory,
//   swizzled, to one TMA store. Neither kernel falls back to the other.
//
// bfloat16 -> flash_fwd_tc (FlashAttention-3's operand layout): a producer
//   warp beside the consumer warpgroup (160 threads), 80 KB of shared
//   memory, two blocks per SM, a 2-stage ring of 64-row kv tiles. The
//   running max moves, and the sum and output are rescaled, only when a
//   row of the warp has grown by more than 2^8 (FlashAttention-4's
//   conditional rescale: the same result up to rounding, and most tiles
//   skip the 64 multiplies). P is rounded to bf16 in registers and fed, in
//   two halves of the kv columns, as the A operand of wgmma.m64n{D}k16 with
//   V as B (as landed, MN-major: wgmma's transpose bit): the first half's
//   P V runs on the tensor cores under the second half's exponentials.
//   Rounding P to bf16 is the one numerical difference from the Pallas
//   kernel, which multiplies P by V in float32: ~2^-9 relative, inside the
//   bf16 tolerance of 2e-2.
//
// float32 -> flash_fwd_split_tf32, split TF32 on the tensor cores. One TF32
//   product keeps 10 mantissa bits of each operand (~2^-11 relative): the
//   float32 tolerance of 2e-5 (~2^-15.6) fails. So every operand x is
//   split into hi = x rounded to TF32 (to nearest, ties away, as
//   cvt.rna.tf32.f32) and lo = x - hi (exact in float32), itself rounded
//   to TF32, and each product is summed as lo*hi + hi*lo + hi*hi into one
//   float32 accumulator (wgmma.m64nNk8.f32.tf32.tf32). What is dropped,
//   lo*lo and lo's own rounding, is at most ~2^-21 of each term |a_i b_i|:
//   ~1e-6 of a score at D=128, well inside 2e-5. The running max, sum and
//   rescale stay in float32, and the output is rescaled on every tile (no
//   slack).
//   wgmma takes TF32 operands only K-major and has no transpose for them:
//   Q and K land row-major, K-major already, and are split in place (hi
//   over the landed tile, lo beside it); V lands row-major (kv rows, d
//   contiguous) and is written as V^T, split, into two tiles of D rows.
//   The S accumulator holds columns 2t, 2t+1 of each 8-column k step where
//   wgmma's A fragment wants t, t+4 (t = lane % 4), so V^T's kv rows are
//   written in that order (each 8 rows' even rows, then its odd ones) and
//   P goes from accumulator to A fragment in place, without a shuffle.
//   That work is a second warpgroup's (256 threads, no producer warp: the
//   transform warpgroup's first thread issues the TMA loads), so the
//   splits and V^T run beside the consumer's wgmma and softmax instead of
//   between them; four mbarriers hand each tile over (K and V^T written;
//   Q K^T and P V done with them). Shared memory at D=128, 64-row kv
//   tiles, one stage: q hi and lo 64 KB, K (split in place) and its lo
//   64 KB, V 32 KB, V^T hi and lo 64 KB: 224 KB of the 227 a block may
//   have, one block per SM; at D=64, 113 KB, two blocks per SM (setmaxnreg
//   gives the consumer 184 registers, the transform warpgroup 72). V's
//   stage frees once V^T is written, so the next V lands under this
//   tile's wgmma; K's frees when Q K^T has read it. Per 64-row kv tile at
//   D=128: 48 wgmma (3 x 16 k steps) for Q K^T and 24 for P V, ~3,070
//   tensor-core clocks at the TF32 rate, during which, and during the
//   softmax, the transform warpgroup splits the next K and writes the next
//   V^T. With one block per SM at D=128 the tensor cores idle through the
//   consumer's softmax: that, and the shared-memory traffic of the SS
//   operands and the splits, is what holds the kernel back (PERF.md).
//
// The bf16 kernel's schedule (64-row kv tiles, a 2-stage ring, P V in two
//   parts, rescale slack 2^8, longest q tile first) is the fastest of the
//   variants measured at the serving shape while it was developed
//   (PERF.md, Findings); kv tiles of 128 rows, 3 stages, and issuing the
//   next tile's Q K^T under this tile's softmax were each slower. So is
//   the float32 kernel's, against: the consumer splitting and transposing
//   itself (no second warpgroup); two q heads of one kv head per block,
//   sharing K/V^T with 32-row kv tiles (m64n32 steps) and taking turns on
//   the tensor cores; and P V in two halves (register spills).
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;  // q rows per tile (both kernels)
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// Shared by both kernels: mbarriers, TMA, wgmma descriptors and fences;
// then bfloat16 on the tensor cores (wgmma), TMA loads, a producer warp
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the phase of parity `parity` of bar to complete. A phase that
// never completes (a lost arrival) traps after ~10 s of spinning instead of
// hanging the card: the launch then fails with an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) asm volatile("trap;");
  }
}

// One (64 columns, 1 head, rows) box of a 3-D tensor map into shared
// memory at dst; completion is counted in bytes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row)
      : "memory");
}

// One box from shared memory at src to a 3-D tensor map (bulk group).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int col, int head, int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(head), "r"(row)
      : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. K-major operands
// (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused
// (1). MN-major operand (V): SBO = 1024 bytes between groups of 8 kv rows,
// LBO = the distance between 64-column halves of the tile.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x N, float32, registers) (+)= A (64 x 16) * B (16 x N), bf16.
// ss: A and B from shared-memory descriptors, both K-major.
// rs: A from registers (4 x bf16x2 per thread), B MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b, scale_d);
  else wgmma_rs_n128(d, a, b, scale_d);
}

// 2^x on the special-function unit, one instruction (denormal results
// flush to 0; ex2(-inf) = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int kBN = 64;          // kv rows per tile (both kernels)
constexpr int kStages = 2;       // depth of the K/V ring
constexpr int kPvSplit = 2;      // parts of P V, each issued once packed
constexpr float kRescaleSlack = 8.0f;  // log2 growth of a row max that rescales

// Shared memory of one block, from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 1024 bytes): the q tile [half][64 rows][128 B], then
// kStages stages of [K tile][V tile], each [half][kBN rows][128 B], then
// the mbarriers.
template <int D>
struct TcLayout {
  static constexpr int kHalves = D / 64;  // 64-column (128-byte) halves
  static constexpr int kQTile = kBlock * 128;            // one half of q
  static constexpr int kQBytes = kHalves * kQTile;
  static constexpr int kKvTile = kBN * D * 2;            // one K or V tile
  static constexpr int kStage = 2 * kKvTile;
  static constexpr int kBars = kQBytes + kStages * kStage;
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(160, 2)
    flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap omap, int S, int H,
                 int KVH, int causal, int window, int chunk,
                 float scale_log2) {
  using L = TcLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBars;
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  auto empty_k = [&](int s) { return bar_q + 8u * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bar_q + 8u * (1 + 3 * kStages + s); };

  const int n_q = S / kBlock;
  const int qt = n_q - 1 - (int)blockIdx.y;  // longest causal tile first
  const int q0 = qt * kBlock;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KVH);
  const int row0 = b * S;  // this batch's first row of the (B*S) row axis
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // block-level liveness of a kv tile, as kernel.py (uniform over the block)
  auto live = [&](int k0) {
    if (causal && k0 > q0 + kBlock - 1) return false;
    if (window > 0 && q0 - (k0 + kBN - 1) >= window) return false;
    if (chunk > 0 && ((q0 + kBlock - 1) / chunk < k0 / chunk ||
                      q0 / chunk > (k0 + kBN - 1) / chunk))
      return false;
    return true;
  };
  auto next_live = [&](int k0) {
    while (k0 < S && !live(k0)) k0 += kBN;
    return k0;
  };

  // Warp 4 produces: its lane 0 sets up the barriers, issues the q tile
  // and the first kStages live K/V tiles before the block's one
  // __syncthreads, then refills each stage's K (V) as soon as the consumer
  // warpgroup has arrived on that stage's "empty" barrier for K (V).
  auto load_k = [&](int it, int k0) {
    const int s = it % kStages;
    const uint32_t dst = base + L::kQBytes + s * L::kStage;
    mbar_expect_tx(full_k(s), L::kKvTile);
    for (int hh = 0; hh < L::kHalves; ++hh)
      tma_load(dst + hh * kBN * 128, &kmap, full_k(s), hh * 64, kvh,
               row0 + k0);
  };
  auto load_v = [&](int it, int k0) {
    const int s = it % kStages;
    const uint32_t dst = base + L::kQBytes + s * L::kStage + L::kKvTile;
    mbar_expect_tx(full_v(s), L::kKvTile);
    for (int hh = 0; hh < L::kHalves; ++hh)
      tma_load(dst + hh * kBN * 128, &vmap, full_v(s), hh * 64, kvh,
               row0 + k0);
  };
  const bool producer = threadIdx.x == 128;
  int pk0 = next_live(0), pit = 0;  // the next kv tile to load, its index
  if (producer) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 128);
      mbar_init(empty_v(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, L::kQBytes);
    for (int hh = 0; hh < L::kHalves; ++hh)
      tma_load(base + hh * L::kQTile, &qmap, bar_q, hh * 64, h, row0 + q0);
    for (; pk0 < S && pit < kStages; pk0 = next_live(pk0 + kBN), ++pit) {
      load_k(pit, pk0);
      load_v(pit, pk0);
    }
  }
  __syncthreads();
  if (warp == 4) {
    if (producer)
      for (; pk0 < S; pk0 = next_live(pk0 + kBN), ++pit) {
        const uint32_t par = ((pit / kStages) - 1) & 1;
        mbar_wait(empty_k(pit % kStages), par);
        load_k(pit, pk0);
        mbar_wait(empty_v(pit % kStages), par);
        load_v(pit, pk0);
      }
    return;
  }
  // This thread holds rows r_lo and r_lo + 8 of the 64-row tile and, in
  // every 8-column chunk of an accumulator, columns c_lo and c_lo + 1 (the
  // wgmma fragment layout: element i is row r_lo + 8 * ((i >> 1) & 1),
  // column 8 * (i >> 2) + c_lo + (i & 1)).
  const int r_lo = warp * 16 + lane / 4;
  const int c_lo = (lane % 4) * 2;

  // o and sc start undefined: the first wgmma into each does not read it
  float o[D / 2], sc[kBN / 2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  // every mask keeps an interval of key positions: [lo[r], hi[r]) for the
  // query position q0 + r_lo + 8 r
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + r_lo + 8 * r;
    lo[r] = 0;
    hi[r] = causal ? qp + 1 : S;
    if (window > 0) lo[r] = max(lo[r], qp - window + 1);
    if (chunk > 0) {
      const int c = qp / chunk * chunk;
      lo[r] = max(lo[r], c);
      hi[r] = min(hi[r], c + chunk);
    }
  }

  // S = Q K^T for the it-th live kv tile into acc: issued, not waited for
  auto issue_s = [&](float (&acc)[kBN / 2], int it) {
    const int s = it % kStages;
    const uint32_t kaddr = base + L::kQBytes + s * L::kStage;
    mbar_wait(full_k(s), (it / kStages) & 1);
    wg_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_n64(
          acc, sw128_desc(base + (kk / 4) * L::kQTile + off, 16, 1024),
          sw128_desc(kaddr + (kk / 4) * kBN * 128 + off, 16, 1024), kk > 0);
    }
    wg_commit();
  };

  mbar_wait(bar_q, 0);
  int k0 = next_live(0);
  if (k0 < S) {
    issue_s(sc, 0);
    wg_wait0();
    fence_regs(sc);
    mbar_arrive(empty_k(0));
  } else {  // no live tile: the output is 0
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  }
  for (int it = 0; k0 < S; ++it) {
    const int s = it % kStages;
    const int kn = next_live(k0 + kBN);

    // mask (edge tiles only), online softmax. m is the running max of the
    // raw scores; the scale is folded into the exponent:
    // p = 2^(s * scale_log2 - m * scale_log2)
    const int q1 = q0 + kBlock - 1, k1 = k0 + kBN - 1;
    const bool full =
        k1 < S && !(causal && k1 > q0) && !(window > 0 && q1 - k0 >= window) &&
        !(chunk > 0 && !(k0 / chunk == k1 / chunk && q0 / chunk == q1 / chunk &&
                         q0 / chunk == k0 / chunk));
    float mx[2] = {m[0], m[1]};
    if (full) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int r = (i >> 1) & 1;
        const int kp = k0 + 8 * (i >> 2) + c_lo + (i & 1);
        if (kp < lo[r] || kp >= hi[r]) sc[i] = -INFINITY;
        mx[r] = fmaxf(mx[r], sc[i]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // The running max moves (and l, o are rescaled) only when some row of
    // the warp has grown by more than 2^kRescaleSlack: a stale
    // max only lets p reach that factor, and l and o keep using the same m,
    // so the result is the same up to rounding.
    const bool grow = (mx[0] - m[0]) * scale_log2 > kRescaleSlack ||
                      (mx[1] - m[1]) * scale_log2 > kRescaleSlack;
    const bool rescale = __any_sync(0xffffffffu, grow);
    float corr[2] = {1.0f, 1.0f};
    if (rescale) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        corr[r] = ex2((m[r] - mx[r]) * scale_log2);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
    }
    const float ms[2] = {m[0] * scale_log2, m[1] * scale_log2};
    if (rescale && it > 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    }

    // P = 2^(...) rounded to bf16, and O += P V, in kPvSplit parts of the kv
    // columns: each part's P V is issued as soon as its probabilities are
    // packed, so the tensor cores run under the next part's exponentials
    constexpr int kPart = kBN / 16 / kPvSplit;  // k16 steps per part
    const uint32_t vaddr = base + L::kQBytes + s * L::kStage + L::kKvTile;
    mbar_wait(full_v(s), (it / kStages) & 1);
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int part = 0; part < kPvSplit; ++part) {
#pragma unroll
      for (int i = part * kPart * 8; i < (part + 1) * kPart * 8; i += 2) {
        const int r = (i >> 1) & 1;
        const float p0 = ex2(fmaf(sc[i], scale_log2, -ms[r]));
        const float p1 = ex2(fmaf(sc[i + 1], scale_log2, -ms[r]));
        l[r] += p0 + p1;
        pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
      }
      wg_fence();
      fence_regs(o);
#pragma unroll
      for (int kk = part * kPart; kk < (part + 1) * kPart; ++kk)
        wgmma_rs<D>(o, pa[kk],
                    sw128_desc(vaddr + kk * 16 * 128, kBN * 128, 1024),
                    it > 0 || kk > 0);
      wg_commit();
    }
    wg_wait0();
    fence_regs(o);
    mbar_arrive(empty_v(s));
    if (kn < S) {
      issue_s(sc, it + 1);
      wg_wait0();
      fence_regs(sc);
      mbar_arrive(empty_k((it + 1) % kStages));
    }
    k0 = kn;
  }

  float inv[2];  // 1 / the row's sum (1 for a row with no live key)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = l[r];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    inv[r] = 1.0f / (t == 0.0f ? 1.0f : t);
  }
  // The output tile goes through the q tile's shared memory (its last
  // reader, the final Q K^T, has completed), in the 128-byte-swizzled
  // layout of the tensor map, then out by one TMA store.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int cc = (8 * j + c_lo) % 64;  // column within its 64-col half
      const uint32_t addr = base + (j / 8) * L::kQTile + row * 128 +
                            ((((cc >> 3) ^ (row & 7)) << 4) | ((cc & 7) * 2));
      st_shared(addr, pack_bf16(o[4 * j + 2 * r] * inv[r],
                                o[4 * j + 2 * r + 1] * inv[r]));
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumer warpgroup
  if (threadIdx.x == 0) {
    for (int hh = 0; hh < L::kHalves; ++hh)
      tma_store(&omap, base + hh * L::kQTile, hh * 64, h, row0 + q0);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// float32: split TF32 on the tensor cores (wgmma), TMA loads, a transform
// warpgroup
// ---------------------------------------------------------------------------

// D (64 x N, float32, registers) (+)= A (64 x 8) * B (8 x N), TF32, both
// K-major. ss: A and B from shared-memory descriptors. rs: A from
// registers, 4 TF32 values per thread: rows g and g + 8 of its warp's 16
// (g = lane / 4), columns t and t + 4 (t = lane % 4), in the order
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
__device__ __forceinline__ void tf32_ss_n64(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void tf32_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void tf32_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void tf32_rs(float (&d)[N / 2],
                                        const uint32_t (&a)[4], uint64_t b,
                                        int scale_d) {
  if constexpr (N == 64) tf32_rs_n64(d, a, b, scale_d);
  else tf32_rs_n128(d, a, b, scale_d);
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// x rounded to the nearest TF32 value, ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite x: half of the 13 dropped bits' range
// added to the magnitude, then the bits cleared (2 integer instructions;
// cvt's check for infinity and NaN takes 4 more, and neither is an input
// here: a NaN with its top mantissa bits set would wrap)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi is x rounded to TF32, lo = x - hi (exact in float32)
// rounded to TF32 in turn
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ float4 ld_shared_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr,
                                             const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, float x,
                                             float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y)
               : "memory");
}

// Shared memory of one block, from a 1024-byte aligned base, every tile in
// 128-byte-swizzled column blocks of 32 floats (a block holds all the
// tile's rows, 128 bytes each): q hi (landed, split in place) and q lo;
// K (landed, split in place) and K lo; V as landed; V^T hi and lo (D rows
// of kBN logical columns). The 7 mbarriers sit in the alignment pad before
// the base, or after the tiles where the pad is under 56 bytes: at D=64
// two blocks then take 2 x (113 KB + 1 KB reserved), all 228 KB of an SM.
template <int D>
struct SplitLayout {
  static constexpr int kQ = kBlock * D * 4;  // the q tile, 64 x D floats
  static constexpr int kKv = kBN * D * 4;    // a K, V or V^T tile
  static constexpr int kQLo = kQ, kK = 2 * kQ, kKLo = kK + kKv,
                       kV = kKLo + kKv, kVtHi = kV + kKv,
                       kVtLo = kVtHi + kKv, kTiles = kVtLo + kKv;
  static constexpr int kBars = 7 * 8;
  static constexpr int kBytes = kTiles + 1024;
  // blocks an SM holds: 228 KB, 1 KB of it reserved per block
  static constexpr int kMinBlocks = 233472 / (kBytes + 1024) >= 2 ? 2 : 1;
  static_assert(kBytes <= 232448, "over the 227 KB a block may have");
};

// Registers a thread of the consumer / transform warpgroup keeps when two
// blocks of 256 threads share an SM's 65,536 (128 each at launch, moved
// by setmaxnreg).
constexpr int kConsumerRegs = 184, kTransformRegs = 72;

// Two warpgroups and no producer warp: warps 0-3 consume (wgmma, softmax),
// warps 4-7 transform (TMA loads from their first thread, then the splits
// and V^T), coupled by mbarriers: k_ready / vt_ready (transform ->
// consumer: K, V^T written), s_done / vt_free (consumer -> transform: Q K^T
// and P V have read them), on top of TMA's full_k / full_v / q.
template <int D>
__global__ void __launch_bounds__(256, SplitLayout<D>::kMinBlocks)
    flash_fwd_split_tf32(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap omap, int S, int H,
                  int KVH, int causal, int window, int chunk,
                  float scale_log2) {
  using L = SplitLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_q =
      base - raw >= L::kBars ? base - L::kBars : base + L::kTiles;
  const uint32_t full_k = bar_q + 8, full_v = bar_q + 16,
                 k_ready = bar_q + 24, vt_ready = bar_q + 32,
                 s_done = bar_q + 40, vt_free = bar_q + 48;

  const int n_q = S / kBlock;
  const int qt = n_q - 1 - (int)blockIdx.y;  // longest causal tile first
  const int q0 = qt * kBlock;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KVH);
  const int row0 = b * S;  // this batch's first row of the (B*S) row axis

  // block-level liveness of a kv tile, as kernel.py (uniform over the block)
  auto live = [&](int k0) {
    if (causal && k0 > q0 + kBlock - 1) return false;
    if (window > 0 && q0 - (k0 + kBN - 1) >= window) return false;
    if (chunk > 0 && ((q0 + kBlock - 1) / chunk < k0 / chunk ||
                      q0 / chunk > (k0 + kBN - 1) / chunk))
      return false;
    return true;
  };
  auto next_live = [&](int k0) {
    while (k0 < S && !live(k0)) k0 += kBN;
    return k0;
  };
  auto load = [&](const CUtensorMap* map, uint32_t bar, uint32_t dst,
                  int k0) {
    mbar_expect_tx(bar, L::kKv);
    for (int c = 0; c < D / 32; ++c)
      tma_load(dst + c * kBN * 128, map, bar, c * 32, kvh, row0 + k0);
  };

  // The transform warpgroup's first thread sets up the barriers and issues
  // the q tile and the first live K/V tile before the block's one
  // __syncthreads.
  if (threadIdx.x == 128) {
    mbar_init(bar_q, 1);
    mbar_init(full_k, 1);
    mbar_init(full_v, 1);
    for (int i = 3; i < 7; ++i) mbar_init(bar_q + 8 * i, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, L::kQ);
    for (int c = 0; c < D / 32; ++c)
      tma_load(base + c * kBlock * 128, &qmap, bar_q, c * 32, h, row0 + q0);
    const int k0 = next_live(0);
    if (k0 < S) {
      load(&kmap, full_k, base + L::kK, k0);
      load(&vmap, full_v, base + L::kV, k0);
    }
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- transform warpgroup -------------------------------------------
    if constexpr (L::kMinBlocks == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kTransformRegs));
    const int tt = threadIdx.x - 128;
    // hi over the tile in place, lo at lo_tile (the same swizzled layout),
    // 8 reads in flight before their writes
    auto split_tile = [&](uint32_t tile, uint32_t lo_tile, int bytes) {
      for (int off0 = tt * 16; off0 < bytes; off0 += 8 * 128 * 16) {
        float4 x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          x[u] = ld_shared_v4(tile + off0 + u * 128 * 16);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          uint32_t hi[4], lo[4];
          split_tf32(x[u].x, hi[0], lo[0]);
          split_tf32(x[u].y, hi[1], lo[1]);
          split_tf32(x[u].z, hi[2], lo[2]);
          split_tf32(x[u].w, hi[3], lo[3]);
          st_shared_v4(tile + off0 + u * 128 * 16, hi);
          st_shared_v4(lo_tile + off0 + u * 128 * 16, lo);
        }
      }
    };
    // V (kBN kv rows x D) -> V^T hi and lo (D rows x kBN logical columns).
    // Logical column 8j + 4p + i holds kv row 8j + 2i + p: in each 8-row
    // group the even rows come first, then the odd ones, the order of P's
    // A fragment. A thread takes 4 such rows (one group g = 2j + p of 4
    // logical columns) at 4 columns d0.. of V (16-byte reads), and writes
    // the 4 x 4 block back transposed (16-byte writes to 4 rows of V^T).
    // Lane n of a quarter warp takes group 8G + n and column block
    // dg = 8Dg + 2(((n >> 1) + r) & 3) + c: its 8 lanes read 8 different
    // 16-byte bank groups of the swizzled V tile and write 8 different ones
    // of V^T, for every (r, c) of the 8 variants that cover the 8 x 8
    // (group, column block) pairs.
    auto transpose_v = [&]() {
      constexpr int kItems = kBN / 32 * (D / 32) * 8 / 16;  // per thread
      const int n = tt % 8;
      int g[kItems], dg[kItems];
      float4 x[kItems][4];  // every read in flight before the first write
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        const int t = tt / 8 + 16 * u, var = t % 8, rest = t / 8;
        g[u] = 8 * (rest % (kBN / 32)) + n;
        dg[u] = 8 * (rest / (kBN / 32)) +
                2 * (((n >> 1) + (var >> 1)) & 3) + (var & 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kv = 8 * (g[u] >> 1) + 2 * i + (g[u] & 1);
          x[u][i] = ld_shared_v4(base + L::kV + (dg[u] / 8) * kBN * 128 +
                                 kv * 128 + (((dg[u] % 8) ^ (kv & 7)) << 4));
        }
      }
#pragma unroll
      for (int u = 0; u < kItems; ++u)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int d = 4 * dg[u] + jj;
          const uint32_t off = (g[u] / 8) * D * 128 + d * 128 +
                               (((g[u] % 8) ^ (d & 7)) << 4);
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_tf32(reinterpret_cast<const float*>(&x[u][i])[jj], hi[i],
                       lo[i]);
          st_shared_v4(base + L::kVtHi + off, hi);
          st_shared_v4(base + L::kVtLo + off, lo);
        }
    };
    auto publish = [&](uint32_t bar) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(bar);
    };
    int k0 = next_live(0);
    if (k0 < S) {
      mbar_wait(bar_q, 0);
      split_tile(base, base + L::kQLo, L::kQ);  // published with K's first
    }
    for (int it = 0; k0 < S; ++it) {
      const int kn = next_live(k0 + kBN);
      if (it > 0 && tt == 0) {  // the K slot frees when Q K^T has read it
        mbar_wait(s_done, (it - 1) & 1);
        load(&kmap, full_k, base + L::kK, k0);
      }
      mbar_wait(full_k, it & 1);
      split_tile(base + L::kK, base + L::kKLo, L::kKv);
      publish(k_ready);
      if (it > 0) mbar_wait(vt_free, (it - 1) & 1);
      mbar_wait(full_v, it & 1);
      transpose_v();
      publish(vt_ready);
      asm volatile("bar.sync 2, 128;\n" ::: "memory");  // V read by all
      if (tt == 0 && kn < S) load(&vmap, full_v, base + L::kV, kn);
      k0 = kn;
    }
  } else {
    // ---- consumer warpgroup --------------------------------------------
    if constexpr (L::kMinBlocks == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          kConsumerRegs));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // This thread holds rows r_lo and r_lo + 8 of the 64-row tile and, in
    // every 8-column chunk of an accumulator, columns c_lo and c_lo + 1
    // (the wgmma fragment layout: element i is row r_lo + 8 * ((i >> 1) &
    // 1), column 8 * (i >> 2) + c_lo + (i & 1)).
    const int r_lo = warp * 16 + lane / 4;
    const int c_lo = (lane % 4) * 2;

    // o and sc start undefined: the first wgmma into each does not read it
    float o[D / 2], sc[kBN / 2];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    // every mask keeps an interval of key positions: [lo[r], hi[r]) for
    // the query position q0 + r_lo + 8 r
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = q0 + r_lo + 8 * r;
      lo[r] = 0;
      hi[r] = causal ? qp + 1 : S;
      if (window > 0) lo[r] = max(lo[r], qp - window + 1);
      if (chunk > 0) {
        const int c = qp / chunk * chunk;
        lo[r] = max(lo[r], c);
        hi[r] = min(hi[r], c + chunk);
      }
    }

    // the q tile has landed before the output goes through its memory
    mbar_wait(bar_q, 0);
    int k0 = next_live(0);
    if (k0 >= S) {  // no live tile: the output is 0
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    }
    for (int it = 0; k0 < S; ++it) {
      const int kn = next_live(k0 + kBN);
      // S = Q K^T as lo*hi + hi*lo + hi*hi, TF32, per k step of 8
      mbar_wait(k_ready, it & 1);
      wg_fence();
      fence_regs(sc);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t qa = base + (kk / 4) * kBlock * 128 + (kk % 4) * 32;
        const uint32_t ka =
            base + L::kK + (kk / 4) * kBN * 128 + (kk % 4) * 32;
        const uint64_t q_hi = sw128_desc(qa, 16, 1024),
                       q_lo = sw128_desc(qa + L::kQLo, 16, 1024),
                       k_hi = sw128_desc(ka, 16, 1024),
                       k_lo = sw128_desc(ka + L::kKv, 16, 1024);
        tf32_ss_n64(sc, q_lo, k_hi, kk > 0);
        tf32_ss_n64(sc, q_hi, k_lo, 1);
        tf32_ss_n64(sc, q_hi, k_hi, 1);
      }
      wg_commit();
      wg_wait0();
      fence_regs(sc);
      mbar_arrive(s_done);

      // mask (edge tiles only), online softmax. m is the running max of
      // the raw scores; the scale is folded into the exponent:
      // p = 2^(s * scale_log2 - m * scale_log2)
      const int q1 = q0 + kBlock - 1, k1 = k0 + kBN - 1;
      const bool full =
          k1 < S && !(causal && k1 > q0) &&
          !(window > 0 && q1 - k0 >= window) &&
          !(chunk > 0 && !(k0 / chunk == k1 / chunk &&
                           q0 / chunk == q1 / chunk &&
                           q0 / chunk == k0 / chunk));
      float mx[2] = {m[0], m[1]};
      if (full) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      } else {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int r = (i >> 1) & 1;
          const int kp = k0 + 8 * (i >> 2) + c_lo + (i & 1);
          if (kp < lo[r] || kp >= hi[r]) sc[i] = -INFINITY;
          mx[r] = fmaxf(mx[r], sc[i]);
        }
      }
      float ms[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2((m[r] - mx[r]) * scale_log2);
        m[r] = mx[r];
        l[r] *= corr[r];
        ms[r] = m[r] * scale_log2;
      }
      if (it > 0) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      }
      // P = 2^(...), split, in the A fragment's order: element e of k step
      // j is row r_lo + 8 (e & 1) and kv column 8 j + c_lo + (e >> 1),
      // which V^T holds at logical column 8 j + c_lo / 2 + 4 (e >> 1)
      uint32_t p_hi[kBN / 8][4], p_lo[kBN / 8][4];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              ex2(fmaf(sc[4 * j + 2 * (e & 1) + (e >> 1)], scale_log2,
                       -ms[e & 1]));
          l[e & 1] += p;
          split_tf32(p, p_hi[j][e], p_lo[j][e]);
        }

      // O += P V as lo*hi + hi*lo + hi*hi
      mbar_wait(vt_ready, it & 1);
      wg_fence();
      fence_regs(o);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const uint32_t va =
            base + L::kVtHi + (j / 4) * D * 128 + (j % 4) * 32;
        const uint64_t v_hi = sw128_desc(va, 16, 1024),
                       v_lo = sw128_desc(va + L::kKv, 16, 1024);
        tf32_rs<D>(o, p_lo[j], v_hi, it > 0 || j > 0);
        tf32_rs<D>(o, p_hi[j], v_lo, 1);
        tf32_rs<D>(o, p_hi[j], v_hi, 1);
      }
      wg_commit();
      wg_wait0();
      fence_regs(o);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        fence_regs(p_hi[j]);
        fence_regs(p_lo[j]);
      }
      mbar_arrive(vt_free);
      k0 = kn;
    }

    float inv[2];  // 1 / the row's sum (1 for a row with no live key)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t = l[r];
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      inv[r] = 1.0f / (t == 0.0f ? 1.0f : t);
    }
    // The output tile goes through q hi's shared memory (its last reader,
    // the final Q K^T, has completed), in the tensor map's 128-byte-
    // swizzled layout, then out by one TMA store per 32 columns.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int cc = (8 * j + c_lo) % 32;  // column in its 32-col block
        const uint32_t addr =
            base + (j / 4) * kBlock * 128 + row * 128 +
            ((((cc >> 2) ^ (row & 7)) << 4) | ((cc & 3) * 4));
        st_shared_v2(addr, o[4 * j + 2 * r] * inv[r],
                     o[4 * j + 2 * r + 1] * inv[r]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumers
    if (threadIdx.x == 0) {
      for (int c = 0; c < D / 32; ++c)
        tma_store(&omap, base + c * kBlock * 128, c * 32, h, row0 + q0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links no libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A BSHD tensor seen as (B*S rows, heads, D), innermost first, read in
// boxes of (128 bytes of columns, 1 head, box_rows rows) with the 128-byte
// swizzle; elements of 2 bytes (bf16) or 4 (float32).
int encode_bshd(CUtensorMap* map, const void* ptr, long long rows, int heads,
                int D, int box_rows, int elem_bytes) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * elem_bytes,
                                 (cuuint64_t)heads * D * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem_bytes), 1,
                             (cuuint32_t)box_rows};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Both kernels: four tensor maps, grid (B*H, S/64).
template <typename Kernel>
int launch(Kernel kernel, int threads, int smem_bytes, int elem_bytes,
           int kv_rows,
           const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KVH, int D, int causal, int window, int chunk,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm, km, vm, om;
  const long long rows = (long long)B * S;
  int code = encode_bshd(&qm, q, rows, H, D, kBlock, elem_bytes);
  if (!code) code = encode_bshd(&km, k, rows, KVH, D, kv_rows, elem_bytes);
  if (!code) code = encode_bshd(&vm, v, rows, KVH, D, kv_rows, elem_bytes);
  if (!code) code = encode_bshd(&om, out, rows, H, D, kBlock, elem_bytes);
  if (code) return code;
  const dim3 grid(B * H, S / kBlock);
  kernel<<<grid, threads, smem_bytes, stream>>>(
      qm, km, vm, om, S, H, KVH, causal, window, chunk,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int S, int H, int KVH, int causal, int window, int chunk,
              cudaStream_t stream) {
  return launch(flash_fwd_tc<D>, 160, TcLayout<D>::kBytes, 2, kBN, q, k, v, out,
                B, S, H, KVH, D, causal, window, chunk, stream);
}

template <int D>
int launch_split_tf32(const void* q, const void* k, const void* v,
                      void* out, int B, int S, int H, int KVH, int causal,
                      int window, int chunk, cudaStream_t stream) {
  // all of the SM's 228 KB as shared memory: two blocks at D=64
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_split_tf32<D>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  return launch(flash_fwd_split_tf32<D>, 256, SplitLayout<D>::kBytes, 4, kBN,
                q, k, v, out, B, S, H, KVH, D, causal, window, chunk, stream);
}

}  // namespace

// q (B,S,H,D), k/v (B,S,KVH,D), out (B,S,H,D), all contiguous and 16-byte
// aligned, float32 (is_bf16 = 0) or bfloat16; D in {64, 128}; S % 64 == 0;
// H % KVH == 0; window / chunk 0 for none. bfloat16 runs the bf16 tensor-core
// kernel, float32 the split-TF32 one. Returns a cudaError_t code.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int H, int KVH, int D, int is_bf16,
                                   int causal, int window, int chunk,
                                   void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  if (S % kBlock || KVH <= 0 || H % KVH || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return D == 64 ? launch_tc<64>(q, k, v, out, B, S, H, KVH, causal, window,
                                   chunk, s)
                   : launch_tc<128>(q, k, v, out, B, S, H, KVH, causal,
                                    window, chunk, s);
  return D == 64 ? launch_split_tf32<64>(q, k, v, out, B, S, H, KVH, causal,
                                         window, chunk, s)
                 : launch_split_tf32<128>(q, k, v, out, B, S, H, KVH, causal,
                                          window, chunk, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
