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
//   bf16, causal) the function reads q, k, v once and writes out once,
//   10.5 MB, ~3.1 us at 3.35 TB/s, and does ~2.15 GFLOP of live causal
//   work, ~2.2 us at 989 TFLOP/s dense bf16: a few microseconds either way.
//   What sets the time instead is latency: the block that owns the last
//   causal q tile walks 8 kv tiles one after another (Q K^T, softmax, P V,
//   each step waiting on the one before), after the loads' first trip to
//   device memory. The softmax's exponentials (4096 a tile, 16 a clock on
//   an SM) are the longest span of a step.
//
// Two kernels, picked by dtype; neither falls back to the other.
//
// bfloat16 -> flash_fwd_tc, on the tensor cores (FlashAttention-3's operand
//   layout). One block owns one 64-row q tile of one head: one consumer
//   warpgroup and one producer warp (160 threads, 80 KB of shared memory,
//   two blocks per SM). The producer's lane 0 sets up the mbarriers and
//   brings the q tile and every live K/V tile by TMA (cp.async.bulk.tensor,
//   128-byte swizzle, from tensor maps over the BSHD tensors seen as
//   (B*S rows, heads, D), encoded on the host per call) into a ring of
//   kStages stages; each stage has a "full" and an "empty" mbarrier for K
//   and for V, so K is refilled as soon as Q K^T has read it. The first
//   loads go out before the block's __syncthreads. The consumer computes
//   S = Q K^T with wgmma.m64n64k16 (Q and K from shared memory, float32
//   accumulator in registers); only a tile that is not fully live
//   (diagonal, window edge, chunk edge) pays for the mask, an interval test
//   per element on the accumulator fragment; the online softmax runs in
//   registers (row max and sum over the 4 lanes that share a row,
//   exponentials on the special-function unit, the scale folded into one
//   FMA). The running max moves, and the sum and output are rescaled, only
//   when a row of the warp has grown by more than 2^8 (FlashAttention-4's
//   conditional rescale: the same result up to rounding, and most tiles
//   skip the 64 multiplies). P is rounded to bf16 in registers and fed, in
//   two halves of the kv columns, as the A operand of wgmma.m64n{D}k16 with
//   V (transposed, from shared memory) as B: the first half's P V runs on
//   the tensor cores under the second half's exponentials. Rounding P to
//   bf16 is the one numerical difference from the Pallas kernel, which
//   multiplies P by V in float32: ~2^-9 relative, inside the bf16
//   tolerance of 2e-2. Blocks start longest (causal) q tile first. The
//   output tile goes through the q tile's shared memory, swizzled, to one
//   TMA store.
//
// float32 -> flash_fwd_f32, on the CUDA cores: float32 FMAs, which pass the
//   2e-5 float32 tolerance that TF32 tensor cores could not. One block of
//   256 threads per (batch*head, 64-row q tile); the q tile is converted to
//   float32 in shared memory once; the block walks the live 64-row kv tiles
//   in order. Per live tile: the K tile goes to shared memory (rows padded
//   to D+1 floats); each thread computes a 4x4 block of scores; the mask,
//   running max and running sum are reduced over the 16 threads that share
//   a row with warp shuffles; the probabilities go to shared memory; the V
//   tile replaces the K tile; each thread accumulates a 4x(D/16) block of
//   the output in registers. Masked scores contribute exactly 0.
//
// The bf16 kernel's schedule (64-row kv tiles, a 2-stage ring, P V in two
//   parts, rescale slack 2^8, longest q tile first) is the fastest of the
//   variants measured at the serving shape while it was developed
//   (PERF.md, Findings); kv tiles of 128 rows, 3 stages, and issuing the
//   next tile's Q K^T under this tile's softmax were each slower.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;  // q rows per tile (both kernels), kv rows (f32)
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16: tx = column group, ty = row group

// Rows [0, kBlock) of one head, row r at src + r * row_stride, D contiguous
// floats each, into dst (row stride ld).
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          long long row_stride,
                                          float* __restrict__ dst, int ld) {
  constexpr int kVec = 4;
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kBlock * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const float4 raw = *reinterpret_cast<const float4*>(src + r * row_stride + c);
    const float* vals = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[r * ld + c + j] = vals[j];
  }
}

__device__ __forceinline__ float row_reduce_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_reduce_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr int smem_bytes_f32() {
  return (2 * kBlock * (D + 1) + kBlock * (kBlock + 1)) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int S,
                  int H, int KVH, int causal, int window, int chunk,
                  float scale) {
  constexpr int kLd = D + 1;       // padded float32 row of a q/k/v tile
  constexpr int kLp = kBlock + 1;  // padded row of the probability tile
  constexpr int kDj = D / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;                  // kBlock x kLd
  float* skv = sq + kBlock * kLd;    // kBlock x kLd: the K tile, then V
  float* sp = skv + kBlock * kLd;    // kBlock x kLp

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * kBlock;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long q_rs = (long long)H * D, kv_rs = (long long)KVH * D;
  const float* kb = k + (long long)b * S * kv_rs + (long long)kvh * D;
  const float* vb = v + (long long)b * S * kv_rs + (long long)kvh * D;
  load_tile<D>(q + ((long long)b * S + q0) * q_rs + (long long)h * D, q_rs,
               sq, kLd);

  float acc[4][kDj], m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.0f;
#pragma unroll
    for (int j = 0; j < kDj; ++j) acc[a][j] = 0.0f;
  }

  for (int k0 = 0; k0 < S; k0 += kBlock) {
    // block-level liveness, as kernel.py (uniform over the block)
    if (causal && k0 > q0 + kBlock - 1) continue;
    if (window > 0 && q0 - (k0 + kBlock - 1) >= window) continue;
    if (chunk > 0 && ((q0 + kBlock - 1) / chunk < k0 / chunk ||
                      q0 / chunk > (k0 + kBlock - 1) / chunk))
      continue;
    __syncthreads();  // the previous V tile is consumed (q tile stored)
    load_tile<D>(kb + (long long)k0 * kv_rs, kv_rs, skv, kLd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = sq[(ty + 16 * a) * kLd + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = skv[(tx + 16 * c) * kLd + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qp = q0 + ty + 16 * a;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        bool live = true;
        if (causal) live = live && kp <= qp;
        if (window > 0) live = live && (qp - kp) < window;
        if (chunk > 0) live = live && (qp / chunk) == (kp / chunk);
        ok[c] = live;
        s[a][c] = live ? s[a][c] * scale : kNegInf;
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_new = fmaxf(m[a], row_reduce_max(mx));
      const float corr = expf(m[a] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[a][c] - m_new) : 0.0f;
        sp[(ty + 16 * a) * kLp + tx + 16 * c] = p;
        sum += p;
      }
      l[a] = l[a] * corr + row_reduce_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < kDj; ++j) acc[a][j] *= corr;
    }
    __syncthreads();  // K tile consumed, probabilities stored
    load_tile<D>(vb + (long long)k0 * kv_rs, kv_rs, skv, kLd);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = sp[(ty + 16 * a) * kLp + j];
#pragma unroll
      for (int c = 0; c < kDj; ++c) {
        const float vv = skv[j * kLd + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pa[a], vv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float denom = l[a] == 0.0f ? 1.0f : l[a];
    float* ob = out + ((long long)b * S + q0 + ty + 16 * a) * q_rs +
                (long long)h * D;
#pragma unroll
    for (int c = 0; c < kDj; ++c) ob[tx + 16 * c] = acc[a][c] / denom;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int KVH, int causal, int window, int chunk,
               cudaStream_t stream) {
  auto kernel = flash_fwd_f32<D>;
  constexpr int bytes = smem_bytes_f32<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S / kBlock, B * H);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, KVH,
      causal, window, chunk, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), TMA loads, a producer warp
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

constexpr int kBN = 64;          // kv rows per tile (bf16)
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
// boxes of (64 columns, 1 head, box_rows rows) with the 128-byte swizzle.
int encode_bshd(CUtensorMap* map, const void* ptr, long long rows, int heads,
                int D, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2};
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)box_rows};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int S, int H, int KVH, int causal, int window, int chunk,
              cudaStream_t stream) {
  using L = TcLayout<D>;
  auto kernel = flash_fwd_tc<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm, km, vm, om;
  const long long rows = (long long)B * S;
  int code = encode_bshd(&qm, q, rows, H, D, kBlock);
  if (!code) code = encode_bshd(&km, k, rows, KVH, D, kBN);
  if (!code) code = encode_bshd(&vm, v, rows, KVH, D, kBN);
  if (!code) code = encode_bshd(&om, out, rows, H, D, kBlock);
  if (code) return code;
  const dim3 grid(B * H, S / kBlock);
  kernel<<<grid, 160, L::kBytes, stream>>>(
      qm, km, vm, om, S, H, KVH, causal, window, chunk,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,S,H,D), k/v (B,S,KVH,D), out (B,S,H,D), all contiguous and 16-byte
// aligned, float32 (is_bf16 = 0) or bfloat16; D in {64, 128}; S % 64 == 0;
// H % KVH == 0; window / chunk 0 for none. bfloat16 runs the tensor-core
// kernel, float32 the CUDA-core one. Returns a cudaError_t code.
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
  return D == 64 ? launch_f32<64>(q, k, v, out, B, S, H, KVH, causal, window,
                                  chunk, s)
                 : launch_f32<128>(q, k, v, out, B, S, H, KVH, causal, window,
                                   chunk, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
