// Flash attention forward, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py, flash_attention
// (Pallas): online-softmax attention over q (B, S, H, D) and k/v
// (B, S, KVH, D) with GQA (q head h reads kv head h / (H/KVH), nothing
// repeated), causal / sliding-window / chunked masks with positions equal
// to the row indices, dead tiles skipped, float32 accumulation, a running
// denominator of 0 replaced by 1, output cast to the input type, scale
// 1/sqrt(D). Reads and writes the layers' BSHD layout directly, so the
// wrapper moves no axes. Plain version:
// repro_torch.kernels.flash_attention.ops.flash_attention_plain (the full
// masked softmax in float32).
//
// Bound: at the serving path's prefill (B=1, H=32, KVH=8, S=512, D=128,
//   bf16, causal) the function reads q, k, v once and writes out once,
//   10.5 MB, ~3.1 us at 3.35 TB/s, and does ~2.15 GFLOP of live causal
//   work, ~2.2 us at 989 TFLOP/s dense bf16 on the tensor cores: a few
//   microseconds either way. This kernel does its products as float32 FMAs
//   on the CUDA cores (67 TFLOP/s at best), fed from shared memory, so it
//   is bound by shared-memory loads and FMAs, not by device memory.
// Design: one block of 256 threads per (batch*head, 64-row q tile). The q
//   tile is converted to float32 in shared memory once; the block walks the
//   64-row kv tiles in order and skips every tile the block-level liveness
//   test of kernel.py rules out. Per live tile: the K tile goes to shared
//   memory (float32, rows padded to D+1 floats so column walks hit distinct
//   banks); each thread computes a 4x4 block of scores (rows ty+16a,
//   columns tx+16b) from registers; the per-element mask, the running max
//   and the running sum are reduced over the 16 threads that share a row
//   with warp shuffles; the probabilities go to shared memory; the V tile
//   replaces the K tile; each thread accumulates a 4x(D/16) block of the
//   output in registers. Masked scores contribute exactly 0 (a row that has
//   seen no live key keeps m = -1e30, l = 0, acc = 0). Global loads are
//   16-byte vectors. wgmma, TMA and a pipelined producer warp are left for
//   later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;    // q rows and kv rows per tile
constexpr int kThreads = 256; // 16 x 16: tx = column group, ty = row group
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Rows [0, kBlock) of one head, row r at src + r * row_stride, D contiguous
// elements each, into dst (float32, row stride ld).
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          long long row_stride,
                                          float* __restrict__ dst, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kBlock * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[r * ld + c + j] = to_float(vals[j]);
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
constexpr int smem_bytes() {
  return (2 * kBlock * (D + 1) + kBlock * (kBlock + 1)) * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int S,
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
  const T* kb = k + (long long)b * S * kv_rs + (long long)kvh * D;
  const T* vb = v + (long long)b * S * kv_rs + (long long)kvh * D;
  load_tile<T, D>(q + ((long long)b * S + q0) * q_rs + (long long)h * D,
                  q_rs, sq, kLd);

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
    load_tile<T, D>(kb + (long long)k0 * kv_rs, kv_rs, skv, kLd);
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
    load_tile<T, D>(vb + (long long)k0 * kv_rs, kv_rs, skv, kLd);
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
    T* ob = out + ((long long)b * S + q0 + ty + 16 * a) * q_rs +
            (long long)h * D;
#pragma unroll
    for (int c = 0; c < kDj; ++c)
      ob[tx + 16 * c] = from_float<T>(acc[a][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KVH, int causal, int window, int chunk,
           cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S / kBlock, B * H);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KVH, causal,
      window, chunk, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,S,H,D), k/v (B,S,KVH,D), out (B,S,H,D), all contiguous and 16-byte
// aligned, float32 (is_bf16 = 0) or bfloat16; D in {64, 128}; S % 64 == 0;
// H % KVH == 0; window / chunk 0 for none. Returns a cudaError_t code.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int H, int KVH, int D, int is_bf16,
                                   int causal, int window, int chunk,
                                   void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  if (S % kBlock || KVH <= 0 || H % KVH || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return D == 64 ? launch<__nv_bfloat16, 64>(q, k, v, out, B, S, H, KVH,
                                               causal, window, chunk, s)
                   : launch<__nv_bfloat16, 128>(q, k, v, out, B, S, H, KVH,
                                                causal, window, chunk, s);
  }
  return D == 64 ? launch<float, 64>(q, k, v, out, B, S, H, KVH, causal,
                                     window, chunk, s)
                 : launch<float, 128>(q, k, v, out, B, S, H, KVH, causal,
                                      window, chunk, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
