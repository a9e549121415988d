// The elastic exchange (paper eqs. 12-13), hand-written for Hopper (sm_90a).
//
// Two C entry points:
//   elastic_update_batched — replaces src/repro/kernels/elastic/kernel.py,
//     elastic_update_batched_flat (Pallas; the fused comm phase): for every worker
//     i in order 0..k-1, diff = w_i - ref; w_i <- w_i - h1_i*diff;
//     m <- m + sum_i h2_i*diff, with ref = m, or the stale master_prev snapshot
//     under delayed averaging.
//   elastic_update — replaces src/repro/kernels/elastic/kernel.py,
//     elastic_update_flat (Pallas; one worker of the sequential comm scan):
//     the same update at k = 1 with ref = m, i.e. w <- w - h1*(w-m),
//     m <- m + (0 + h2*(w-m)), which equals m + h2*(w-m) exactly.
// Plain versions: repro_torch.core.elastic.elastic_update_batched and
//   elastic_update, in the same op order.
//
// Bound: device memory. Per element of n: k worker reads and writes, one read
//   and one write of m, one more read of ref when stale: (2k+2)*4 bytes (+4),
//   against 5 float operations per worker. On an H100 SXM (3.35 TB/s) that is
//   86 MB, about 26 us, at k=8, n=1,199,882, and 19 MB, about 6 us, at k=1.
// Design: each thread owns kVec consecutive elements of the column and walks
//   the workers in groups of kGroup: it issues the loads of every worker of
//   the group (and its h1/h2) before any arithmetic, so kGroup * kVec * 4
//   bytes per thread are in flight at once (a loop that loads, updates and
//   stores one worker at a time leaves the memory system idle between
//   them); then it writes each w_i' and keeps the sum of h2_i*diff_i in
//   registers, in worker order, and writes m' once. Every element is read
//   once and written once, in place. kVec is 4 (16-byte accesses) when
//   every row start, m and ref are 16-byte aligned, 2 when they are 8-byte
//   aligned (n even: the paper CNN's n = 1,199,882 is 2 mod 4, so odd worker
//   rows start 8-byte aligned), else 1; the tail past the last whole vector
//   goes one element at a time. Blocks of 128 threads at 64 registers a
//   thread keep 8 blocks resident per SM. The persistent (k, n) buffers are
//   not padded: their layout is JAX's flat order. h1/h2 come from a (2, k)
//   device tensor, so nothing is read back to the host. At k = 1 without a
//   stale snapshot (elastic_update, the sequential scan) a plain
//   one-element-a-thread kernel runs: with one worker there is nothing to
//   batch, and it is the faster of the two there.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 8;  // workers whose loads are in flight together
constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;  // per SM: caps registers at 64 a thread

template <int kVec> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int kVec>
__device__ __forceinline__ void load(float (&x)[kVec], const float* p) {
  const typename Vec<kVec>::T v = *reinterpret_cast<const typename Vec<kVec>::T*>(p);
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int e = 0; e < kVec; ++e) x[e] = f[e];
}

template <int kVec>
__device__ __forceinline__ void store(float* p, const float (&x)[kVec]) {
  typename Vec<kVec>::T v;
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int e = 0; e < kVec; ++e) f[e] = x[e];
  *reinterpret_cast<typename Vec<kVec>::T*>(p) = v;
}

template <int kVec, bool kStale>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    elastic_update_batched_kernel(float* __restrict__ w, float* __restrict__ m,
                                  const float* __restrict__ ref,
                                  const float* __restrict__ h, long long k,
                                  long long n) {
  const long long i =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (i >= n) return;
  if (i + kVec > n) {  // the ragged tail: one element at a time
    for (long long e = i; e < n; ++e) {
      const float mi = m[e];
      const float r = kStale ? ref[e] : mi;
      float acc = 0.0f;
      for (long long j = 0; j < k; ++j) {
        const float h1 = __ldg(h + j);
        const float h2 = __ldg(h + k + j);
        const float wi = w[j * n + e];
        const float diff = wi - r;
        w[j * n + e] = wi - h1 * diff;
        acc = acc + h2 * diff;
      }
      m[e] = mi + acc;
    }
    return;
  }
  float mi[kVec], r[kVec], acc[kVec];
  load<kVec>(mi, m + i);
  if (kStale) load<kVec>(r, ref + i);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    if (!kStale) r[e] = mi[e];
    acc[e] = 0.0f;
  }
  for (long long j0 = 0; j0 < k; j0 += kGroup) {
    float wv[kGroup][kVec], h1[kGroup], h2[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (j0 + g < k) {
        load<kVec>(wv[g], w + (j0 + g) * n + i);
        h1[g] = __ldg(h + j0 + g);
        h2[g] = __ldg(h + k + j0 + g);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (j0 + g < k) {
        float out[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float diff = wv[g][e] - r[e];
          out[e] = wv[g][e] - h1[g] * diff;
          acc[e] = acc[e] + h2[g] * diff;
        }
        store<kVec>(w + (j0 + g) * n + i, out);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) mi[e] = mi[e] + acc[e];
  store<kVec>(m + i, mi);
}

// One worker against the master (k = 1, no stale snapshot): one element a
// thread, at full occupancy; the same arithmetic as the kernel above.
__global__ void __launch_bounds__(256)
    elastic_update_one_kernel(float* __restrict__ w, float* __restrict__ m,
                              const float* __restrict__ h, long long n) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const float mi = m[i];
  const float wi = w[i];
  const float diff = wi - mi;
  w[i] = wi - __ldg(h) * diff;
  float acc = 0.0f;
  acc = acc + __ldg(h + 1) * diff;
  m[i] = mi + acc;
}

// The widest access every row start (w + j*n), m and ref allow.
int vec_width(const float* w, const float* m, const float* ref, long long k,
              long long n) {
  uintptr_t bits = (uintptr_t)w | (uintptr_t)m | (uintptr_t)ref;
  if (k > 1) bits |= (uintptr_t)(n * 4);
  if ((bits & 15) == 0) return 4;
  if ((bits & 7) == 0) return 2;
  return 1;
}

template <int kVec>
void launch_vec(float* w, float* m, const float* ref, const float* h,
                long long k, long long n, cudaStream_t s) {
  const long long per_block = (long long)kThreads * kVec;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  if (ref != nullptr)
    elastic_update_batched_kernel<kVec, true>
        <<<blocks, kThreads, 0, s>>>(w, m, ref, h, k, n);
  else
    elastic_update_batched_kernel<kVec, false>
        <<<blocks, kThreads, 0, s>>>(w, m, nullptr, h, k, n);
}

int launch(float* w, float* m, const float* ref, const float* h, long long k,
           long long n, void* stream) {
  if (k <= 0 || n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 1 && ref == nullptr) {
    elastic_update_one_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        w, m, h, n);
    return (int)cudaGetLastError();
  }
  switch (vec_width(w, m, ref, k, n)) {
    case 4: launch_vec<4>(w, m, ref, h, k, n, s); break;
    case 2: launch_vec<2>(w, m, ref, h, k, n, s); break;
    default: launch_vec<1>(w, m, ref, h, k, n, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int elastic_update_batched(float* w, float* m, const float* ref,
                                      const float* h, long long k, long long n,
                                      void* stream) {
  return launch(w, m, ref, h, k, n, stream);
}

extern "C" int elastic_update(float* w, float* m, const float* h, long long n,
                              void* stream) {
  return launch(w, m, nullptr, h, 1, n, stream);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
