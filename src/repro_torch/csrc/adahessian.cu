// The fused AdaHessian steps, hand-written for Hopper (sm_90a). Two C entry points:
//
// adahessian_update_batched — the k-worker step of the elastic local phase.
// Replaces: src/repro/kernels/adahessian/kernel.py, adahessian_update_batched_flat
//   (the Pallas TPU kernel behind repro.kernels.adahessian.ops.adahessian_update_batched).
// Plain version: repro_torch.optim.adahessian.moment_update, in the same op order:
//   m <- b1*m + (1-b1)*g;  v <- b2*v + (1-b2)*h*h;
//   u = -lr*(m/bc1) / ((v/bc2 + 1e-30)^(kappa/2) + eps) [- lr*wd*p];  p <- p + u.
//
// Bound: device memory. Per element it reads p, g, h, m, v and writes p, m, v:
//   32 bytes against about 17 float operations. On an H100 SXM (3.35 TB/s,
//   67 TFLOP/s f32) the bytes bound it by two orders of magnitude: at k=8,
//   n=1,199,882 a step moves 307 MB, about 92 us.
// Design: one thread per element of the (k, n) buffers with blockIdx.y the worker,
//   so every element is read once and written once, in place, with coalesced
//   4-byte accesses; the tail past n is masked instead of padded. The per-worker
//   bias corrections come from a (2, k) device tensor the kernel reads itself, so
//   nothing is read back to the host. kappa/2 == 0.5 (hessian_power 1, the
//   default) takes sqrtf; any other power takes powf. Vector loads and persistent
//   blocks are left for later.
//
// adahessian_update_flat — one worker's step: the k=1 plain control
//   (repro_torch.train.steps, RunSpec.plain).
// Replaces: src/repro/kernels/adahessian/kernel.py, adahessian_update_flat
//   (the Pallas TPU kernel behind repro.kernels.adahessian.ops.adahessian_step_pallas).
// Plain version: repro_torch.kernels.adahessian.ops.adahessian_step_plain, in the
//   Pallas kernel's op order, with all seven scalars read at run time from a (7,)
//   device tensor [lr, b1, b2, bc1, bc2, kappa/2, eps]:
//   m <- b1*m + (1-b1)*g;  v <- b2*v + (1-b2)*h*h;
//   p <- p - lr*(m/bc1) / (exp(kappa/2 * log(v/bc2 + 1e-30)) + eps).  No weight decay.
// Bound: device memory, as above at k=1: 32 bytes per element, 38.4 MB and about
//   11.5 us at n=1,199,882 on an H100 SXM.
// Design: the batched kernel's at k=1 on a flat (n,) view with the tail masked (the
//   Pallas kernel pads to 256x128 tiles and a benign v of 1); the bias corrections
//   come from the step count on the device (pack_scalars), so nothing is read back
//   to the host per step. The exp-log denominator is kept as the TPU kernel has it.
#include <cuda_runtime.h>

template <bool kSqrt>
__global__ void adahessian_update_batched_kernel(
    float* __restrict__ p, const float* __restrict__ g,
    const float* __restrict__ h, float* __restrict__ m, float* __restrict__ v,
    const float* __restrict__ bc, long long k, long long n, float lr, float b1,
    float one_minus_b1, float b2, float one_minus_b2, float denom_pow,
    float eps, float lrwd) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long w = blockIdx.y;
  const long long off = w * n + i;
  const float bc1 = bc[w];
  const float bc2 = bc[k + w];
  const float gi = g[off];
  const float hi = h[off];
  const float mi = b1 * m[off] + one_minus_b1 * gi;
  const float vi = b2 * v[off] + one_minus_b2 * (hi * hi);
  const float base = vi / bc2 + 1e-30f;
  const float denom = (kSqrt ? sqrtf(base) : powf(base, denom_pow)) + eps;
  const float pi = p[off];
  float u = -lr * (mi / bc1) / denom;
  if (lrwd != 0.0f) u = u - lrwd * pi;
  p[off] = pi + u;
  m[off] = mi;
  v[off] = vi;
}

extern "C" int adahessian_update_batched(
    float* p, const float* g, const float* h, float* m, float* v,
    const float* bc, long long k, long long n, float lr, float b1,
    float one_minus_b1, float b2, float one_minus_b2, float denom_pow,
    float eps, float lrwd, void* stream) {
  if (k <= 0 || n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)k);
  cudaStream_t s = (cudaStream_t)stream;
  if (denom_pow == 0.5f) {
    adahessian_update_batched_kernel<true><<<grid, threads, 0, s>>>(
        p, g, h, m, v, bc, k, n, lr, b1, one_minus_b1, b2, one_minus_b2,
        denom_pow, eps, lrwd);
  } else {
    adahessian_update_batched_kernel<false><<<grid, threads, 0, s>>>(
        p, g, h, m, v, bc, k, n, lr, b1, one_minus_b1, b2, one_minus_b2,
        denom_pow, eps, lrwd);
  }
  return (int)cudaGetLastError();
}

__global__ void adahessian_update_flat_kernel(
    float* __restrict__ p, const float* __restrict__ g,
    const float* __restrict__ h, float* __restrict__ m, float* __restrict__ v,
    const float* __restrict__ s, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float lr = s[0], b1 = s[1], b2 = s[2], bc1 = s[3], bc2 = s[4];
  const float half_k = s[5], eps = s[6];
  const float gi = g[i];
  const float hi = h[i];
  const float mi = b1 * m[i] + (1.0f - b1) * gi;
  const float vi = b2 * v[i] + ((1.0f - b2) * hi) * hi;
  const float denom = expf(half_k * logf(vi / bc2 + 1e-30f)) + eps;
  p[i] = p[i] - (lr * (mi / bc1)) / denom;
  m[i] = mi;
  v[i] = vi;
}

extern "C" int adahessian_update_flat(float* p, const float* g, const float* h,
                                      float* m, float* v, const float* scalars,
                                      long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  adahessian_update_flat_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      p, g, h, m, v, scalars, n);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
