// Instance norm (+ per-channel affine, + leaky) over NHWC, for Hopper.
//
// Replaces the TPU kernel renderloom/ops/norm_pallas.py:instance_norm_fused
// (Pallas body `_kernel`), non-parity forward only.
//
// Bound on the H100: device-memory bytes.  A global normalization has to
// see all of x before it can write anything, so the floor is one read and
// one write of x; this design reads x twice (moments, then apply) and
// writes once, about 3 passes.  At the serving shapes (C = 16..512) the
// arithmetic is a few operations per byte, far below the card's ratio.
//
// Design:
//  * Pass 1 (moments_kernel): grid (splits, C-tiles, B).  Threads run
//    along C, so a warp reads consecutive channels of consecutive pixels
//    (coalesced in NHWC).  Each block sums one contiguous range of pixels
//    in fp32 and writes its partial sums to scratch: no float atomics,
//    because blocks run in no order and the result must not depend on it.
//  * Pass 2 (apply_kernel): same grid.  Every block reduces the partials
//    of its channels in split order (the same fixed order in every block
//    and on every run), then normalizes its pixel range.
//  * Numerics follow the fp32 contract of renderloom/models/layers.py
//    (_in_moments / _in_apply), not the Pallas kernel's unshifted sums:
//    moments are taken of (x - s) with s = x[b, 0, 0, c], and the apply is
//    the centered form ((x - s) - m1) * inv * gamma + beta, so a large
//    per-channel mean (4096 with std 1e-2) keeps its variance.
//
// C interface for ctypes; returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// grid (n_split, ceil(C / ct), B), block (ct, kThreads / ct); ct is a
// power of two <= 32, so blockDim.y is a power of two too.
template <typename T>
__global__ void moments_kernel(const T* __restrict__ x,
                               float* __restrict__ partial, int n_px, int C,
                               int rows_per_split) {
  __shared__ float sh1[kThreads];
  __shared__ float sh2[kThreads];
  const int ct = blockDim.x;
  const int c = blockIdx.y * ct + threadIdx.x;
  const int b = blockIdx.z;
  const int split = blockIdx.x;
  const int r0 = split * rows_per_split;
  const int r1 = min(n_px, r0 + rows_per_split);
  const T* xb = x + (size_t)b * n_px * C;

  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const float shift = load_f(xb + c);
    for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const float d = load_f(xb + (size_t)r * C + c) - shift;
      s1 += d;
      s2 += d * d;
    }
  }
  const int tid = threadIdx.y * ct + threadIdx.x;
  sh1[tid] = s1;
  sh2[tid] = s2;
  __syncthreads();
  for (int stride = blockDim.y / 2; stride > 0; stride >>= 1) {
    if (threadIdx.y < stride) {
      sh1[tid] += sh1[tid + stride * ct];
      sh2[tid] += sh2[tid + stride * ct];
    }
    __syncthreads();
  }
  if (threadIdx.y == 0 && c < C) {
    float* p = partial + ((size_t)b * gridDim.x + split) * 2 * C;
    p[c] = sh1[threadIdx.x];
    p[C + c] = sh2[threadIdx.x];
  }
}

template <typename T>
__global__ void apply_kernel(const T* __restrict__ x, T* __restrict__ out,
                             const float* __restrict__ partial,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias, int n_px, int C,
                             int rows_per_split, int leaky, float slope,
                             float eps) {
  __shared__ float s_m1[32];
  __shared__ float s_inv[32];
  const int ct = blockDim.x;
  const int c = blockIdx.y * ct + threadIdx.x;
  const int b = blockIdx.z;
  const int n_split = gridDim.x;

  if (threadIdx.y == 0 && c < C) {
    const float* p = partial + (size_t)b * n_split * 2 * C;
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < n_split; ++k) {  // fixed order: deterministic
      s1 += p[(size_t)k * 2 * C + c];
      s2 += p[(size_t)k * 2 * C + C + c];
    }
    const float m1 = s1 / (float)n_px;
    const float m2 = s2 / (float)n_px;
    const float var = fmaxf(m2 - m1 * m1, 0.f);
    s_m1[threadIdx.x] = m1;
    s_inv[threadIdx.x] = rsqrtf(var + eps);
  }
  __syncthreads();
  if (c >= C) return;

  const float m1 = s_m1[threadIdx.x];
  const float inv = s_inv[threadIdx.x];
  const float g = scale ? scale[c] : 1.f;
  const float be = bias ? bias[c] : 0.f;
  const T* xb = x + (size_t)b * n_px * C;
  T* ob = out + (size_t)b * n_px * C;
  const float shift = load_f(xb + c);
  const int r0 = blockIdx.x * rows_per_split;
  const int r1 = min(n_px, r0 + rows_per_split);
  for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
    const size_t i = (size_t)r * C + c;
    float y = ((load_f(xb + i) - shift) - m1) * inv;
    if (scale) {
      y = y * g;
      y = y + be;
    }
    if (leaky) y = y >= 0.f ? y : y * slope;
    store_f(ob + i, y);
  }
}

template <typename T>
void launch(const void* x, void* out, const float* scale, const float* bias,
            float* partial, int B, int n_px, int C, int leaky, float slope,
            float eps, int n_split, int rows_per_split, int ct,
            cudaStream_t stream) {
  const dim3 grid(n_split, (C + ct - 1) / ct, B);
  const dim3 block(ct, kThreads / ct);
  moments_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), partial, n_px, C, rows_per_split);
  apply_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), partial, scale, bias,
      n_px, C, rows_per_split, leaky, slope, eps);
}

}  // namespace

extern "C" int rl_instance_norm(const void* x, void* out, const void* scale,
                                const void* bias, void* partial, int B,
                                int n_px, int C, int is_bf16, int leaky,
                                float slope, float eps, int n_split,
                                int rows_per_split, int ct, void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* part = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>(x, out, s, bi, part, B, n_px, C, leaky, slope, eps,
                          n_split, rows_per_split, ct, st);
  } else {
    launch<float>(x, out, s, bi, part, B, n_px, C, leaky, slope, eps,
                  n_split, rows_per_split, ct, st);
  }
  return static_cast<int>(cudaGetLastError());
}
