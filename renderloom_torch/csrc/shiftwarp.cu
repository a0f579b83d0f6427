// The clipped separable shift-and-blend backward warp (ops/flow.py:
// backward_warp_shift) as a gather, and the Lucas-Kanade backgrounds'
// time blend fused with it (ops/flow.py:upsample_background, flow_scale >
// 1): float32, NHWC in and out.
//
// It replaces no TPU kernel: the JAX package writes the warp as a loop
// over 2R + 2 integer shifts of an edge-padded copy per axis
// (renderloom/ops/flow.py:_shift_resample1d), which XLA fuses.  Run as
// PyTorch ops, that loop is about ten full-size elementwise kernels per
// shift: at the serving pipeline's R = 16, 34 shifts a pass, two passes
// a warp, some 1,400 launches and ~55 GB of temporaries a clip of 8
// keyframes at 320x480, where for every pixel exactly two of the 34
// weights along an axis are not zero.
//
// The identity (exact, bit for bit the loop).  Along an axis, with f
// clamped to [-R, R], f0 = floor(f) and w = f - f0, the loop's sum at
// position i is fl(fl((1 - w) * p[clamp(i + f0)]) + fl(w * p[clamp(i + f0
// + 1)])): the f0 term is added before the f0 + 1 term and every other
// term adds an exact zero.  The vertical pass reads the horizontal
// result at rows r0 = clamp(y + f0y) and r0 + 1; each of those rows was
// resampled with its own x-flow, the one at (r, x), so a pixel takes four
// horizontal taps (two per row) and blends them vertically.  Every
// multiply, add and divide is one round-to-nearest intrinsic, so no
// multiply-add is contracted whatever the flags (the build also passes
// --fmad=false), and the division is IEEE's, as PyTorch's.
//
// rl_shift_warp: (B, H, W, C) image, (B, H, W, 2) flow, any R >= 1.
// rl_shift_warp_blend: keyframes (K, H, W, C), flows (2(K-1), H, W, 2)
// (0->1 of every pair, then 1->0), errors (2(K-1), H, W, 1) ->
// ((K-1)*rate + 1, H, W, C): the keyframes in their slots and at slot
// k*rate + j, t = j * (1 / rate), (a0*w0 + a1*w1) / (a0 + a1) with w0
// keyframe k warped by t*f10, w1 keyframe k+1 by (1-t)*f01, a0 =
// (1-t)/(1+e0), a1 = t/(1+e1), each operation in PyTorch's order.
//
// Bound on the H100: HBM bytes, 3.35 TB/s.  The fused kernel reads each
// flow and error once and writes each output once (about 94 MB a clip of
// 8 keyframes at 320x480, ~0.03 ms); its 4 * C gathers per warped pixel
// hit the keyframes (14.7 MB a clip), which stay in the 50 MB L2.  What
// the design does about it:
//  * one thread per (pair, pixel) that reads its two flow vectors (one
//    8-byte load each: flows start on 8 bytes) and two errors once and
//    loops over the rate - 1 times and the channels; only the x-flows of
//    its source rows are read again per time.
//    A block is 256 consecutive pixels of one pair, so a warp's gathers
//    land on neighbouring pixels of the same rows.
//  * outputs go through shared memory and leave as 16-byte stores of
//    the block's contiguous run of 256 * C floats (4-byte stores at the
//    run's unaligned ends, or when C > 48 and the run would not fit in
//    48 KB of shared memory); the keyframes' slots are copied the same
//    way.
//  * no atomics and no reductions: two calls give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStagedC = 48;   // kThreads * C floats within 48 KB

// Source positions i0, i1 and weight w of offset f at position i of an
// axis of n, f clamped to [-R, R] (a NaN offset stays NaN, as in the
// loop, and its positions are clamped into the axis).
__device__ __forceinline__ void axis_taps(float f, int i, int n, float R,
                                          int& i0, int& i1, float& w) {
  f = f < -R ? -R : (f > R ? R : f);
  const float f0 = floorf(f);
  w = __fsub_rn(f, f0);
  const int d = __float2int_rz(f0);     // exact: |f0| <= R; NaN -> 0
  i0 = min(max(i + d, 0), n - 1);
  i1 = min(max(i + d + 1, 0), n - 1);
}

__device__ __forceinline__ float lerp1(float w, float a, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, w), a), __fmul_rn(w, b));
}

// The shift warp of one pixel (y, x): the four source pixels and the
// three weights.  ``fx`` is the x-flow plane of the image (stride 2
// floats a pixel), scaled by ``s`` as the caller's flow field is.
struct Taps {
  const float *q00, *q01, *q10, *q11;
  float wx0, wx1, wy;
};

__device__ __forceinline__ Taps warp_taps(const float* img, const float* fx,
                                          float s, float fy, int y, int x,
                                          int H, int W, int C, float R) {
  Taps t;
  int r0, r1, a0, a1, b0, b1;
  axis_taps(fy, y, H, R, r0, r1, t.wy);
  axis_taps(__fmul_rn(s, fx[(static_cast<int64_t>(r0) * W + x) * 2]), x, W,
            R, a0, a1, t.wx0);
  axis_taps(__fmul_rn(s, fx[(static_cast<int64_t>(r1) * W + x) * 2]), x, W,
            R, b0, b1, t.wx1);
  const float* row0 = img + static_cast<int64_t>(r0) * W * C;
  const float* row1 = img + static_cast<int64_t>(r1) * W * C;
  t.q00 = row0 + a0 * C;
  t.q01 = row0 + a1 * C;
  t.q10 = row1 + b0 * C;
  t.q11 = row1 + b1 * C;
  return t;
}

__device__ __forceinline__ float warp_channel(const Taps& t, int c) {
  return lerp1(t.wy, lerp1(t.wx0, t.q00[c], t.q01[c]),
               lerp1(t.wx1, t.q10[c], t.q11[c]));
}

// Copy n floats from src (shared or global) to dst (global) with the
// whole block: 16-byte stores between the unaligned ends.
__device__ __forceinline__ void copy_run(float* dst, const float* src,
                                         int64_t n) {
  int64_t head = ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2;
  if (head > n) head = n;
  for (int64_t i = threadIdx.x; i < head; i += kThreads) dst[i] = src[i];
  const int64_t n4 = (n - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  const float* s = src + head;
  if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    for (int64_t i = threadIdx.x; i < n4; i += kThreads) d4[i] = s4[i];
  } else {
    for (int64_t i = threadIdx.x; i < n4; i += kThreads)
      d4[i] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2],
                          s[4 * i + 3]);
  }
  for (int64_t i = head + 4 * n4 + threadIdx.x; i < n; i += kThreads)
    dst[i] = src[i];
}

// rl_shift_warp: one thread per pixel of the flattened (B, H, W).
__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ img, const float* __restrict__ flow,
            float* __restrict__ out, int B, int H, int W, int C, float R,
            bool staged) {
  extern __shared__ float stage[];
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t p = p0 + threadIdx.x;
  const int64_t n = min(static_cast<int64_t>(kThreads), B * HW - p0);
  if (threadIdx.x < n) {
    const int64_t b = p / HW;
    const int yx = static_cast<int>(p - b * HW);
    const int y = yx / W, x = yx - (yx / W) * W;
    const float* fb = flow + b * HW * 2;
    const Taps t = warp_taps(img + b * HW * C, fb, 1.0f,
                             reinterpret_cast<const float2*>(flow)[p].y, y,
                             x, H, W, C, R);
    float* o = staged ? stage + threadIdx.x * C : out + p * C;
    for (int c = 0; c < C; ++c) o[c] = warp_channel(t, c);
  }
  if (staged) {
    __syncthreads();
    copy_run(out + p0 * C, stage, n * C);
  }
}

// rl_shift_warp_blend: one thread per pixel of one keyframe pair
// (blockIdx.y); writes the pair's keyframe slot and its rate - 1
// in-between slots (and the last keyframe's slot, for the last pair).
__global__ void __launch_bounds__(kThreads)
blend_kernel(const float* __restrict__ keys, const float* __restrict__ flows,
             const float* __restrict__ errs, float* __restrict__ out, int K,
             int H, int W, int C, int rate, float R, bool staged) {
  extern __shared__ float stage[];
  const int k = blockIdx.y;
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t p = p0 + threadIdx.x;
  const int64_t n = min(static_cast<int64_t>(kThreads), HW - p0);
  const bool live = threadIdx.x < n;
  const float* img0 = keys + k * HW * C;
  const float* img1 = img0 + HW * C;
  const float* f01 = flows + k * HW * 2;             // keyframe k -> k + 1
  const float* f10 = flows + (K - 1 + k) * HW * 2;   // k + 1 -> k
  float f01y = 0.f, f10y = 0.f, d0 = 1.f, d1 = 1.f;
  int y = 0, x = 0;
  if (live) {
    y = static_cast<int>(p / W);
    x = static_cast<int>(p - static_cast<int64_t>(y) * W);
    f01y = reinterpret_cast<const float2*>(f01)[p].y;
    f10y = reinterpret_cast<const float2*>(f10)[p].y;
    d0 = __fadd_rn(1.0f, errs[k * HW + p]);
    d1 = __fadd_rn(1.0f, errs[(K - 1 + k) * HW + p]);
  }
  // t = j / rate as PyTorch computes it on the card: a tensor divided by
  // a Python number is a product with the rounded reciprocal (j / rate
  // itself wherever rate is 2, 3 or a power of two)
  const float inv_rate = __fdiv_rn(1.0f, static_cast<float>(rate));
  for (int j = 0; j < rate; ++j) {
    float* dst = out + ((static_cast<int64_t>(k) * rate + j) * HW + p0) * C;
    if (j == 0) {                    // the keyframe's slot
      copy_run(dst, img0 + p0 * C, n * C);
      continue;
    }
    if (live) {
      const float t = __fmul_rn(static_cast<float>(j), inv_rate);
      const float s = __fsub_rn(1.0f, t);
      const float a0 = __fdiv_rn(s, d0);
      const float a1 = __fdiv_rn(t, d1);
      const float den = __fadd_rn(a0, a1);
      const Taps t0 = warp_taps(img0, f10, t, __fmul_rn(t, f10y), y, x, H,
                                W, C, R);
      const Taps t1 = warp_taps(img1, f01, s, __fmul_rn(s, f01y), y, x, H,
                                W, C, R);
      float* o = staged ? stage + threadIdx.x * C : dst + threadIdx.x * C;
      for (int c = 0; c < C; ++c) {
        const float w0 = warp_channel(t0, c), w1 = warp_channel(t1, c);
        o[c] = __fdiv_rn(__fadd_rn(__fmul_rn(a0, w0), __fmul_rn(a1, w1)),
                         den);
      }
    }
    if (staged) {
      __syncthreads();
      copy_run(dst, stage, n * C);
      __syncthreads();               // the stage is written again next
    }
  }
  if (k == K - 2) {                  // the last keyframe's slot
    copy_run(out + ((static_cast<int64_t>(K - 1) * rate) * HW + p0) * C,
             img1 + p0 * C, n * C);
  }
}

}  // namespace

extern "C" {

// Returns 0 or the CUDA error of the launch.
int rl_shift_warp(const float* img, const float* flow, float* out, int B,
                  int H, int W, int C, int R, void* stream) {
  const int64_t pixels = static_cast<int64_t>(B) * H * W;
  const bool staged = C <= kMaxStagedC;
  const size_t smem = staged ? sizeof(float) * kThreads * C : 0;
  const unsigned blocks =
      static_cast<unsigned>((pixels + kThreads - 1) / kThreads);
  warp_kernel<<<blocks, kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      img, flow, out, B, H, W, C, static_cast<float>(R), staged);
  return static_cast<int>(cudaGetLastError());
}

int rl_shift_warp_blend(const float* keys, const float* flows,
                        const float* errs, float* out, int K, int H, int W,
                        int C, int rate, int R, void* stream) {
  const int64_t HW = static_cast<int64_t>(H) * W;
  const bool staged = C <= kMaxStagedC;
  const size_t smem = staged ? sizeof(float) * kThreads * C : 0;
  const dim3 grid(static_cast<unsigned>((HW + kThreads - 1) / kThreads),
                  K - 1);
  blend_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      keys, flows, errs, out, K, H, W, C, rate, static_cast<float>(R),
      staged);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
