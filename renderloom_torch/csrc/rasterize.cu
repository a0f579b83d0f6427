// Pose label rasterizer for Hopper: per frame and pixel, the 22-channel
// label [skeleton * 2 - 1 (3 ch), 19 gaussian heatmaps], channel-last,
// and optionally the human mask and the part mask.
//
// Replaces the TPU kernel renderloom/ops/rasterize_pallas.py:
// rasterize_frames_fused with the tables of `_build_tables`, in its three
// layouts:
//   nhwc   label (F, H, W, 22)               Pallas `_kernel_nhwc`;
//   packed label (F, H/2, W/2, 88), channel   Pallas `_kernel_packed`;
//          (row_parity * 2 + col_parity) * 22 + c: space_to_depth of nhwc;
//   cfhw   heatmaps (F, 19, H, W) and skeleton (F, 3, H, W) in [0, 1],
//          masks always                       Pallas `_kernel`.
// `_kernel_cmaj` plus the wrapper's relayout computes the nhwc and packed
// labels; here they are written in the consumer layout directly.
//
// Bound on the H100: device-memory bytes of the label write.  Each pixel
// costs about 19 exponentials and 18 capsule distances (plus 39 more
// capsules when masks are asked for), a few hundred fp32 operations for
// 88 bytes of f32 label, so the write dominates at serving shapes.
//
// Design: one thread per output pixel, a block of kPix consecutive pixels
// of one frame, grid (pixel blocks, frames).  The block loads its frame's
// tables (19x4 + 18x8 + 39x7 floats) into shared memory once.  Each
// thread evaluates its pixel into a shared staging tile; the block then
// stores the tile, which is one contiguous run of the NHWC label, with
// consecutive threads on consecutive addresses.  (The Pallas version
// emits channel-major and transposes afterwards because the TPU compiler
// spills channel-last stores; nothing of that applies here.)
//
// The layouts differ only in which full-resolution pixel a thread takes
// and where it stores.  Packed: the label's element (q, par, c) sits at
// (q * 4 + par) * 22 + c, so with thread index p = q * 4 + par (packed
// pixel q, parity par) the staging tile and its contiguous store are the
// nhwc ones; only the pixel's coordinates change (y = 2 * (q / (W/2)) +
// par / 2, x = 2 * (q % (W/2)) + par % 2), and the full-resolution masks
// are stored at (y, x).  Cfhw: each thread stores its 22 values straight
// to 22 channel planes, consecutive threads on consecutive addresses, no
// staging.
//
// Numerics mirror the plain version operation by operation: squared
// distances compared against squared radii (the masks are bit-exact),
// floored joints for heatmaps and mask capsules, unfloored ones for the
// skeleton, IEEE division and expf (no fast intrinsics), and the build
// flag --fmad=false so no multiply-add is contracted.
//
// C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kJ = 19;
constexpr int kSkel = 18;
constexpr int kCaps = 39;
constexpr int kC = 22;
constexpr int kPix = 128;

enum Layout { kNhwc = 0, kPacked = 1, kCfhw = 2 };

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float seg_dist2(float xs, float ys, float ax,
                                           float ay, float bx, float by) {
  const float dx = bx - ax;
  const float dy = by - ay;
  const float len2 = dx * dx + dy * dy;
  float t = ((xs - ax) * dx + (ys - ay) * dy) / fmaxf(len2, 1e-6f);
  t = fminf(fmaxf(t, 0.f), 1.f);
  const float cx = ax + t * dx;
  const float cy = ay + t * dy;
  const float ex = xs - cx;
  const float ey = ys - cy;
  return ex * ex + ey * ey;
}

// label: the nhwc/packed label, or for cfhw the heatmaps (F, 19, H, W);
// skel_img: cfhw only, the skeleton (F, 3, H, W).
template <typename T, int kLayout>
__global__ void raster_kernel(const float* __restrict__ joints,
                              const float* __restrict__ skel,
                              const float* __restrict__ caps,
                              T* __restrict__ label, T* __restrict__ skel_img,
                              float* __restrict__ mask,
                              float* __restrict__ part, int H, int W,
                              float brush) {
  __shared__ float s_j[kJ * 4];
  __shared__ float s_s[kSkel * 8];
  __shared__ float s_c[kCaps * 7];
  __shared__ float s_out[kPix * kC];

  const int f = blockIdx.y;
  for (int i = threadIdx.x; i < kJ * 4; i += blockDim.x)
    s_j[i] = joints[(size_t)f * kJ * 4 + i];
  for (int i = threadIdx.x; i < kSkel * 8; i += blockDim.x)
    s_s[i] = skel[(size_t)f * kSkel * 8 + i];
  if (mask != nullptr)
    for (int i = threadIdx.x; i < kCaps * 7; i += blockDim.x)
      s_c[i] = caps[(size_t)f * kCaps * 7 + i];
  __syncthreads();

  const int hw = H * W;
  const int p0 = blockIdx.x * kPix;
  const int p = p0 + threadIdx.x;
  if (p < hw) {
    int yi = p / W, xi = p % W;
    if (kLayout == kPacked) {
      const int q = p >> 2, wp = W >> 1;
      yi = 2 * (q / wp) + ((p >> 1) & 1);
      xi = 2 * (q % wp) + (p & 1);
    }
    const float ys = (float)yi;
    const float xs = (float)xi;
    const float r_dot = brush * brush;
    const float r_end = (2.f * brush) * (2.f * brush);

    float racc = 0.f, gacc = 0.f, bacc = 0.f, cnt = 0.f;
    for (int e = 0; e < kSkel; ++e) {
      const float* s = s_s + e * 8;
      const float ax = s[0], ay = s[1], bx = s[2], by = s[3];
      const float d2 = seg_dist2(xs, ys, ax, ay, bx, by);
      const float dax = xs - ax, day = ys - ay;
      const float dbx = xs - bx, dby = ys - by;
      const float da2 = dax * dax + day * day;
      const float db2 = dbx * dbx + dby * dby;
      const float cover =
          (d2 <= r_dot || da2 <= r_end || db2 <= r_end) ? s[4] : 0.f;
      racc = racc + cover * s[5];
      gacc = gacc + cover * s[6];
      bacc = bacc + cover * s[7];
      cnt = cnt + cover;
    }
    const float denom = fmaxf(cnt, 1.f);
    if (kLayout == kCfhw) {
      T* sk = skel_img + (size_t)f * 3 * hw + p;
      store_f(sk, racc / denom);
      store_f(sk + hw, gacc / denom);
      store_f(sk + 2 * hw, bacc / denom);
      for (int j = 0; j < kJ; ++j) {
        const float* q = s_j + j * 4;
        const float dx = xs - q[0], dy = ys - q[1];
        const float d2 = dx * dx + dy * dy;
        store_f(label + ((size_t)f * kJ + j) * hw + p,
                expf(-d2 * q[2]) * q[3]);
      }
    } else {
      float* o = s_out + threadIdx.x * kC;
      o[0] = (racc / denom) * 2.f - 1.f;
      o[1] = (gacc / denom) * 2.f - 1.f;
      o[2] = (bacc / denom) * 2.f - 1.f;
      for (int j = 0; j < kJ; ++j) {
        const float* q = s_j + j * 4;
        const float dx = xs - q[0], dy = ys - q[1];
        const float d2 = dx * dx + dy * dy;
        o[3 + j] = expf(-d2 * q[2]) * q[3];
      }
    }

    if (mask != nullptr) {
      float macc = 0.f, pacc = 0.f;
      for (int k = 0; k < kCaps; ++k) {
        const float* c = s_c + k * 7;
        const float d2 = seg_dist2(xs, ys, c[0], c[1], c[2], c[3]);
        const float cover = d2 <= c[4] * c[4] ? c[5] : 0.f;
        macc = fmaxf(macc, cover);
        pacc = fmaxf(pacc, cover * c[6]);
      }
      const size_t m = (size_t)f * hw + (size_t)yi * W + xi;
      mask[m] = macc;
      part[m] = pacc;
    }
  }
  if (kLayout == kCfhw) return;
  __syncthreads();

  const int n = min(kPix, hw - p0) * kC;
  T* dst = label + ((size_t)f * hw + p0) * kC;
  for (int i = threadIdx.x; i < n; i += blockDim.x) store_f(dst + i, s_out[i]);
}

template <typename T>
void launch(const dim3 grid, cudaStream_t st, int layout, const float* j,
            const float* s, const float* c, void* label, void* skel_img,
            float* m, float* pm, int H, int W, float brush) {
  T* lb = static_cast<T*>(label);
  T* sk = static_cast<T*>(skel_img);
  if (layout == kPacked) {
    raster_kernel<T, kPacked><<<grid, kPix, 0, st>>>(j, s, c, lb, sk, m, pm,
                                                     H, W, brush);
  } else if (layout == kCfhw) {
    raster_kernel<T, kCfhw><<<grid, kPix, 0, st>>>(j, s, c, lb, sk, m, pm, H,
                                                   W, brush);
  } else {
    raster_kernel<T, kNhwc><<<grid, kPix, 0, st>>>(j, s, c, lb, sk, m, pm, H,
                                                   W, brush);
  }
}

}  // namespace

// layout: 0 nhwc, 1 packed (H, W even), 2 cfhw (label = heatmaps,
// skel_img = skeleton, masks non-null).  skel_img is null but for cfhw.
extern "C" int rl_rasterize(const void* joints, const void* skel,
                            const void* caps, void* label, void* skel_img,
                            void* mask, void* part, int F, int H, int W,
                            int label_bf16, int layout, float brush,
                            void* stream) {
  const dim3 grid((H * W + kPix - 1) / kPix, F);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* j = static_cast<const float*>(joints);
  const float* s = static_cast<const float*>(skel);
  const float* c = static_cast<const float*>(caps);
  float* m = static_cast<float*>(mask);
  float* pm = static_cast<float*>(part);
  if (label_bf16) {
    launch<__nv_bfloat16>(grid, st, layout, j, s, c, label, skel_img, m, pm,
                          H, W, brush);
  } else {
    launch<float>(grid, st, layout, j, s, c, label, skel_img, m, pm, H, W,
                  brush);
  }
  return static_cast<int>(cudaGetLastError());
}
