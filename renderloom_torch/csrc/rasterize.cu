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
// What bounds it on the H100.  Evaluating every term at every pixel, as
// the first design did (one thread per pixel), is bound by instruction
// throughput, not by the label's bytes: each skeleton or mask capsule
// costs an IEEE division and each gaussian an accurate expf, with no
// contracted multiply-add, and a pixel walks 37 terms (76 with masks).
// On the H100 that design took 0.29 ms for the f32 label of 29 frames of
// 320x480 and 0.30 ms for the packed bf16 label of half the bytes, and
// the 39 mask capsules doubled its time for 10% more bytes.  Yet nearly
// every term is exactly zero at nearly every pixel: a gaussian
// underflows 72 px from its joint (sigma 5), a skeleton capsule covers
// nothing past 2 * brush = 8 px, a mask capsule nothing past its radius
// (15-30 px).  This design evaluates at each pixel only the terms that
// can reach its tile (about 6% for joints spread over the frame), which leaves
// the label's bytes as the bound: on an NVIDIA H100 80GB HBM3 (700 W) it
// writes the f32 labels at 91-95% of that bound; the bf16 ones, half the
// bytes for the same per-block table load, cull and barriers, at 67-80%.
//
// Design: one block of 256 threads per (tile, frame), one thread per
// full-resolution pixel.  A tile is 16x16 pixels (nhwc; packed: 8x8
// packed pixels, the same area) or 8x32 (cfhw, so that each channel
// plane's row is a 128-byte run).
// 1. Cull.  Warp 0 takes the 19 joints, warp 1 the 18 skeleton capsules,
//    warps 2-3 the 39 mask capsules, one lane per term: it loads the
//    term's table row, writes its per-term invariants to shared memory
//    (dx, dy, max(len2, 1e-6), the squared radius, 0 * valid: the same
//    operations on the same inputs as the per-pixel code had), tests the
//    term against the tile, and the warp's ballot gives the tile's keep
//    mask.  Each thread then walks the kept capsules in ascending table
//    order (find-first-set over the mask), so the sums keep their order;
//    a joint that is not kept writes its channel's constant 0 * valid,
//    and a tile that keeps no skeleton capsule writes its colours as
//    +0 (= +0 / 1) without dividing.
//    The test is `tile_terms` in renderloom_torch/ops/rasterize_kernel.py
//    and must stay conservative: a term is skipped only where it is
//    provably +0 (or, for a gaussian, exactly 0 * valid) at every pixel
//    of the tile, so the result is bit for bit the one of evaluating
//    every term.  Every skip condition is false for NaN:
//    - skeleton capsule: its colours are finite, and its valid flag is 0
//      or its coordinates are bounded (|.| <= 65536, where rounding moves
//      a distance by far less than the 1 px margin) and the tile centre
//      lies farther than 2 * brush + half the tile's diagonal + 1 px from
//      the segment: its cover is then 0 at every pixel and adds +0;
//    - mask capsule: its part flag is finite and >= 0, and its valid flag
//      is +0 or (bounded) the tile centre lies farther than its radius +
//      half-diagonal + 1 px: fmaxf with +0 leaves both masks unchanged;
//    - gaussian: x, y bounded, inv and valid finite, inv >= 0 (so expf
//      cannot overflow), and valid == 0 or the tile's least squared
//      distance times inv exceeds 110.  expf(-a) rounds to +0 for a past
//      103.97 (2^-150); 110 leaves room for the rounding of d2 * inv and
//      of expf, so the channel is exactly +0 * valid.
// 2. Evaluate each pixel over the kept terms only, operation by
//    operation as the plain version does.
// 3. Store.  nhwc and packed: each thread writes its 22 values into a
//    shared staging tile as 8-byte (f32) or 4-byte (bf16) pairs at a
//    stride of 22 elements, which is conflict-free; the tile's rows are
//    contiguous runs of the label (16 x 22 values, nhwc; 8 x 88, packed),
//    one warp per row, written with 16-byte vector stores (one TMA bulk
//    copy per row, cp.async.bulk shared -> global, was timed against
//    them on the H100 and took 5-40% longer).  Where a row's start or
//    length is not a multiple of 16 bytes (odd widths; bf16 with W not a
//    multiple of 4) the kernel stores element by element.  cfhw: each
//    warp is one 32-pixel row, so each thread stores its values straight
//    to the channel planes in coalesced 128-byte (f32) runs.  The masks
//    go straight to (F, H, W) in 64-byte (16 px) or 128-byte runs.
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
#include <stdint.h>

namespace {

constexpr int kJ = 19;
constexpr int kSkel = 18;
constexpr int kCaps = 39;
constexpr int kC = 22;
constexpr int kThreads = 256;
// per-term invariants in shared memory, floats per term
constexpr int kJW = 4;      // x, y, inv, valid
constexpr int kSW = 12;     // ax, ay, bx, by, dx, dy, L, valid, r, g, b, -
constexpr int kCW = 8;      // ax, ay, dx, dy, L, radius^2, valid, part
// the cull rule's constants (rasterize_kernel.tile_terms)
constexpr float kFar = 65536.f;
constexpr float kHeatCut = 110.f;
constexpr float kMargin = 1.f;

enum Layout { kNhwc = 0, kPacked = 1, kCfhw = 2 };

// full-resolution rows and columns of a block's tile
template <int L>
struct Tile {
  static constexpr int R = L == kCfhw ? 8 : 16;
  static constexpr int C = L == kCfhw ? 32 : 16;
};

__device__ __forceinline__ bool fin(float v) {
  return fabsf(v) <= 3.402823466e38f;    // false for inf and NaN
}

__device__ __forceinline__ bool bounded(float a, float b, float c,
                                        float d) {
  return fabsf(a) <= kFar && fabsf(b) <= kFar && fabsf(c) <= kFar &&
         fabsf(d) <= kFar;
}

// squared distance from (px, py) to the segment from (ax, ay) along
// (dx, dy), L = max(dx^2 + dy^2, 1e-6): the plain version's segment_dist2
__device__ __forceinline__ float seg_d2(float px, float py, float ax,
                                        float ay, float dx, float dy,
                                        float L) {
  float t = ((px - ax) * dx + (py - ay) * dy) / L;
  t = fminf(fmaxf(t, 0.f), 1.f);
  const float ex = px - (ax + t * dx);
  const float ey = py - (ay + t * dy);
  return ex * ex + ey * ey;
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// a pixel's 22 label values into its staging slot, as aligned pairs
__device__ __forceinline__ void stage(float* s, const float* v) {
#pragma unroll
  for (int k = 0; k < kC / 2; ++k)
    reinterpret_cast<float2*>(s)[k] = make_float2(v[2 * k], v[2 * k + 1]);
}
__device__ __forceinline__ void stage(__nv_bfloat16* s, const float* v) {
#pragma unroll
  for (int k = 0; k < kC / 2; ++k)
    reinterpret_cast<__nv_bfloat162*>(s)[k] =
        __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
}

// label: the nhwc/packed label, or for cfhw the heatmaps (F, 19, H, W);
// skel_img: cfhw only, the skeleton (F, 3, H, W).
template <typename T, int kLayout>
__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ joints,
              const float* __restrict__ skel,
              const float* __restrict__ caps, T* __restrict__ label,
              T* __restrict__ skel_img, float* __restrict__ mask,
              float* __restrict__ part, int H, int W, float brush) {
  using TL = Tile<kLayout>;
  constexpr int kStage = kLayout == kCfhw ? 1 : kThreads * kC;
  __shared__ float s_j[kJ * kJW];
  __shared__ __align__(16) float s_z[20];   // 0 * valid per joint
  __shared__ float s_s[kSkel * kSW];
  __shared__ float s_c[kCaps * kCW];
  __shared__ unsigned s_keep[4];      // joints, skeleton, caps 0-31, 32-38
  __shared__ __align__(16) T s_out[kStage];

  const int f = blockIdx.y;
  const int ntx = (W + TL::C - 1) / TL::C;
  const int y0 = (blockIdx.x / ntx) * TL::R;
  const int x0 = (blockIdx.x % ntx) * TL::C;
  const bool masks = mask != nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. cull: one lane per term
  if (warp < 4) {
    const float hy = 0.5f * (TL::R - 1), hx = 0.5f * (TL::C - 1);
    const float hd = sqrtf(hy * hy + hx * hx);
    const float cy = (float)y0 + hy, cx = (float)x0 + hx;
    bool keep = false;
    if (warp == 0 && lane < kJ) {
      const float* g = joints + ((size_t)f * kJ + lane) * 4;
      const float x = g[0], y = g[1], inv = g[2], v = g[3];
      float* s = s_j + lane * kJW;
      s[0] = x, s[1] = y, s[2] = inv, s[3] = v;
      s_z[lane] = 0.f * v;
      const float dxm =
          fmaxf(fmaxf((float)x0 - x, x - (float)(x0 + TL::C - 1)), 0.f);
      const float dym =
          fmaxf(fmaxf((float)y0 - y, y - (float)(y0 + TL::R - 1)), 0.f);
      const float dmin2 = dxm * dxm + dym * dym;
      keep = !(fabsf(x) <= kFar && fabsf(y) <= kFar && fin(inv) && fin(v) &&
               inv >= 0.f && (v == 0.f || dmin2 * inv > kHeatCut));
    } else if (warp == 1 && lane < kSkel) {
      const float* g = skel + ((size_t)f * kSkel + lane) * 8;
      const float ax = g[0], ay = g[1], bx = g[2], by = g[3];
      const float dx = bx - ax, dy = by - ay;
      const float L = fmaxf(dx * dx + dy * dy, 1e-6f);
      float* s = s_s + lane * kSW;
      s[0] = ax, s[1] = ay, s[2] = bx, s[3] = by, s[4] = dx, s[5] = dy;
      s[6] = L, s[7] = g[4], s[8] = g[5], s[9] = g[6], s[10] = g[7];
      const float lim = (fabsf(2.f * brush) + hd) + kMargin;
      keep = !(fin(g[5]) && fin(g[6]) && fin(g[7]) &&
               (g[4] == 0.f ||
                (bounded(ax, ay, bx, by) &&
                 seg_d2(cx, cy, ax, ay, dx, dy, L) > lim * lim)));
    } else if (warp >= 2 && masks) {
      const int k = (warp - 2) * 32 + lane;
      if (k < kCaps) {
        const float* g = caps + ((size_t)f * kCaps + k) * 7;
        const float ax = g[0], ay = g[1], bx = g[2], by = g[3];
        const float rad = g[4], v = g[5], pt = g[6];
        const float dx = bx - ax, dy = by - ay;
        const float L = fmaxf(dx * dx + dy * dy, 1e-6f);
        float* s = s_c + k * kCW;
        s[0] = ax, s[1] = ay, s[2] = dx, s[3] = dy, s[4] = L;
        s[5] = rad * rad, s[6] = v, s[7] = pt;
        const float lim = (fabsf(rad) + hd) + kMargin;
        keep = !(fin(pt) && pt >= 0.f &&
                 (__float_as_uint(v) == 0u ||
                  (bounded(ax, ay, bx, by) &&
                   seg_d2(cx, cy, ax, ay, dx, dy, L) > lim * lim)));
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_keep[warp] = m;
  }
  __syncthreads();

  // 2. this thread's pixel
  const int t = threadIdx.x;
  int yi, xi;
  if (kLayout == kPacked) {
    const int q = t >> 2;
    yi = y0 + 2 * (q >> 3) + ((t >> 1) & 1);
    xi = x0 + 2 * (q & 7) + (t & 1);
  } else {
    yi = y0 + t / TL::C;
    xi = x0 + t % TL::C;
  }
  if (yi < H && xi < W) {
    const float ys = (float)yi;
    const float xs = (float)xi;
    const float r_dot = brush * brush;
    const float r_end = (2.f * brush) * (2.f * brush);

    float racc = 0.f, gacc = 0.f, bacc = 0.f, cnt = 0.f;
    for (unsigned m = s_keep[1]; m != 0u; m &= m - 1u) {
      const float* s = s_s + (__ffs(m) - 1) * kSW;
      const float d2 = seg_d2(xs, ys, s[0], s[1], s[4], s[5], s[6]);
      const float dax = xs - s[0], day = ys - s[1];
      const float dbx = xs - s[2], dby = ys - s[3];
      const float da2 = dax * dax + day * day;
      const float db2 = dbx * dbx + dby * dby;
      const float cover =
          (d2 <= r_dot || da2 <= r_end || db2 <= r_end) ? s[7] : 0.f;
      racc = racc + cover * s[8];
      gacc = gacc + cover * s[9];
      bacc = bacc + cover * s[10];
      cnt = cnt + cover;
    }
    float v[kC];
    if (s_keep[1] != 0u) {
      const float denom = fmaxf(cnt, 1.f);
      v[0] = racc / denom;
      v[1] = gacc / denom;
      v[2] = bacc / denom;
    } else {              // nothing kept: +0 / 1 = +0
      v[0] = v[1] = v[2] = 0.f;
    }
    // the joints' constants, then the kept joints' gaussians over them
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float4 z = reinterpret_cast<const float4*>(s_z)[k];
      v[3 + 4 * k] = z.x, v[4 + 4 * k] = z.y, v[5 + 4 * k] = z.z;
      if (k < 4) v[6 + 4 * k] = z.w;
    }
    const unsigned jm = s_keep[0];
    if (jm != 0u) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if ((jm >> j) & 1u) {
          const float* q = s_j + j * kJW;
          const float dx = xs - q[0], dy = ys - q[1];
          const float d2 = dx * dx + dy * dy;
          v[3 + j] = expf(-d2 * q[2]) * q[3];
        }
      }
    }

    if (kLayout == kCfhw) {
      const size_t hw = (size_t)H * W, p = (size_t)yi * W + xi;
      T* sk = skel_img + (size_t)f * 3 * hw + p;
#pragma unroll
      for (int c = 0; c < 3; ++c) store_f(sk + c * hw, v[c]);
      T* hm = label + (size_t)f * kJ * hw + p;
#pragma unroll
      for (int j = 0; j < kJ; ++j) store_f(hm + j * hw, v[3 + j]);
    } else {
      v[0] = v[0] * 2.f - 1.f;
      v[1] = v[1] * 2.f - 1.f;
      v[2] = v[2] * 2.f - 1.f;
      stage(s_out + t * kC, v);
    }

    if (masks) {
      float macc = 0.f, pacc = 0.f;
      unsigned long long m =
          ((unsigned long long)s_keep[3] << 32) | s_keep[2];
      for (; m != 0ull; m &= m - 1ull) {
        const float* c = s_c + (__ffsll(m) - 1) * kCW;
        const float d2 = seg_d2(xs, ys, c[0], c[1], c[2], c[3], c[4]);
        const float cover = d2 <= c[5] ? c[6] : 0.f;
        macc = fmaxf(macc, cover);
        pacc = fmaxf(pacc, cover * c[7]);
      }
      const size_t o = ((size_t)f * H + yi) * W + xi;
      mask[o] = macc;
      part[o] = pacc;
    }
  }
  if (kLayout == kCfhw) return;

  // 3. store the staged tile: `rows` runs of `n` elements, `pitch` apart
  constexpr int kRows = kLayout == kPacked ? TL::R / 2 : TL::R;
  constexpr int kRun = kThreads / kRows * kC;       // staged row, elements
  constexpr int kVec = 16 / sizeof(T);              // elements per 16 B
  int rows, n;
  size_t pitch;
  T* dst;
  if (kLayout == kPacked) {
    const int hp = H >> 1, wp = W >> 1, yp0 = y0 >> 1, xp0 = x0 >> 1;
    rows = min(kRows, hp - yp0);
    n = min(TL::C / 2, wp - xp0) * 4 * kC;
    pitch = (size_t)wp * 4 * kC;
    dst = label + (((size_t)f * hp + yp0) * wp + xp0) * 4 * kC;
  } else {
    rows = min(kRows, H - y0);
    n = min(TL::C, W - x0) * kC;
    pitch = (size_t)W * kC;
    dst = label + (((size_t)f * H + y0) * W + x0) * kC;
  }
  const bool aligned = reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
                       pitch % kVec == 0;
  __syncthreads();
  // one warp per row: 16-byte chunks from consecutive lanes (a fixed
  // count of passes, so no loop state lives across rows), then the row's
  // last few elements; or element by element where unaligned
  const int nv = aligned ? n / kVec : 0;
  for (int r = warp; r < rows; r += kThreads / 32) {
    T* d = dst + r * pitch;
    const T* src = s_out + r * kRun;
#pragma unroll
    for (int k = 0; k < (kRun / kVec + 31) / 32; ++k) {
      const int c = lane + 32 * k;
      if (c < nv)
        reinterpret_cast<uint4*>(d)[c] =
            reinterpret_cast<const uint4*>(src)[c];
    }
    for (int e = nv * kVec + lane; e < n; e += 32) d[e] = src[e];
  }
}

template <typename T, int kLayout>
void launch_one(int F, int H, int W, cudaStream_t st, const float* j,
                const float* s, const float* c, void* label, void* skel_img,
                float* m, float* pm, float brush) {
  using TL = Tile<kLayout>;
  const dim3 grid(((H + TL::R - 1) / TL::R) * ((W + TL::C - 1) / TL::C), F);
  raster_kernel<T, kLayout><<<grid, kThreads, 0, st>>>(
      j, s, c, static_cast<T*>(label), static_cast<T*>(skel_img), m, pm, H,
      W, brush);
}

template <typename T>
void launch(int layout, int F, int H, int W, cudaStream_t st,
            const float* j, const float* s, const float* c, void* label,
            void* skel_img, float* m, float* pm, float brush) {
  if (layout == kPacked)
    launch_one<T, kPacked>(F, H, W, st, j, s, c, label, skel_img, m, pm,
                           brush);
  else if (layout == kCfhw)
    launch_one<T, kCfhw>(F, H, W, st, j, s, c, label, skel_img, m, pm,
                         brush);
  else
    launch_one<T, kNhwc>(F, H, W, st, j, s, c, label, skel_img, m, pm,
                         brush);
}

}  // namespace

// layout: 0 nhwc, 1 packed (H, W even), 2 cfhw (label = heatmaps,
// skel_img = skeleton, masks non-null).  skel_img is null but for cfhw.
extern "C" int rl_rasterize(const void* joints, const void* skel,
                            const void* caps, void* label, void* skel_img,
                            void* mask, void* part, int F, int H, int W,
                            int label_bf16, int layout, float brush,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* j = static_cast<const float*>(joints);
  const float* s = static_cast<const float*>(skel);
  const float* c = static_cast<const float*>(caps);
  float* m = static_cast<float*>(mask);
  float* pm = static_cast<float*>(part);
  if (label_bf16)
    launch<__nv_bfloat16>(layout, F, H, W, st, j, s, c, label, skel_img, m,
                          pm, brush);
  else
    launch<float>(layout, F, H, W, st, j, s, c, label, skel_img, m, pm,
                  brush);
  return static_cast<int>(cudaGetLastError());
}
