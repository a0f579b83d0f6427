// Instance norm (+ per-channel affine, + leaky) over NHWC, for Hopper:
// the forward (K2) and its backward (K2b).
//
// K2 replaces the TPU kernel renderloom/ops/norm_pallas.py:
// instance_norm_fused (Pallas body `_kernel`), forward, parity=False and
// parity=True.
// K2b replaces the custom VJP renderloom/models/layers.py:_in_bwd, which
// the JAX package wrote by hand (jnp, no Pallas kernel).
//
// Bound on the H100: device-memory bytes.  A global normalization has to
// see all of x before it can write anything, so the floor is one read and
// one write of x (forward), one read of x and dy and one write of dx
// (backward); each design here reads its inputs twice, about 3 passes
// (forward) and 5 (backward) where 2 and 3 would do.  The arithmetic is a
// few operations per byte, far below the card's ratio.
//
// Design:
//  * Forward pass 1 (moments_kernel): grid (splits, C-tiles, B).  Threads
//    run along C, so a warp reads consecutive channels of consecutive
//    pixels (coalesced in NHWC).  Each block sums one contiguous range of
//    pixels in fp32 and writes its partial sums to scratch: no float
//    atomics, because blocks run in no order and the result must not
//    depend on it.
//  * Forward pass 2 (apply_kernel): same grid.  Every block reduces the
//    partials of its channels in split order (the same fixed order in
//    every block and on every run), then normalizes its pixel range.  For
//    training, the blocks of split 0 also write the per-(B, C) residuals
//    (s, m1, inv) that the backward reads, so it never recomputes the
//    moments (which would be a third read of x).
//  * Numerics follow the fp32 contract of renderloom/models/layers.py
//    (_in_moments / _in_apply), not the Pallas kernel's unshifted sums:
//    moments are taken of (x - s) with s = x[b, 0, 0, c], and the apply is
//    the centered form ((x - s) - m1) * inv * gamma + beta, so a large
//    per-channel mean (4096 with std 1e-2) keeps its variance.
//  * Parity (space-to-depth input, channel (p*2+q)*Cg + c, the layout of
//    renderloom/models/fastpath.py): the statistics are the full-resolution
//    ones, the average over the four parity groups of each group's moments
//    (fastpath.py:instance_norm_p4).  A pre-pass (parity_shift_kernel)
//    takes one shift per (b, c) shared by the four groups, the parity
//    average of the means of packed row 0, so the combined shifted
//    moments stay exact algebra; the moments pass subtracts it, and the
//    apply pass reduces the partials of channels c, Cg+c, 2Cg+c, 3Cg+c
//    (each in split order, then the groups in order) before it writes
//    (d - m1) * (inv * gamma) + beta.  Still no float atomics.  Parity has
//    no backward: the JAX kernel is inference-only.
//  * Backward pass 1 (bwd_partial_kernel): the forward's grid; each block
//    sums dz and dz * xhat over its pixel range into scratch, where xhat
//    is recomputed from x and the residuals and dz is dy through the fused
//    leaky (slope where the recomputed pre-leaky value is negative).
//  * Backward pass 2 (bwd_apply_kernel): each block reduces the partials
//    of its channels in split order, forms E[g] and E[g * xhat] with
//    g = dz * gamma, and writes dx = ((g - E[g]) - xhat * E[g * xhat]) *
//    inv over its range.  dgamma and dbeta (bwd_param_kernel) sum the
//    same partials over B and the splits in a fixed order.
//
// C interface for ctypes; each entry returns cudaGetLastError() after its
// launches.

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
// Parity pre-pass: shift[b, c] = mean over the four groups g of the mean
// of packed row 0 (w pixels) of channel g * Cg + c.  grid (ceil(Cg / ct),
// B), block (ct, kThreads / ct); a fixed-order tree over the row.
template <typename T>
__global__ void parity_shift_kernel(const T* __restrict__ x,
                                    float* __restrict__ shift, int n_px,
                                    int C, int w) {
  __shared__ float sh[4][kThreads];
  const int ct = blockDim.x;
  const int Cg = C / 4;
  const int c = blockIdx.x * ct + threadIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.y * ct + threadIdx.x;
  const T* row = x + (size_t)b * n_px * C;
  for (int g = 0; g < 4; ++g) {
    float s = 0.f;
    if (c < Cg)
      for (int j = threadIdx.y; j < w; j += blockDim.y)
        s += load_f(row + (size_t)j * C + g * Cg + c);
    sh[g][tid] = s;
  }
  __syncthreads();
  for (int stride = blockDim.y / 2; stride > 0; stride >>= 1) {
    if (threadIdx.y < stride)
      for (int g = 0; g < 4; ++g) sh[g][tid] += sh[g][tid + stride * ct];
    __syncthreads();
  }
  if (threadIdx.y == 0 && c < Cg) {
    float acc = 0.f;
    for (int g = 0; g < 4; ++g) acc += sh[g][threadIdx.x] / (float)w;
    shift[(size_t)b * Cg + c] = acc / 4.f;
  }
}

// shift_tab (parity only): the (B, C / 4) shifts of parity_shift_kernel;
// null takes s = x[b, 0, 0, c].
__device__ __forceinline__ int group_channel(int c, int C) {
  return c % (C / 4);
}

template <typename T>
__global__ void moments_kernel(const T* __restrict__ x,
                               const float* __restrict__ shift_tab,
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
    const float shift =
        shift_tab ? shift_tab[(size_t)b * (C / 4) + group_channel(c, C)]
                  : load_f(xb + c);
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
                             const float* __restrict__ shift_tab,
                             const float* __restrict__ partial,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             float* __restrict__ stats, int n_px, int C,
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
    float m1, m2;
    if (shift_tab) {  // parity: average the four groups' moments
      const int Cg = C / 4;
      const int cg = group_channel(c, C);
      float a1 = 0.f, a2 = 0.f;
      for (int g = 0; g < 4; ++g) {
        const int ch = g * Cg + cg;
        float s1 = 0.f, s2 = 0.f;
        for (int k = 0; k < n_split; ++k) {  // fixed order: deterministic
          s1 += p[(size_t)k * 2 * C + ch];
          s2 += p[(size_t)k * 2 * C + C + ch];
        }
        a1 += s1 / (float)n_px;
        a2 += s2 / (float)n_px;
      }
      m1 = a1 / 4.f;
      m2 = a2 / 4.f;
    } else {
      float s1 = 0.f, s2 = 0.f;
      for (int k = 0; k < n_split; ++k) {  // fixed order: deterministic
        s1 += p[(size_t)k * 2 * C + c];
        s2 += p[(size_t)k * 2 * C + C + c];
      }
      m1 = s1 / (float)n_px;
      m2 = s2 / (float)n_px;
    }
    const float var = fmaxf(m2 - m1 * m1, 0.f);
    const float inv = rsqrtf(var + eps);
    s_m1[threadIdx.x] = m1;
    s_inv[threadIdx.x] = inv;
    if (stats && blockIdx.x == 0) {  // residuals for the backward
      float* st = stats + ((size_t)b * C + c) * 3;
      st[0] = load_f(x + (size_t)b * n_px * C + c);
      st[1] = m1;
      st[2] = inv;
    }
  }
  __syncthreads();
  if (c >= C) return;

  const float m1 = s_m1[threadIdx.x];
  const float inv = s_inv[threadIdx.x];
  const float g = scale ? scale[c] : 1.f;
  const float be = bias ? bias[c] : 0.f;
  const T* xb = x + (size_t)b * n_px * C;
  T* ob = out + (size_t)b * n_px * C;
  const int r0 = blockIdx.x * rows_per_split;
  const int r1 = min(n_px, r0 + rows_per_split);
  if (shift_tab) {
    // instance_norm_p4's order: (d - m1) * a with a = inv * gamma, + beta
    const float shift = shift_tab[(size_t)b * (C / 4) + group_channel(c, C)];
    const float a = scale ? inv * g : inv;
    for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const size_t i = (size_t)r * C + c;
      float y = ((load_f(xb + i) - shift) - m1) * a;
      if (bias) y = y + be;
      if (leaky) y = y >= 0.f ? y : y * slope;
      store_f(ob + i, y);
    }
    return;
  }
  const float shift = load_f(xb + c);
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

// Backward pass 1: per (split, C-tile, b), partial sums of dz and
// dz * xhat over the split's pixels.
template <typename T>
__global__ void bwd_partial_kernel(const T* __restrict__ x,
                                   const T* __restrict__ dy,
                                   const float* __restrict__ stats,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ bias,
                                   float* __restrict__ partial, int n_px,
                                   int C, int rows_per_split, int leaky,
                                   float slope) {
  __shared__ float sh1[kThreads];
  __shared__ float sh2[kThreads];
  const int ct = blockDim.x;
  const int c = blockIdx.y * ct + threadIdx.x;
  const int b = blockIdx.z;
  const int split = blockIdx.x;
  const int r0 = split * rows_per_split;
  const int r1 = min(n_px, r0 + rows_per_split);

  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const float* st = stats + ((size_t)b * C + c) * 3;
    const float shift = st[0], m1 = st[1], inv = st[2];
    const float g = scale ? scale[c] : 1.f;
    const float be = bias ? bias[c] : 0.f;
    const T* xb = x + (size_t)b * n_px * C;
    const T* db = dy + (size_t)b * n_px * C;
    for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const size_t i = (size_t)r * C + c;
      const float xhat = ((load_f(xb + i) - shift) - m1) * inv;
      float d = load_f(db + i);
      if (leaky) {
        float z = xhat;  // the forward's pre-leaky value, bit for bit
        if (scale) {
          z = z * g;
          z = z + be;
        }
        if (!(z >= 0.f)) d = d * slope;
      }
      s1 += d;
      s2 += d * xhat;
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

// Backward pass 2: dx over the block's pixel range.
template <typename T>
__global__ void bwd_apply_kernel(const T* __restrict__ x,
                                 const T* __restrict__ dy,
                                 const float* __restrict__ stats,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ partial,
                                 T* __restrict__ dx, int n_px, int C,
                                 int rows_per_split, int leaky, float slope) {
  __shared__ float s_mg[32];
  __shared__ float s_mgx[32];
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
    const float g = scale ? scale[c] : 1.f;
    s_mg[threadIdx.x] = (g * s1) / (float)n_px;   // E[g]
    s_mgx[threadIdx.x] = (g * s2) / (float)n_px;  // E[g * xhat]
  }
  __syncthreads();
  if (c >= C) return;

  const float* st = stats + ((size_t)b * C + c) * 3;
  const float shift = st[0], m1 = st[1], inv = st[2];
  const float g = scale ? scale[c] : 1.f;
  const float be = bias ? bias[c] : 0.f;
  const float mg = s_mg[threadIdx.x];
  const float mgx = s_mgx[threadIdx.x];
  const T* xb = x + (size_t)b * n_px * C;
  const T* db = dy + (size_t)b * n_px * C;
  T* ob = dx + (size_t)b * n_px * C;
  const int r0 = blockIdx.x * rows_per_split;
  const int r1 = min(n_px, r0 + rows_per_split);
  for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
    const size_t i = (size_t)r * C + c;
    const float xhat = ((load_f(xb + i) - shift) - m1) * inv;
    float d = load_f(db + i);
    if (leaky) {
      float z = xhat;
      if (scale) {
        z = z * g;
        z = z + be;
      }
      if (!(z >= 0.f)) d = d * slope;
    }
    const float gg = scale ? d * g : d;
    store_f(ob + i, ((gg - mg) - xhat * mgx) * inv);
  }
}

// dgamma = sum over (b, pixels) of dz * xhat, dbeta = sum of dz: one
// thread per channel, batch then split in a fixed order.
__global__ void bwd_param_kernel(const float* __restrict__ partial,
                                 float* __restrict__ dscale,
                                 float* __restrict__ dbias, int B,
                                 int n_split, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sb = 0.f, sg = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = partial + (size_t)b * n_split * 2 * C;
    float pb = 0.f, pg = 0.f;
    for (int k = 0; k < n_split; ++k) {
      pb += p[(size_t)k * 2 * C + c];
      pg += p[(size_t)k * 2 * C + C + c];
    }
    sb += pb;
    sg += pg;
  }
  dbias[c] = sb;
  dscale[c] = sg;
}

// shift (parity only): (B, C / 4) scratch for the pre-pass, which reads
// the first `width` pixels (packed row 0); null for the standard norm.
template <typename T>
void launch(const void* x, void* out, const float* scale, const float* bias,
            float* partial, float* stats, float* shift, int width, int B,
            int n_px, int C, int leaky, float slope, float eps, int n_split,
            int rows_per_split, int ct, cudaStream_t stream) {
  const dim3 grid(n_split, (C + ct - 1) / ct, B);
  const dim3 block(ct, kThreads / ct);
  const T* xt = static_cast<const T*>(x);
  if (shift) {
    const int Cg = C / 4;
    int sct = 1;
    while (sct < Cg && sct < 32) sct <<= 1;
    parity_shift_kernel<T><<<dim3((Cg + sct - 1) / sct, B),
                             dim3(sct, kThreads / sct), 0, stream>>>(
        xt, shift, n_px, C, width);
  }
  moments_kernel<T><<<grid, block, 0, stream>>>(xt, shift, partial, n_px, C,
                                                rows_per_split);
  apply_kernel<T><<<grid, block, 0, stream>>>(
      xt, static_cast<T*>(out), shift, partial, scale, bias, stats, n_px, C,
      rows_per_split, leaky, slope, eps);
}

template <typename T>
void launch_bwd(const void* x, const void* dy, const float* stats,
                const float* scale, const float* bias, void* dx,
                float* dscale, float* dbias, float* partial, int B, int n_px,
                int C, int leaky, float slope, int n_split,
                int rows_per_split, int ct, cudaStream_t stream) {
  const dim3 grid(n_split, (C + ct - 1) / ct, B);
  const dim3 block(ct, kThreads / ct);
  bwd_partial_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), stats, scale,
      bias, partial, n_px, C, rows_per_split, leaky, slope);
  bwd_apply_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), stats, scale,
      bias, partial, static_cast<T*>(dx), n_px, C, rows_per_split, leaky,
      slope);
  if (dscale) {
    bwd_param_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        partial, dscale, dbias, B, n_split, C);
  }
}

}  // namespace

// shift non-null selects the parity norm (C divisible by 4, `width` the
// packed tensor's W); stats must then be null.
extern "C" int rl_instance_norm(const void* x, void* out, const void* scale,
                                const void* bias, void* partial, void* stats,
                                void* shift, int width, int B, int n_px,
                                int C, int is_bf16, int leaky, float slope,
                                float eps, int n_split, int rows_per_split,
                                int ct, void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* part = static_cast<float*>(partial);
  float* st = static_cast<float*>(stats);
  float* sh = static_cast<float*>(shift);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>(x, out, s, bi, part, st, sh, width, B, n_px, C,
                          leaky, slope, eps, n_split, rows_per_split, ct, cs);
  } else {
    launch<float>(x, out, s, bi, part, st, sh, width, B, n_px, C, leaky,
                  slope, eps, n_split, rows_per_split, ct, cs);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rl_instance_norm_bwd(const void* x, const void* dy,
                                    const void* stats, const void* scale,
                                    const void* bias, void* dx, void* dscale,
                                    void* dbias, void* partial, int B,
                                    int n_px, int C, int is_bf16, int leaky,
                                    float slope, int n_split,
                                    int rows_per_split, int ct,
                                    void* stream) {
  const float* st = static_cast<const float*>(stats);
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  float* part = static_cast<float*>(partial);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch_bwd<__nv_bfloat16>(x, dy, st, s, bi, dx, ds, db, part, B, n_px,
                              C, leaky, slope, n_split, rows_per_split, ct,
                              cs);
  } else {
    launch_bwd<float>(x, dy, st, s, bi, dx, ds, db, part, B, n_px, C, leaky,
                      slope, n_split, rows_per_split, ct, cs);
  }
  return static_cast<int>(cudaGetLastError());
}
