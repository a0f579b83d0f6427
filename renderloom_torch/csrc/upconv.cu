// Nearest x2 upsample followed by a 3x3, stride-1, zero-padded float32
// convolution (+ bias), NHWC in and out, as one implicit-GEMM kernel for
// Hopper: the standard mask net's up path (models/renderer.py:
// MaskGenerator, the up blocks) in float32 inference.
//
// It replaces no TPU kernel: the JAX package leaves upsample2x and the
// convolution to XLA (renderloom/models/renderer.py: MaskGenerator).  It
// was added because cuDNN runs this convolution in float32 (TF32 off)
// through its FFT path, 66-116 ms a call at (7, 80, 120, 256) -> 128 on
// the H100 (PERF.md), and no cuDNN setting picks another algorithm.
//
// The identity.  Output pixel (2i+a, 2j+b) of the upsampled convolution
// sees only the low-resolution rows i-1+a+r and columns j-1+b+s, r, s in
// {0, 1}; the 3x3 taps that land on one low-resolution pixel multiply the
// same value.  So each output parity (a, b) is a 2x2 convolution of the
// low-resolution input whose taps are the 3x3 taps summed per parity
// (folded once per weight on the host, ops/upconv_kernel.py:fold_weights,
// laid out [parity][tap][Cin][Cout], zero-padded to the tile).  Rows and
// columns outside the input are exactly the upsampled tensor's zero
// padding.  4 taps an output where the unfused convolution does 9, and
// the upsampled tensor is never written.  (The fastpath's w_up_d2s,
// models/fastpath.py, uses the same identity with the zero taps kept.)
//
// Bound on the H100: float32 FMA issue (67 TFLOP/s at 700 W): 2 * B*h*w *
// 4 * 4*Cin * Cout operations against one read of x and one write of the
// output; at the main path's shapes the operations take four times the
// bytes' time.  What the design does about it:
//  * FFMA only, each multiply-add one __fmaf_rn (the library is built with
//    --fmad=false, so a * b + c would cost two instructions).  No TF32.
//  * GEMM view per parity: M = B*h*w output pixels, N = Cout, K = 4*Cin;
//    the grid runs over (parity fastest, M tiles; N tiles), so the four
//    parities of one M tile run side by side and share their input in L2.
//  * 256 threads a block, an 8x8 register tile a thread (64 FFMA per 10
//    shared-memory loads), block tiles that follow Cout: 128x128 (Cout >
//    64), 256x64 (Cout > 32), 512x32, so that N is one tile at the main
//    path's widths and A is read once per parity and tap.  K steps of 32
//    channels: on the H100 they ran 6-12% faster than steps of 16 and
//    13-30% faster than steps of 8 (PERF.md).
//  * A (pixels x channels) comes in as 16-byte cp.async along Cin of the
//    NHWC input (4-byte copies where Cin is not a multiple of 4),
//    zero-filled outside the input; B (the folded weights) as 16-byte
//    cp.async, contiguous along Cout.  A ring of three (two for the
//    512x32 tile) (A, B) stages in shared memory keeps the next loads in
//    flight behind the FFMA.
//  * A rows are padded by 4 floats and a thread's 8 rows lie BM/8 apart,
//    so the 8-byte A reads and the 16-byte B reads are free of bank
//    conflicts.
//  * Accuracy: each K step's 32 products are summed from zero in a second
//    register tile and then added to the running sum, so no output is one
//    chain of 4*Cin FFMA on a large running value.  That takes 235-255
//    registers (one block an SM, 8 warps; it measured as fast as two
//    blocks of the single-chain form at 128 registers) and puts the
//    error against float64 below cuDNN's own float32 error at every main
//    path shape (PERF.md), where the single chain's was twice cuDNN's
//    FFT at (7, 40, 60, 256) -> 128.
//  * Epilogue: bias added after the sum, 16-byte stores at (2i+a, 2j+b).
//  * Every output is summed in one fixed order, no atomics: two calls
//    give the same bits.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 4;           // floats after each A row in shared memory
constexpr int kMaxDevices = 64;

struct Shape {
  int B, h, w, cin, cout, cinp, coutp;
};

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  const unsigned sa =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned sa =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// BM x BN output tile of parity blockIdx.x % 4, M tile blockIdx.x / 4, N
// tile blockIdx.y; K in steps of BK channels of one tap (tap-major).
// kStages (A, B) stages in shared memory.  kVec: Cin % 4 == 0 and x
// 16-byte aligned (16-byte copies of A).
template <int BM, int BN, int BK, int kStages, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    upconv_kernel(const float* __restrict__ x, const float* __restrict__ wf,
                  const float* __restrict__ bias, float* __restrict__ out,
                  Shape s) {
  constexpr int TX = BN / 8;                 // threads along N
  constexpr int TY = kThreads / TX;          // threads along M
  static_assert(TY * 8 == BM, "8x8 register tiles cover the block tile");
  constexpr int AS = BK + kPad;              // A row stride (floats)
  constexpr int A_FLOATS = BM * AS;
  constexpr int STAGE = A_FLOATS + BK * BN;
  constexpr int A_CHUNKS = BK / 4;           // 16-byte chunks of an A row
  constexpr int A_STEP = kThreads / A_CHUNKS;
  constexpr int A_ROWS = BM / A_STEP;        // A rows a thread copies
  constexpr int B_CHUNKS = BK * BN / 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int par = blockIdx.x & 3, pa = par >> 1, pb = par & 1;
  const int m0 = (blockIdx.x >> 2) * BM, n0 = blockIdx.y * BN;
  const int M = s.B * s.h * s.w;

  // the low-resolution (i, j) of each A row this thread copies; i = -2
  // past M, so that every tap of it falls outside the input
  const int a_col = (tid % A_CHUNKS) * 4, a_row = tid / A_CHUNKS;
  int ai[A_ROWS], aj[A_ROWS];
#pragma unroll
  for (int p = 0; p < A_ROWS; ++p) {
    const int m = m0 + a_row + p * A_STEP;
    ai[p] = m < M ? (m / s.w) % s.h : -2;
    aj[p] = m < M ? m % s.w : 0;
  }
  const int k_per_tap = s.cinp / BK;
  const int nk = 4 * k_per_tap;

  auto load = [&](int stage, int ks) {
    const int t = ks / k_per_tap, c0 = (ks - t * k_per_tap) * BK;
    const int di = pa + (t >> 1) - 1, dj = pb + (t & 1) - 1;
    float* As = smem + stage * STAGE;
    float* Bs = As + A_FLOATS;
#pragma unroll
    for (int p = 0; p < A_ROWS; ++p) {
      const int row = a_row + p * A_STEP;
      const bool in = (unsigned)(ai[p] + di) < (unsigned)s.h &&
                      (unsigned)(aj[p] + dj) < (unsigned)s.w;
      const size_t pix = (size_t)(m0 + row + di * s.w + dj);
      float* dst = As + row * AS + a_col;
      if (kVec) {
        const int c = c0 + a_col;
        const bool ok = in && c < s.cin;
        copy16(dst, ok ? x + pix * s.cin + c : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + a_col + e;
          const bool ok = in && c < s.cin;
          copy4(dst + e, ok ? x + pix * s.cin + c : x, ok);
        }
      }
    }
    const float* wsrc =
        wf + ((size_t)(par * 4 + t) * s.cinp + c0) * s.coutp + n0;
#pragma unroll
    for (int q = tid; q < B_CHUNKS; q += kThreads) {
      const int r = q / (BN / 4), col = (q % (BN / 4)) * 4;
      copy16(Bs + r * BN + col, wsrc + (size_t)r * s.coutp + col, true);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    commit();
  }
  const int tx = tid % TX, ty = tid / TX;
  for (int ks = 0; ks < nk; ++ks) {
    wait_groups<kStages - 2>();
    __syncthreads();    // step ks landed; step ks - 1's stage is free
    const int next = ks + kStages - 1;
    if (next < nk) load(next % kStages, next);
    commit();
    const float* As = smem + (ks % kStages) * STAGE;
    const float* Bs = As + A_FLOATS;
    float part[8][8];    // this K step's products
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 2) {
      float2 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float2*>(As + (ty + i * TY) * AS +
                                                kk);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* brow = Bs + (kk + q) * BN + tx * 4;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + BN / 2);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = q ? a[i].y : a[i].x;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            part[i][j] = __fmaf_rn(av, b[j], part[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
  }
  wait_groups<0>();

  // epilogue: + bias, stores at (2i + a, 2j + b); columns tx*4 + {0..3}
  // and BN/2 + tx*4 + {0..3} of the tile
  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + (j >> 2) * (BN / 2) + tx * 4 + (j & 3);
    bv[j] = bias != nullptr && n < s.cout ? bias[n] : 0.f;
  }
  const bool vec_out = (s.cout & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + i * TY;
    if (m >= M) continue;
    const int j_ = m % s.w, t = m / s.w, i_ = t % s.h, b_ = t / s.h;
    float* o = out + ((((size_t)b_ * 2 * s.h + 2 * i_ + pa) * 2 * s.w +
                       2 * j_ + pb) *
                      s.cout);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * (BN / 2) + tx * 4;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = acc[i][half * 4 + e] + bv[half * 4 + e];
      if (vec_out && n < s.cout) {
        *reinterpret_cast<float4*>(o + n) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
      } else if (!vec_out) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < s.cout) o[n + e] = v[e];
      }
    }
  }
}

template <int BM, int BN, int BK, int kStages, bool kVec>
cudaError_t launch(const float* x, const float* wf, const float* bias,
                   float* out, const Shape& s, cudaStream_t st) {
  constexpr int smem = kStages * (BM * (BK + kPad) + BK * BN) * 4;
  static bool ready[kMaxDevices] = {};
  auto fn = upconv_kernel<BM, BN, BK, kStages, kVec>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {    // set per card; setting it twice is harmless
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const int m_tiles = (s.B * s.h * s.w + BM - 1) / BM;
  upconv_kernel<BM, BN, BK, kStages, kVec>
      <<<dim3(4 * m_tiles, s.coutp / BN), kThreads, smem, st>>>(x, wf, bias,
                                                                out, s);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, int kStages>
cudaError_t launch_tile(bool vec, const float* x, const float* wf,
                        const float* bias, float* out, const Shape& s,
                        cudaStream_t st) {
  return vec ? launch<BM, BN, BK, kStages, true>(x, wf, bias, out, s, st)
             : launch<BM, BN, BK, kStages, false>(x, wf, bias, out, s, st);
}

}  // namespace

// x (B, h, w, cin) float32 NHWC; wf (4, 4, cinp, coutp) float32, the
// folded weights (ops/upconv_kernel.py:fold_weights) zero-padded to the
// tile's BK and BN; bias (cout) float32 or null; out (B, 2h, 2w, cout)
// float32, written.  tile: 0 = 128x128, 1 = 256x64, 2 = 512x32 (BK 32
// each), as ops/upconv_kernel.py:TILES; vec: Cin % 4 == 0 and x 16-byte
// aligned.  Returns the launch's CUDA error (0: launched).
extern "C" int rl_upconv(const void* x, const void* wf, const void* bias,
                         void* out, int B, int h, int w, int cin, int cout,
                         int cinp, int coutp, int tile, int vec,
                         void* stream) {
  const Shape s{B, h, w, cin, cout, cinp, coutp};
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(wf);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile) {
    case 0:
      err = launch_tile<128, 128, 32, 3>(vec != 0, xp, wp, bp, op, s, st);
      break;
    case 1:
      err = launch_tile<256, 64, 32, 3>(vec != 0, xp, wp, bp, op, s, st);
      break;
    case 2:
      err = launch_tile<512, 32, 32, 2>(vec != 0, xp, wp, bp, op, s, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
