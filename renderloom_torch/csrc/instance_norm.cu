// Instance norm (+ per-channel affine, + leaky) over NHWC, for Hopper:
// the forward (K2: standard, with residuals, parity, r3centered) and its
// backward (K2b).
//
// K2 replaces the TPU kernel renderloom/ops/norm_pallas.py:
// instance_norm_fused (Pallas body `_kernel`), forward, parity=False and
// parity=True.  Its r3centered mode is the bf16 dispatch of
// renderloom/models/layers.py:instance_norm (:226-236), which the JAX
// package leaves to XLA (no Pallas kernel).
// K2b replaces the custom VJP renderloom/models/layers.py:_in_bwd, which
// the JAX package wrote by hand (jnp, no Pallas kernel), and in its
// r3centered mode the gradient JAX's autodiff takes of the bf16 dispatch
// (layers.py:226-236; no custom VJP there either).
//
// Bound on the H100: device-memory bytes.  A global normalization has to
// see all of x before it can write anything, so the floor is one read and
// one write of x (forward), one read of x and dy and one write of dx
// (backward).  The arithmetic is a few operations per byte, far below the
// card's ratio.
//
// Two paths, one launch per call either way; the host plan
// (ops/norm_kernel.py:_plan) picks one from the shape and the card alone.
//
// THE CLUSTER PATH (cluster_fwd / cluster_bwd; the r3centered mode only,
// wherever a slab fits in one thread-block cluster with at most 2048
// pixels a block: every bf16 main-path call of 80x120 pixels or fewer).
// What bounds a small call is a fixed device floor, not bytes: measured
// on the grid path (scripts/norm_probe_h100.py, H100), a launch costs
// ~1.9 us whatever its grid, each grid barrier 1.1-1.45 us, and the
// shared-memory tree of column_sums (up to 7 block barriers per value, 8
// values, twice in the affine backward) took 9.4 of the smallest
// backward's 18.6 us.  This path takes each of them away:
//  * An ordinary launch with a cluster dimension, one cluster per slab
//    (batch element b, G channels, G*2 bytes >= 32 so that rows stay
//    sector-sized), `cluster` blocks of `rows` pixels, 512 threads (the
//    forward with a bf16 output) or 256 (the float32 output and the
//    backward, where 512 measured slower), and dynamic shared memory
//    sized to the slab, at most half an SM so that two blocks share one,
//    not the grid path's 200 KB.  Clusters of 1-8 blocks (the portable
//    sizes); a slab that fits in none takes the grid path.  The plan
//    picks the split by a rule measured on the H100 (ops/norm_kernel.py:
//    _plan); this file sizes the launch (threads, shared memory) itself.
//  * The forward copies its rows of x into shared memory once with
//    16-byte cp.async.  The backward knows xhat from the residuals from the
//    start, so one pass reads its rows of x and dy from device memory (16
//    bytes a row, several rows in flight a thread), sums, and keeps x and
//    g (exact in bf16) in shared memory: 4 bytes an element on chip where
//    x and a float32 dy would take 6, and the apply does not recompute g.
//  * The block's partial sums: per thread over its rows, inside the warp
//    by shuffles (the rows of a column lie Cv = G / 8 lanes apart), then
//    the warps in order: one block barrier, no tree.
//  * The exchange: each block writes its partial sums into its slot in
//    every block of the cluster (distributed shared memory), one cluster
//    barrier, and each block adds the slots in rank order, so every block
//    of the slab has the same bits.  The barrier's first arrive, at the
//    kernel's start, tells the other blocks that this one runs before
//    any writes into it.  A cluster of one block has no cluster barrier.
//    No grid barrier, no partial rows in L2.
//  * The apply runs from shared memory; the block of rank 0 writes the
//    residuals (0, m1, inv).
//  * dgamma and dbeta (the backward at an affine call site): rank 0 of
//    each slab writes the slab's two sums to a (B, 2, C) table in a
//    per-device, per-stream workspace, and the last slab to finish (an
//    integer count in the same workspace, raised with atomicAdd after a
//    __threadfence and reset by that block) adds the table over b in
//    batch order.  No float atomics: two calls give the same bits.
//  * A refused launch (too many blocks in a cluster, too much shared
//    memory) is returned as its error; the wrapper raises.
// What bounds it now (PERF.md): at the smallest calls the launch itself
// (~1.9 of 3.7 us forward, of 6.2 backward with the dgamma/dbeta tail);
// at 40x60 to 80x120 the serial load, sums and apply of each block.
//
// THE GRID PATH (norm_fwd_kernel / norm_bwd_kernel): every other call
// (the shifted and parity norms, their backward, and the r3centered
// calls whose slab does not fit in a cluster: the 160x240 and 320x480
// ones).  What bounds it at those sizes is the chain of phases within a
// block, not the barriers: at (4, 320, 480, 32) the backward spends 63
// us loading, 54 summing, 33 reducing the partial rows from L2 and 33
// applying of its 199 (the same probe).  Each call is ONE cooperative
// launch of a persistent grid (every SM, one 512-thread block with 200
// KB of shared memory on each), and each input byte is read from device
// memory once:
//
//  * Work unit and chunks.  The work unit is a slab: one batch element b
//    and a group of G channels (all C where a batch element fits), so a
//    block's share of a slab (a range of its pixels) is one contiguous
//    run of bytes, else runs of G * itemsize bytes (64 or more where
//    that avoids streaming, else 32).  The host plan
//    (ops/norm_kernel.py:_plan) groups slabs into chunks that fit in the
//    grid's shared memory and cuts each slab of a chunk into `parts`
//    pixel ranges, one per block.  Per chunk, each block
//      1. copies its range into shared memory with 16-byte cp.async;
//      2. sums the shifted fp32 moments from shared memory (rows inside a
//         warp by shuffles, then the warps in order) and writes them to
//         its own row of the partial table;
//      3. grid barrier;
//      4. reduces the partial rows of its slab in a fixed order (each
//         thread a strided set of parts, then the sets in order), so every
//         block of the slab gets the same bits, from L2 (each thread
//         issues its loads eight parts ahead); where that
//         would make one thread add more than ~40 values (wide slabs cut
//         into many parts: the parity norm's largest calls), one warp per
//         (b, c) reduces the pair once for the grid instead, behind a
//         second barrier (the plan's grid_reduce);
//      5. turns the sums into (m1, inv) and normalizes its range from
//         shared memory, with 16-byte stores.
//    No float atomics: every sum has one fixed order.  The order depends
//    on the grid (the SM count and the blocks per SM), so two calls on one
//    card give identical bits; another card model may round differently.
//
// The earlier design (a moments kernel, an apply kernel, a parity shift
// pre-pass; for the backward a partial, an apply and a dgamma/dbeta
// kernel) was held back by four limits; what this one does about each:
//  1. Passes over device memory: it read x twice (3 passes of bytes
//     where 2 do) and x and dy twice in the backward (5 where 3 do).
//     Here the chunk stays on chip between the moments and the apply.
//  2. Bytes in flight: one 4-byte load per thread per iteration, about
//     0.5 MB over the card where HBM3 needs about 2 MB.  Here a block's
//     whole range (up to 200 KB per SM, ~26 MB over the card) is in
//     flight as 16-byte copies at once.
//  3. Redundant reductions: every apply block re-reduced all partials of
//     its channels, and parity added a launch.  Here each (b, c) is
//     reduced by the blocks of its own slab only, from a few KB of
//     partial rows in L2, or once for the grid (step 4), and the parity
//     shift is one warp per (b, c) before the first chunk.
//  4. Host cost per call: two or three launches and a ctypes binding
//     per call.  Here one launch, bound once at load (ops/norm_kernel.py).
//
//  * A range that does not fit in shared memory (a slab larger than the
//    grid's whole shared memory) keeps what fits there and reads the rest
//    from device memory again in step 5 (L2 where it fits); the plan marks
//    such calls as streaming.  Where G * itemsize or a base address does
//    not allow 16-byte accesses, a scalar path runs the same steps.
//  * The shift.  Standard: s = x[b, 0, 0, c], read directly.  Parity
//    (space-to-depth input, channel (p*2+q)*Cg + c, the layout of
//    renderloom/models/fastpath.py): one shift per (b, c) shared by the
//    four parity groups, the parity average of the means of packed row 0,
//    taken by one warp per (b, c) in a fixed order before the first chunk
//    (one more grid barrier in place of the old pre-pass launch).  After
//    step 4 each block averages the four groups' moments of channels c,
//    Cg+c, 2Cg+c, 3Cg+c.  Parity has no backward: the JAX kernel is
//    inference-only.
//  * r3centered (bf16 input, the standard layout): the bf16 contract of
//    renderloom/models/layers.py:instance_norm.  The same chunks, sums
//    and apply with s = 0 (unshifted fp32 moments), the normalized value
//    rounded to bf16 (nearest even) before the affine, and, at an affine
//    call site, n * gamma + beta (and the leaky) stored as float32: the
//    instantiation with a float output (TO = float).  Without affine it
//    stores n as bf16.  Unshifted moments lose precision when |mean| >>
//    std; that is the contract, which a bf16 input cannot resolve past
//    |mean| / std ~ 2^8 anyway.
//  * Residuals (training): the block holding part 0 of a slab writes the
//    per-(b, c) (s, m1, inv) that the backward reads, so the backward
//    never recomputes the moments (r3centered: s = 0).
//  * Backward: the same chunks with x and dy on chip; the partials are of
//    dz and dz * xhat, with xhat recomputed from x and the residuals and
//    dz = dy through the fused leaky; dx = ((g - E[g]) - xhat * E[g*xhat])
//    * inv with g = dz * gamma from shared memory; after a last barrier the
//    grid sums dgamma and dbeta over b in a fixed order.
//  * Backward, r3centered (what JAX's autodiff gives for the bf16 body):
//    s = 0, dx in bf16, xhat recomputed unrounded and n = bf16(xhat) for
//    the leaky's sign and for dgamma.  At an affine call site dy is the
//    float32 cotangent of the float32 output (the instantiation with TD =
//    float), and the cotangent of the bf16 n is rounded to bf16 again, g =
//    bf16(dz * gamma), so gamma cannot be taken out of the sums: the
//    partials are four per (b, c), g and g * xhat for dx, dz and dz * n
//    for dbeta and dgamma (n_sums = 4; the scratch and the sum tables
//    widen with it).  Without affine it is the bf16 backward with s = 0,
//    and a fused leaky's negative side rounds dz to bf16, as the bf16
//    multiply of the forward's bf16 output does.
//  * Numerics follow the fp32 contract of renderloom/models/layers.py
//    (_in_moments / _in_apply / _in_bwd), not the Pallas kernel's
//    unshifted sums: moments of (x - s) in fp32, the centered apply
//    ((x - s) - m1) * inv * gamma + beta (parity: (d - m1) * (inv * gamma)
//    + beta, instance_norm_p4's order), leaky from the sign of the
//    pre-leaky value.  Only the order of the sums differs from the twins.
//
// Each kernel marks its phases with numbered comments ("// 1. load: ..."),
// the boundaries scripts/norm_probe_h100.py stamps in an instrumented copy.
//
// C interface for ctypes; each entry returns the CUDA error of its launch
// (a refused cooperative or cluster launch included).  rl_norm_device
// sets the kernels' shared-memory limits and reports the geometry the
// plan sizes both paths for.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// A call's scalars, packed once per shape by ops/norm_kernel.py
// (_Config): width > 0 selects the parity norm (C divisible by 4, `width`
// the packed tensor's W, G = C, no residuals); the plan's split; r3 the
// r3centered mode (bf16 input, width 0), out_f32 its forward's float32
// output and dy_f32 its backward's float32 dy at affine call sites, and
// n_sums the partial sums per (b, c) (4 for that backward, else 2);
// cluster > 0 selects the cluster path (blocks per cluster; rows_per_part
// the pixels of a block, grid the blocks), 0 the grid path; the leaky's
// slope and eps.
struct Config {
  int width, B, n_px, C, G, is_bf16, vec, leaky, grid, parts, rows_per_part,
      rows_cap, slabs_per_chunk, n_chunks, grid_reduce, r3, out_f32, n_sums,
      dy_f32, cluster;
  float slope, eps;
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDynSmem = 200 * 1024;  // per block; rl_norm_device reports it

__device__ __forceinline__ float load_f(float v) { return v; }
__device__ __forceinline__ float load_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f(float& p, float v) { p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16& p, float v) {
  p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}
// v rounded to bf16 and back (the r3centered mode's astype(bfloat16))
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// V consecutive elements: 16 bytes on the vector path (32 for the float
// dy of the r3centered backward, two 16-byte accesses), one on the scalar.
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Pack {
  T v[V];
};

struct Args {
  const void* x;
  const void* dy;        // backward
  void* out;             // forward: y; backward: dx
  const float* scale;    // null: no affine
  const float* bias;
  float* stats;          // (B, C, 3) s, m1, inv: written (fwd) or read (bwd)
  float* scratch;        // partial (B, parts, n_sums, C), sums (B, n_sums,
                         // C), and for parity the shifts (B, C / 4)
  float* dscale;         // backward, with affine
  float* dbias;
  int B, n_px, C;
  int G;                 // channels per slab (a divisor of C)
  int width;             // parity: packed W; 0: the standard norm
  int leaky;
  int r3;                // r3centered: s = 0, n rounded to bf16 first
  int n_sums;            // partial sums per (b, c): 2, or 4 (r3 backward
                         // with affine)
  float slope, eps;
  int parts, rows_per_part, rows_cap, slabs_per_chunk, n_chunks;
  int grid_reduce;       // 1: reduce_pairs and a second barrier
  int cluster;           // the cluster path: blocks per cluster (slab)
};

// Block-wide geometry of the column mapping: thread t owns vector column
// j = pass * cols + t % cols and rows t / cols, t / cols + rows_par, ...
struct Cols {
  int Cv, cols, rows_par, col, rowi, pow2;
  __device__ Cols(int C, int V) {
    Cv = C / V;
    cols = Cv < kThreads ? Cv : kThreads;
    rows_par = kThreads / cols;
    col = threadIdx.x % cols;
    rowi = threadIdx.x / cols;
    pow2 = 1;
    while (pow2 < rows_par) pow2 <<= 1;
  }
};

// Sum a1/a2 over the row threads of each column of pass j0 and write
// the column's V channel sums to dst1/dst2 (indexed by channel), in a
// fixed order.  Narrow slabs (cols a power of two, V * cols <= 32): the
// rows inside a warp by shuffles, then the 16 warps in order, two block
// barriers in all; else a tree over the rows in shared memory.
template <int V>
__device__ void column_sums(const Cols& g, bool active, int j0,
                            const float (&a1)[V], const float (&a2)[V],
                            float* red1, float* red2, float* dst1,
                            float* dst2) {
  const int t = threadIdx.x;
  if (g.cols * g.rows_par == kThreads && 32 % g.cols == 0 &&
      V * g.cols <= 32) {
    float b1[V], b2[V];
    for (int k = 0; k < V; ++k) {
      b1[k] = active ? a1[k] : 0.f;
      b2[k] = active ? a2[k] : 0.f;
    }
    for (int off = g.cols; off < 32; off <<= 1)
      for (int k = 0; k < V; ++k) {
        b1[k] += __shfl_xor_sync(0xffffffffu, b1[k], off);
        b2[k] += __shfl_xor_sync(0xffffffffu, b2[k], off);
      }
    const int lane = t & 31, warp = t >> 5;
    if (lane < g.cols)  // the warp's first row: one fixed order
      for (int k = 0; k < V; ++k) {
        red1[(k * kWarps + warp) * g.cols + lane] = b1[k];
        red2[(k * kWarps + warp) * g.cols + lane] = b2[k];
      }
    __syncthreads();
    if (t < V * g.cols) {
      const int k = t / g.cols, col = t % g.cols;
      float s1 = 0.f, s2 = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        s1 += red1[(k * kWarps + w) * g.cols + col];
        s2 += red2[(k * kWarps + w) * g.cols + col];
      }
      dst1[(j0 + col) * V + k] = s1;
      dst2[(j0 + col) * V + k] = s2;
    }
    __syncthreads();
    return;
  }
  for (int k = 0; k < V; ++k) {
    red1[t] = active ? a1[k] : 0.f;
    red2[t] = active ? a2[k] : 0.f;
    __syncthreads();
    for (int s = g.pow2 >> 1; s > 0; s >>= 1) {
      if (active && g.rowi < s && g.rowi + s < g.rows_par) {
        red1[t] += red1[t + s * g.cols];
        red2[t] += red2[t + s * g.cols];
      }
      __syncthreads();
    }
    if (active && g.rowi == 0) {
      dst1[(j0 + g.col) * V + k] = red1[t];
      dst2[(j0 + g.col) * V + k] = red2[t];
    }
    __syncthreads();
  }
}

// Start copying `rows` rows of G elements (global row stride C) into
// shared memory as rows of G: 16-byte cp.async on the vector path (every
// address 16-byte aligned, G * sizeof(T) a multiple of 16), element by
// element on the scalar path.  copy_wait() ends every copy the block
// started.
template <typename T, bool kVec>
__device__ void copy_in(T* dst, const T* src, int rows, int G, int C,
                        int n_threads = kThreads) {
  if (kVec) {
    const int per_row = G * (int)sizeof(T) / 16;
    const int n = rows * per_row;
    const char* s = reinterpret_cast<const char*>(src);
    char* d = reinterpret_cast<char*>(dst);
    for (int i = threadIdx.x; i < n; i += n_threads) {
      const int r = i / per_row, q = i % per_row;
      const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(
          d + ((size_t)r * G * sizeof(T) + q * 16)));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                   "l"(s + ((size_t)r * C * sizeof(T) + q * 16))
                   : "memory");
    }
  } else {
    const int n = rows * G;
    for (int i = threadIdx.x; i < n; i += n_threads)
      dst[i] = src[(size_t)(i / G) * C + i % G];
  }
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// A block's share of one chunk: pixels [p0, p0 + nr) of slab (b, channels
// [c0, c0 + G)), the first nr_s of them on chip.  `mine` is block-uniform.
struct Work {
  bool mine;
  int b, c0, p0, nr, nr_s;
  size_t off;  // element offset of (b, p0, c0)
  __device__ Work(const Args& a, int chunk) {
    const int ng = a.C / a.G;
    const int sl = blockIdx.x / a.parts, part = blockIdx.x % a.parts;
    const int s = chunk * a.slabs_per_chunk + sl;
    mine = sl < a.slabs_per_chunk && s < a.B * ng;
    b = s / ng;
    c0 = (s % ng) * a.G;
    p0 = part * a.rows_per_part;
    nr = min(a.n_px, p0 + a.rows_per_part) - p0;
    nr_s = min(nr, a.rows_cap);
    off = ((size_t)b * a.n_px + p0) * a.C + c0;
  }
  __device__ int part(const Args& a) const { return blockIdx.x % a.parts; }
};

// Grid reduction, after the chunk's barrier: the chunk's (b, c) pairs,
// one warp each, lanes over the parts in stride, then a fixed shuffle
// tree; lane 0's values are the n_sums sums.
__device__ void reduce_pairs(const Args& a, const float* partial,
                             float* sums, int chunk) {
  const int C = a.C, G = a.G, ng = C / G, NS = a.n_sums;
  const int s0 = chunk * a.slabs_per_chunk;
  const int ns = min(a.slabs_per_chunk, a.B * ng - s0);
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  for (int pair = blockIdx.x * kWarps + (threadIdx.x >> 5); pair < ns * G;
       pair += n_warps) {
    const int s = s0 + pair / G;
    const int b = s / ng, c = (s % ng) * G + pair % G;
    const float* p = partial + (size_t)b * a.parts * NS * C + c;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = lane; k < a.parts; k += 32)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < NS) acc[q] += p[((size_t)k * NS + q) * C];
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[q] += __shfl_down_sync(0xffffffffu, acc[q], off);
    if (lane == 0)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < NS) sums[((size_t)b * NS + q) * C + c] = acc[q];
  }
}

// Block reduction, after the chunk's barrier: the per-channel sums of a
// slab over its parts, into S[q G, (q + 1) G) for each of the NS sums
// (forward: the first and second moments), from the slab's partial rows
// (row stride NS C).  Every block of the slab computes them the same way,
// so they agree bit for bit: each thread sums the parts of its group in
// order, then the groups are summed in order.
//
// Each thread issues its loads eight parts at a time before adding them
// in part order: the adds wait on L2 once per eight parts instead of once
// per part (a load-add loop spent 32 of the 197 us of K2b r3centered's
// largest call here, scripts/norm_probe_h100.py).
__device__ __forceinline__ float sum_parts(const float* partial, int p0,
                                           int parts, int step,
                                           size_t stride) {
  float acc = 0.f;
  for (int p = p0; p < parts; p += 8 * step) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = p + u * step < parts ? partial[(p + u * step) * stride] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (p + u * step < parts) acc += v[u];
  }
  return acc;
}

__device__ void block_sums(const float* partial, int parts, int C, int G,
                           int NS, float* red, float* S) {
  const int n = NS * G, t = threadIdx.x;
  const size_t stride = (size_t)NS * C;  // from one part's row to the next
  auto col = [&](int q) { return partial + (size_t)(q / G) * C + q % G; };
  if (n >= kThreads) {
    for (int q = t; q < n; q += kThreads)
      S[q] = sum_parts(col(q), 0, parts, 1, stride);
  } else {
    const int groups = kThreads / n, q = t % n, grp = t / n;
    if (grp < groups)
      red[grp * n + q] = sum_parts(col(q), grp, parts, groups, stride);
    __syncthreads();
    if (t < n) {
      float acc = 0.f;
      for (int k = 0; k < groups; ++k) acc += red[k * n + t];
      S[t] = acc;
    }
  }
  __syncthreads();
}

// The sums of the block's slab into S (n_sums * G floats of shared
// memory): from the grid's sum table, or reduced by the block itself.
__device__ void slab_sums(const Args& a, const float* partial,
                          const float* sums, const Work& w, float* red,
                          float* S) {
  const int C = a.C, G = a.G, NS = a.n_sums;
  if (a.grid_reduce) {
    const float* sb = sums + (size_t)w.b * NS * C + w.c0;
    for (int k = threadIdx.x; k < G; k += kThreads)
      for (int q = 0; q < NS; ++q) S[q * G + k] = sb[(size_t)q * C + k];
    __syncthreads();
  } else {
    block_sums(partial + (size_t)w.b * a.parts * NS * C + w.c0, a.parts, C,
               G, NS, red, S);
  }
}


// Parity shift: shift[b, c] = mean over the four groups g of the mean of
// packed row 0 (`width` pixels) of channel g * Cg + c.  One warp per
// (b, c), a fixed order.
template <typename T>
__device__ void parity_shifts(const T* x, float* shift, int B, int n_px,
                              int C, int width) {
  const int Cg = C / 4;
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  for (int pair = blockIdx.x * kWarps + (threadIdx.x >> 5); pair < B * Cg;
       pair += n_warps) {
    const int b = pair / Cg, c = pair % Cg;
    const T* row = x + (size_t)b * n_px * C;
    float acc = 0.f;
    for (int g = 0; g < 4; ++g) {
      float s = 0.f;
      for (int j = lane; j < width; j += 32)
        s += load_f(row[(size_t)j * C + g * Cg + c]);
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      acc += s / (float)width;
    }
    if (lane == 0) shift[(size_t)b * Cg + c] = acc / 4.f;
  }
}

// The forward.  Shared memory: the block's rows of x (G channels each),
// then seven (G,) tables: shift, m1, inv (parity: inv * gamma), gamma,
// beta, and the slab's two sums.  TO is the output type: T, or float for
// the r3centered mode at an affine call site.
template <typename T, typename TO, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) norm_fwd_kernel(Args a) {
  constexpr int V = kVec ? 16 / sizeof(T) : 1;
  using P = Pack<T, V>;
  using PO = Pack<TO, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red1[kThreads], red2[kThreads];
  cg::grid_group grid = cg::this_grid();

  const int B = a.B, n_px = a.n_px, C = a.C, G = a.G;
  const bool parity = a.width > 0;  // the plan gives G = C
  const T* x = static_cast<const T*>(a.x);
  TO* out = static_cast<TO*>(a.out);
  float* partial = a.scratch;
  float* sums = partial + (size_t)B * a.parts * 2 * C;
  float* shift = sums + (size_t)B * 2 * C;

  T* xs = reinterpret_cast<T*>(smem);
  float* t_s = reinterpret_cast<float*>(
      smem + ((size_t)a.rows_cap * G * sizeof(T) + 15) / 16 * 16);
  float* t_m1 = t_s + G;
  float* t_a = t_m1 + G;
  float* t_g = t_a + G;
  float* t_b = t_g + G;
  float* t_S = t_b + G;  // 2G: the slab's sums
  const Cols g(G, V);
  const int Cv = C / V;  // packs per global row

  if (parity) {
    parity_shifts(x, shift, B, n_px, C, a.width);
    grid.sync();
  }
  for (int chunk = 0; chunk < a.n_chunks; ++chunk) {
    const Work w(a, chunk);
    const T* xg = x + w.off;
    // 1. load: the block's range of the chunk (cp.async) and its tables
    if (w.mine) {
      copy_in<T, kVec>(xs, xg, w.nr_s, G, C);
      for (int k = threadIdx.x; k < G; k += kThreads) {
        const int c = w.c0 + k;
        t_s[k] = a.r3     ? 0.f
                 : parity ? shift[(size_t)w.b * (C / 4) + c % (C / 4)]
                          : load_f(x[(size_t)w.b * n_px * C + c]);
        t_g[k] = a.scale ? a.scale[c] : 1.f;
        t_b[k] = a.bias ? a.bias[c] : 0.f;
      }
      copy_wait();
      // 2. sums: the range's moments into its row of the partial table
      float* dst = partial + ((size_t)w.b * a.parts + w.part(a)) * 2 * C +
                   w.c0;
      for (int j0 = 0; j0 < g.Cv; j0 += g.cols) {
        const int j = j0 + g.col;
        const bool active = g.rowi < g.rows_par && j < g.Cv;
        float s1[V], s2[V], sh[V];
        for (int k = 0; k < V; ++k) {
          s1[k] = s2[k] = 0.f;
          sh[k] = active ? t_s[j * V + k] : 0.f;
        }
        if (active) {
          for (int r = g.rowi; r < w.nr; r += g.rows_par) {
            const P p = r < w.nr_s
                ? reinterpret_cast<const P*>(xs)[(size_t)r * g.Cv + j]
                : reinterpret_cast<const P*>(xg)[(size_t)r * Cv + j];
            for (int k = 0; k < V; ++k) {
              const float d = load_f(p.v[k]) - sh[k];
              s1[k] += d;
              s2[k] += d * d;
            }
          }
        }
        column_sums<V>(g, active, j0, s1, s2, red1, red2, dst, dst + C);
      }
    }
    // 3. barrier: the chunk's partial rows are written (and, with
    // grid_reduce, reduced once for the grid)
    grid.sync();
    if (a.grid_reduce) {
      reduce_pairs(a, partial, sums, chunk);
      grid.sync();
    }
    if (!w.mine) continue;

    // 4. partials: the slab's sums from its partial rows in L2
    slab_sums(a, partial, sums, w, red1, t_S);
    // 5. apply: (m1, inv), the residuals, and the normalized range
    for (int k = threadIdx.x; k < G; k += kThreads) {
      const int c = w.c0 + k;
      float m1, m2;
      if (parity) {  // average the four groups' moments (G = C)
        const int Cg = C / 4, cg_ = c % Cg;
        float a1 = 0.f, a2 = 0.f;
        for (int q = 0; q < 4; ++q) {
          a1 += t_S[q * Cg + cg_] / (float)n_px;
          a2 += t_S[G + q * Cg + cg_] / (float)n_px;
        }
        m1 = a1 / 4.f;
        m2 = a2 / 4.f;
      } else {
        m1 = t_S[k] / (float)n_px;
        m2 = t_S[G + k] / (float)n_px;
      }
      const float var = fmaxf(m2 - m1 * m1, 0.f);
      const float inv = rsqrtf(var + a.eps);
      t_m1[k] = m1;
      t_a[k] = parity && a.scale ? inv * t_g[k] : inv;
      if (a.stats && w.part(a) == 0) {  // residuals for the backward
        float* st = a.stats + ((size_t)w.b * C + c) * 3;
        st[0] = t_s[k];
        st[1] = m1;
        st[2] = inv;
      }
    }
    __syncthreads();
    // standard: y * gamma, + beta after the normalization; parity: gamma
    // is folded into t_a, + beta
    const bool mul_g = a.scale && !parity;
    const bool add_b = a.bias != nullptr;
    const bool r3 = a.r3 != 0;
    PO* og = reinterpret_cast<PO*>(out + w.off);
    for (int j0 = 0; j0 < g.Cv; j0 += g.cols) {
      const int j = j0 + g.col;
      if (g.rowi >= g.rows_par || j >= g.Cv) continue;
      float cs[V], cm[V], ca[V], cgm[V], cb[V];
      for (int k = 0; k < V; ++k) {
        cs[k] = t_s[j * V + k];
        cm[k] = t_m1[j * V + k];
        ca[k] = t_a[j * V + k];
        cgm[k] = t_g[j * V + k];
        cb[k] = t_b[j * V + k];
      }
      for (int r = g.rowi; r < w.nr; r += g.rows_par) {
        const P p = r < w.nr_s
            ? reinterpret_cast<const P*>(xs)[(size_t)r * g.Cv + j]
            : reinterpret_cast<const P*>(xg)[(size_t)r * Cv + j];
        PO o;
        for (int k = 0; k < V; ++k) {
          float y = ((load_f(p.v[k]) - cs[k]) - cm[k]) * ca[k];
          if (r3) y = round_bf16(y);  // n in bf16, then the fp32 affine
          if (mul_g) y = y * cgm[k];
          if (add_b) y = y + cb[k];
          if (a.leaky) y = y >= 0.f ? y : y * a.slope;
          store_f(o.v[k], y);
        }
        og[(size_t)r * Cv + j] = o;
      }
    }
    __syncthreads();  // shared memory is refilled by the next chunk
  }
}

// dz: dy through the fused leaky, whose sign is the forward's pre-leaky
// value recomputed bit for bit from n (xhat, or bf16(xhat) in the
// r3centered mode).  The r3centered forward without affine applies the
// leaky to its bf16 output, so there the negative side's dy * slope is a
// bf16 multiply, rounded to bf16.
__device__ __forceinline__ float leaky_grad(float d, float n, bool leaky,
                                            bool affine, bool r3, float gm,
                                            float be, float slope) {
  if (leaky) {
    float z = n;
    if (affine) {
      z = z * gm;
      z = z + be;
    }
    if (!(z >= 0.f)) {
      d = d * slope;
      if (r3 && !affine) d = round_bf16(d);
    }
  }
  return d;
}

// The backward.  Shared memory: the block's rows of x, then of dy (from
// the next multiple of dy's size), then 7 + n_sums (G,) tables: s, m1,
// inv, gamma, beta, E[g], E[g * xhat] and the slab's n_sums sums.  TD is
// dy's type: T, or float for the r3centered mode at an affine call site
// (the cotangent of its float32 output).
template <typename T, typename TD, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) norm_bwd_kernel(Args a) {
  constexpr int V = kVec ? 16 / sizeof(T) : 1;
  using P = Pack<T, V>;
  using PD = Pack<TD, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red1[kThreads], red2[kThreads];
  cg::grid_group grid = cg::this_grid();

  const int B = a.B, n_px = a.n_px, C = a.C, G = a.G, NS = a.n_sums;
  const T* x = static_cast<const T*>(a.x);
  const TD* dy = static_cast<const TD*>(a.dy);
  T* dx = static_cast<T*>(a.out);
  float* partial = a.scratch;
  float* sums = partial + (size_t)B * a.parts * NS * C;

  const size_t x_bytes = (size_t)a.rows_cap * G * sizeof(T);
  const size_t dy_at = (x_bytes + sizeof(TD) - 1) / sizeof(TD) * sizeof(TD);
  const size_t dy_end = dy_at + (size_t)a.rows_cap * G * sizeof(TD);
  T* xs = reinterpret_cast<T*>(smem);
  TD* ds = reinterpret_cast<TD*>(smem + dy_at);
  float* t_s = reinterpret_cast<float*>(smem + (dy_end + 15) / 16 * 16);
  float* t_m1 = t_s + G;
  float* t_inv = t_m1 + G;
  float* t_g = t_inv + G;
  float* t_b = t_g + G;
  float* t_mg = t_b + G;
  float* t_mgx = t_mg + G;
  float* t_S = t_mgx + G;  // NS * G: the slab's sums
  const Cols g(G, V);
  const int Cv = C / V;  // packs per global row
  const bool affine = a.scale != nullptr;
  const bool leaky = a.leaky != 0;
  const bool r3 = a.r3 != 0;
  // r3centered with affine: g = bf16(dz * gamma), four sums (n_sums = 4)
  const bool r3a = r3 && affine;

  for (int chunk = 0; chunk < a.n_chunks; ++chunk) {
    const Work w(a, chunk);
    const T* xg = x + w.off;
    const TD* dg = dy + w.off;
    // 1. load: the block's range of x and dy (cp.async) and its tables
    if (w.mine) {
      copy_in<T, kVec>(xs, xg, w.nr_s, G, C);
      copy_in<TD, kVec>(ds, dg, w.nr_s, G, C);
      for (int k = threadIdx.x; k < G; k += kThreads) {
        const int c = w.c0 + k;
        const float* st = a.stats + ((size_t)w.b * C + c) * 3;
        t_s[k] = st[0];
        t_m1[k] = st[1];
        t_inv[k] = st[2];
        t_g[k] = affine ? a.scale[c] : 1.f;
        t_b[k] = affine ? a.bias[c] : 0.f;
      }
      copy_wait();
      // 2. sums: the range's partial sums into its row of the table
      float* dst = partial + ((size_t)w.b * a.parts + w.part(a)) * NS * C +
                   w.c0;
      for (int j0 = 0; j0 < g.Cv; j0 += g.cols) {
        const int j = j0 + g.col;
        const bool active = g.rowi < g.rows_par && j < g.Cv;
        float s1[V], s2[V], s3[V], s4[V], cs[V], cm[V], ci[V], cgm[V], cb[V];
        for (int k = 0; k < V; ++k) {
          const int c = active ? j * V + k : 0;
          s1[k] = s2[k] = s3[k] = s4[k] = 0.f;
          cs[k] = t_s[c];
          cm[k] = t_m1[c];
          ci[k] = t_inv[c];
          cgm[k] = t_g[c];
          cb[k] = t_b[c];
        }
        if (active) {
          for (int r = g.rowi; r < w.nr; r += g.rows_par) {
            const bool on_chip = r < w.nr_s;
            const size_t i = on_chip ? (size_t)r * g.Cv + j : (size_t)r * Cv + j;
            const P px = reinterpret_cast<const P*>(on_chip ? xs : xg)[i];
            const PD pd = reinterpret_cast<const PD*>(on_chip ? ds : dg)[i];
            for (int k = 0; k < V; ++k) {
              const float xhat = ((load_f(px.v[k]) - cs[k]) - cm[k]) * ci[k];
              const float n = r3 ? round_bf16(xhat) : xhat;
              const float d = leaky_grad(load_f(pd.v[k]), n, leaky, affine,
                                         r3, cgm[k], cb[k], a.slope);
              if (r3a) {
                const float gq = round_bf16(d * cgm[k]);
                s1[k] += gq;
                s2[k] += gq * xhat;
                s3[k] += d;
                s4[k] += d * n;
              } else {
                s1[k] += d;
                s2[k] += d * xhat;
              }
            }
          }
        }
        column_sums<V>(g, active, j0, s1, s2, red1, red2, dst, dst + C);
        if (r3a)
          column_sums<V>(g, active, j0, s3, s4, red1, red2, dst + 2 * C,
                         dst + 3 * C);
      }
    }
    // 3. barrier: the chunk's partial rows are written (and, with
    // grid_reduce, reduced once for the grid)
    grid.sync();
    if (a.grid_reduce) {
      reduce_pairs(a, partial, sums, chunk);
      grid.sync();
    }
    if (!w.mine) continue;

    // 4. partials: the slab's sums from its partial rows in L2
    slab_sums(a, partial, sums, w, red1, t_S);
    // 5. apply: E[g], E[g * xhat] and dx of the range
    for (int k = threadIdx.x; k < G; k += kThreads) {
      const float gm = r3a ? 1.f : t_g[k];  // r3a: gamma is inside g
      t_mg[k] = (gm * t_S[k]) / (float)n_px;        // E[g]
      t_mgx[k] = (gm * t_S[G + k]) / (float)n_px;   // E[g * xhat]
      if (!a.grid_reduce && w.part(a) == 0)  // for dgamma and dbeta
        for (int q = 0; q < NS; ++q)
          sums[((size_t)w.b * NS + q) * C + w.c0 + k] = t_S[q * G + k];
    }
    __syncthreads();
    P* og = reinterpret_cast<P*>(dx + w.off);
    for (int j0 = 0; j0 < g.Cv; j0 += g.cols) {
      const int j = j0 + g.col;
      if (g.rowi >= g.rows_par || j >= g.Cv) continue;
      float cs[V], cm[V], ci[V], cgm[V], cb[V], mg[V], mgx[V];
      for (int k = 0; k < V; ++k) {
        const int c = j * V + k;
        cs[k] = t_s[c];
        cm[k] = t_m1[c];
        ci[k] = t_inv[c];
        cgm[k] = t_g[c];
        cb[k] = t_b[c];
        mg[k] = t_mg[c];
        mgx[k] = t_mgx[c];
      }
      for (int r = g.rowi; r < w.nr; r += g.rows_par) {
        const bool on_chip = r < w.nr_s;
        const size_t i = on_chip ? (size_t)r * g.Cv + j : (size_t)r * Cv + j;
        const P px = reinterpret_cast<const P*>(on_chip ? xs : xg)[i];
        const PD pd = reinterpret_cast<const PD*>(on_chip ? ds : dg)[i];
        P o;
        for (int k = 0; k < V; ++k) {
          const float xhat = ((load_f(px.v[k]) - cs[k]) - cm[k]) * ci[k];
          const float n = r3 ? round_bf16(xhat) : xhat;
          const float d = leaky_grad(load_f(pd.v[k]), n, leaky, affine, r3,
                                     cgm[k], cb[k], a.slope);
          const float gg = r3a     ? round_bf16(d * cgm[k])
                           : affine ? d * cgm[k]
                                    : d;
          store_f(o.v[k], ((gg - mg[k]) - xhat * mgx[k]) * ci[k]);
        }
        og[(size_t)r * Cv + j] = o;
      }
    }
    __syncthreads();  // shared memory is refilled by the next chunk
  }

  // 6. tail: dbeta = sum over (b, pixels) of dz, dgamma = sum of dz *
  // xhat (r3a: dz * n, sums 2 and 3): the per-(b, c) sums in batch order,
  // one thread per channel, after a last barrier
  if (a.dscale) {
    grid.sync();
    const int q = r3a ? 2 : 0;
    for (int c = blockIdx.x * kThreads + threadIdx.x; c < C;
         c += gridDim.x * kThreads) {
      float sdb = 0.f, sdg = 0.f;
      for (int bb = 0; bb < B; ++bb) {
        sdb += sums[((size_t)bb * NS + q) * C + c];
        sdg += sums[((size_t)bb * NS + q + 1) * C + c];
      }
      a.dbias[c] = sdb;
      a.dscale[c] = sdg;
    }
  }
}

// ---------------------------------------------------------------------------
// The cluster path: r3centered calls whose slab fits in one thread-block
// cluster.  One cluster per slab (batch element b, channels [c0, c0 + G)),
// an ordinary launch with a cluster dimension; block rank r holds pixels
// [r * rows, (r + 1) * rows) in shared memory from its load to its
// stores, and the blocks of a slab exchange their partial sums through
// distributed shared memory.  The cluster barrier is the only barrier.
// ---------------------------------------------------------------------------

constexpr int kCV = 8;  // bf16 channels of a 16-byte column

// Threads of a cluster-path block: 512 for the forward with a bf16 output,
// 256 for the forward with a float32 output and for the backward (128
// registers a thread; 512 measured slower there).
__host__ __device__ constexpr int cluster_threads(int bwd, int mixed) {
  return bwd || mixed ? 256 : 512;
}

__host__ __device__ constexpr long long align16(long long n) {
  return (n + 15) / 16 * 16;
}

// Dynamic shared memory of a cluster-path block, what its launch asks for
// (ops/norm_kernel.py:_cluster_smem repeats it to choose a split): x's
// rows (bf16), the backward's g rows (bf16), then the fp32 tables m1, inv, gamma, beta (the backward: also E[g], E[g * xhat]),
// the per-warp sums of the nt threads, the k blocks' partial sums
// (written by each block into every block of its cluster), and one int.
__host__ __device__ constexpr long long cluster_smem(int rows, int G, int bwd,
                                                     int n_sums, int k,
                                                     int nt) {
  return align16((long long)rows * G * 2) * (bwd ? 2 : 1) +
         4LL * G * ((bwd ? 6 : 4) + (nt / 32 + k) * n_sums) + 16;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The block's geometry: its slab, its rows, and the column mapping of its
// NT threads (thread t: 16-byte column t % Cv of rows t / Cv + j * (NT /
// Cv); Cv = G / 8 is a power of two up to 16, so the rows of a column
// inside a warp are lanes Cv apart).
template <int NT>
struct CBlock {
  int rank, b, c0, nr, Cv, col, rowi, rows_par;
  size_t off;  // element offset of (b, first row, c0)
  __device__ CBlock(const Args& a, int rank_) {
    rank = rank_;
    const int ng = a.C / a.G, s = blockIdx.x / a.cluster;
    b = s / ng;
    c0 = (s % ng) * a.G;
    const int p0 = rank * a.rows_per_part;
    nr = max(0, min(a.n_px, p0 + a.rows_per_part) - p0);
    off = ((size_t)b * a.n_px + p0) * a.C + c0;
    Cv = a.G / kCV;
    col = threadIdx.x % Cv;
    rowi = threadIdx.x / Cv;
    rows_par = NT / Cv;
  }
};

// The block's partial sums and their exchange.  acc[q][j] of each thread
// is summed over the rows of its column, by shuffles inside the warp and
// then over the warps in order; thread c < G then writes channel c's
// NS sums into slot `rank` of every block of the cluster (distributed
// shared memory; its own block's directly), and after the cluster
// barrier each block adds the k slots in rank order, so every block of
// the slab gets the same bits, S[q] for channel c0 + t.  A cluster of
// one block has no cluster barrier.  The barrier's first arrive, at the
// kernel's start (`cluster_arrive_relaxed`), tells the other blocks that
// this one runs, before any of them writes into its shared memory.
template <int NS, int NT>
__device__ void cluster_sums(cg::cluster_group& cl, const CBlock<NT>& w,
                             int k, int G, float (&acc)[NS][kCV], float* red,
                             float* slots, float (&S)[NS]) {
  for (int off = w.Cv; off < 32; off <<= 1)
#pragma unroll
    for (int q = 0; q < NS; ++q)
#pragma unroll
      for (int j = 0; j < kCV; ++j)
        acc[q][j] += __shfl_xor_sync(0xffffffffu, acc[q][j], off);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (lane < w.Cv)
#pragma unroll
    for (int q = 0; q < NS; ++q)
#pragma unroll
      for (int j = 0; j < kCV; ++j)
        red[(warp * NS + q) * G + w.col * kCV + j] = acc[q][j];
  __syncthreads();
  if (k > 1) cluster_wait();  // every block of the cluster has started
  if (t < G) {
    float v[NS];
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      v[q] = 0.f;
#pragma unroll
      for (int u = 0; u < NT / 32; ++u) v[q] += red[(u * NS + q) * G + t];
    }
    for (int r = 0; r < k; ++r) {
      float* dst = r == w.rank ? slots : cl.map_shared_rank(slots, r);
#pragma unroll
      for (int q = 0; q < NS; ++q) dst[(w.rank * NS + q) * G + t] = v[q];
    }
  }
  if (k > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < NS; ++q) S[q] = 0.f;
  if (t < G)
    for (int r = 0; r < k; ++r)
#pragma unroll
      for (int q = 0; q < NS; ++q) S[q] += slots[(r * NS + q) * G + t];
}

// The forward (K2 r3centered).  TO: bf16, or float at an affine call site.
template <typename TO>
__global__ void __launch_bounds__(cluster_threads(0, sizeof(TO) == 4), 2)
    cluster_fwd(Args a) {
  constexpr int NT = cluster_threads(0, sizeof(TO) == 4);
  using T = __nv_bfloat16;
  using P = Pack<T, kCV>;
  using PO = Pack<TO, kCV>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int G = a.G, t = threadIdx.x;
  const CBlock<NT> w(a, (int)cl.block_rank());
  T* xs = reinterpret_cast<T*>(smem);
  float* t_m1 = reinterpret_cast<float*>(
      smem + align16((long long)a.rows_per_part * G * 2));
  float* t_inv = t_m1 + G;
  float* t_g = t_inv + G;
  float* t_b = t_g + G;
  float* red = t_b + G;                  // (NT / 32) * 2G
  float* slots = red + (NT / 32) * 2 * G;  // cluster * 2G
  const bool affine = a.scale != nullptr;
  if (a.cluster > 1) cluster_arrive_relaxed();

  // 1. load: the block's rows of x (16-byte cp.async), gamma and beta
  copy_in<T, true>(xs, static_cast<const T*>(a.x) + w.off, w.nr, G, a.C, NT);
  if (t < G) {
    t_g[t] = affine ? a.scale[w.c0 + t] : 1.f;
    t_b[t] = affine ? a.bias[w.c0 + t] : 0.f;
  }
  copy_wait();
  // 2. sums: unshifted fp32 moments of the block's rows
  float acc[2][kCV];
#pragma unroll
  for (int k = 0; k < kCV; ++k) acc[0][k] = acc[1][k] = 0.f;
  for (int r = w.rowi; r < w.nr; r += w.rows_par) {
    const P p = reinterpret_cast<const P*>(xs)[(size_t)r * w.Cv + w.col];
#pragma unroll
    for (int k = 0; k < kCV; ++k) {
      const float d = load_f(p.v[k]);
      acc[0][k] += d;
      acc[1][k] += d * d;
    }
  }
  // 3. exchange: the slab's moments from every block's partial sums
  float S[2];
  cluster_sums<2, NT>(cl, w, a.cluster, G, acc, red, slots, S);
  if (t < G) {
    const float m1 = S[0] / (float)a.n_px;
    const float m2 = S[1] / (float)a.n_px;
    const float var = fmaxf(m2 - m1 * m1, 0.f);
    const float inv = rsqrtf(var + a.eps);
    t_m1[t] = m1;
    t_inv[t] = inv;
    if (a.stats && w.rank == 0) {  // residuals for the backward
      float* st = a.stats + ((size_t)w.b * a.C + w.c0 + t) * 3;
      st[0] = 0.f;
      st[1] = m1;
      st[2] = inv;
    }
  }
  __syncthreads();
  // 4. apply: n = bf16(x̂), then the fp32 affine and the leaky
  {
    float cm[kCV], ci[kCV], cgm[kCV], cb[kCV];
#pragma unroll
    for (int k = 0; k < kCV; ++k) {
      const int c = w.col * kCV + k;
      cm[k] = t_m1[c];
      ci[k] = t_inv[c];
      cgm[k] = t_g[c];
      cb[k] = t_b[c];
    }
    PO* og = reinterpret_cast<PO*>(static_cast<TO*>(a.out) + w.off);
    const int Cvg = a.C / kCV;
    for (int r = w.rowi; r < w.nr; r += w.rows_par) {
      const P p = reinterpret_cast<const P*>(xs)[(size_t)r * w.Cv + w.col];
      PO o;
#pragma unroll
      for (int k = 0; k < kCV; ++k) {
        float y = round_bf16((load_f(p.v[k]) - cm[k]) * ci[k]);
        if (affine) {
          y = y * cgm[k];
          y = y + cb[k];
        }
        if (a.leaky) y = y >= 0.f ? y : y * a.slope;
        store_f(o.v[k], y);
      }
      og[(size_t)r * Cvg + w.col] = o;
    }
  }
  // 5. tail: none in the forward
}

// The backward (K2b r3centered).  TD: float at an affine call site (four
// sums, g = bf16(dz * gamma), dgamma and dbeta), bf16 without (g = dz).
// The residuals give x̂ from the start, so one pass over device memory
// reads x and dy, sums, and keeps x and g (exact in bf16) in shared
// memory; the apply reads them there and does not recompute g.
template <typename TD>
__global__ void __launch_bounds__(cluster_threads(1, 0), 2)
    cluster_bwd(Args a) {
  constexpr int NT = cluster_threads(1, 0);
  constexpr bool kAff = sizeof(TD) == 4;
  constexpr int NS = kAff ? 4 : 2;
  constexpr int kAhead = kAff ? 2 : 4;  // rows in flight, as registers allow
  using T = __nv_bfloat16;
  using P = Pack<T, kCV>;
  using PD = Pack<TD, kCV>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int G = a.G, t = threadIdx.x;
  const CBlock<NT> w(a, (int)cl.block_rank());
  const long long x_bytes = align16((long long)a.rows_per_part * G * 2);
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + x_bytes);
  float* t_m1 = reinterpret_cast<float*>(smem + 2 * x_bytes);
  float* t_inv = t_m1 + G;
  float* t_g = t_inv + G;
  float* t_b = t_g + G;
  float* t_mg = t_b + G;
  float* t_mgx = t_mg + G;
  float* red = t_mgx + G;                  // (NT / 32) * NS * G
  float* slots = red + (NT / 32) * NS * G;  // cluster * NS * G
  int* last = reinterpret_cast<int*>(slots + a.cluster * NS * G);
  const bool leaky = a.leaky != 0;
  if (a.cluster > 1) cluster_arrive_relaxed();

  // 1. load: the residuals, gamma and beta; the rows of x and dy arrive
  // in the sums pass
  if (t < G) {
    const float* st = a.stats + ((size_t)w.b * a.C + w.c0 + t) * 3;
    t_m1[t] = st[1];
    t_inv[t] = st[2];
    t_g[t] = kAff ? a.scale[w.c0 + t] : 1.f;
    t_b[t] = kAff ? a.bias[w.c0 + t] : 0.f;
  }
  __syncthreads();
  float cm[kCV], ci[kCV];
#pragma unroll
  for (int k = 0; k < kCV; ++k) {
    cm[k] = t_m1[w.col * kCV + k];
    ci[k] = t_inv[w.col * kCV + k];
  }
  // 2. sums: g and g * x̂ (affine: also dz and dz * n) of the block's rows,
  // each thread reading its rows of x and dy from device memory (kAhead
  // rows in flight) and keeping x and g in shared memory
  float acc[NS][kCV];
#pragma unroll
  for (int q = 0; q < NS; ++q)
#pragma unroll
    for (int k = 0; k < kCV; ++k) acc[q][k] = 0.f;
  {
    float cgm[kCV], cb[kCV];
#pragma unroll
    for (int k = 0; k < kCV; ++k) {
      cgm[k] = t_g[w.col * kCV + k];
      cb[k] = t_b[w.col * kCV + k];
    }
    const P* xg = reinterpret_cast<const P*>(static_cast<const T*>(a.x) +
                                             w.off) + w.col;
    const PD* dg = reinterpret_cast<const PD*>(static_cast<const TD*>(a.dy) +
                                               w.off) + w.col;
    const int Cvg = a.C / kCV;
    for (int r0 = w.rowi; r0 < w.nr; r0 += kAhead * w.rows_par) {
      P px[kAhead];
      PD pd[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int r = r0 + u * w.rows_par;
        if (r < w.nr) {
          px[u] = xg[(size_t)r * Cvg];
          pd[u] = dg[(size_t)r * Cvg];
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int r = r0 + u * w.rows_par;
        if (r >= w.nr) continue;
        P pg;
#pragma unroll
        for (int k = 0; k < kCV; ++k) {
          const float xhat = (load_f(px[u].v[k]) - cm[k]) * ci[k];
          const float n = round_bf16(xhat);
          const float d = leaky_grad(load_f(pd[u].v[k]), n, leaky, kAff,
                                     true, cgm[k], cb[k], a.slope);
          if constexpr (kAff) {
            const float gq = round_bf16(d * cgm[k]);
            acc[0][k] += gq;
            acc[1][k] += gq * xhat;
            acc[2][k] += d;
            acc[3][k] += d * n;
            store_f(pg.v[k], gq);
          } else {
            acc[0][k] += d;
            acc[1][k] += d * xhat;
            store_f(pg.v[k], d);
          }
        }
        const size_t i = (size_t)r * w.Cv + w.col;
        reinterpret_cast<P*>(xs)[i] = px[u];
        reinterpret_cast<P*>(gs)[i] = pg;
      }
    }
  }
  // 3. exchange: the slab's sums from every block's partial sums
  float S[NS];
  cluster_sums<NS, NT>(cl, w, a.cluster, G, acc, red, slots, S);
  float* table = a.scratch + 4;  // (B, 2, C): the slabs' dbeta, dgamma sums
  if (t < G) {
    t_mg[t] = S[0] / (float)a.n_px;    // E[g]
    t_mgx[t] = S[1] / (float)a.n_px;   // E[g * x̂]
    if constexpr (kAff) {
      if (w.rank == 0) {
        table[((size_t)w.b * 2) * a.C + w.c0 + t] = S[2];
        table[((size_t)w.b * 2 + 1) * a.C + w.c0 + t] = S[3];
      }
    }
  }
  __syncthreads();
  // 4. apply: dx = bf16(((g - E[g]) - x̂ E[g x̂]) inv), g from shared memory
  {
    float mg[kCV], mgx[kCV];
#pragma unroll
    for (int k = 0; k < kCV; ++k) {
      mg[k] = t_mg[w.col * kCV + k];
      mgx[k] = t_mgx[w.col * kCV + k];
    }
    P* og = reinterpret_cast<P*>(static_cast<T*>(a.out) + w.off);
    const int Cvg = a.C / kCV;
    for (int r = w.rowi; r < w.nr; r += w.rows_par) {
      const size_t i = (size_t)r * w.Cv + w.col;
      const P px = reinterpret_cast<const P*>(xs)[i];
      const P pg = reinterpret_cast<const P*>(gs)[i];
      P o;
#pragma unroll
      for (int k = 0; k < kCV; ++k) {
        const float xhat = (load_f(px.v[k]) - cm[k]) * ci[k];
        store_f(o.v[k], ((load_f(pg.v[k]) - mg[k]) - xhat * mgx[k]) * ci[k]);
      }
      og[(size_t)r * Cvg + w.col] = o;
    }
  }
  // 5. tail: dgamma and dbeta, summed over b in batch order by the last
  // slab to finish (an integer count in the workspace, reset by that
  // block; no float atomics)
  if (kAff && w.rank == 0) {
    __threadfence();
    __syncthreads();
    if (t == 0) {
      const int n_slabs = gridDim.x / a.cluster;
      *last = atomicAdd(reinterpret_cast<int*>(a.scratch), 1) == n_slabs - 1;
    }
    __syncthreads();
    if (*last) {
      __threadfence();
      for (int c = t; c < a.C; c += NT) {
        float sdb = 0.f, sdg = 0.f;
        for (int bb = 0; bb < a.B; ++bb) {
          sdb += __ldcg(table + ((size_t)bb * 2) * a.C + c);
          sdg += __ldcg(table + ((size_t)bb * 2 + 1) * a.C + c);
        }
        a.dbias[c] = sdb;
        a.dscale[c] = sdg;
      }
      if (t == 0) *reinterpret_cast<int*>(a.scratch) = 0;
    }
  }
}

void* const kClusterKernels[4] = {
    (void*)cluster_fwd<__nv_bfloat16>, (void*)cluster_fwd<float>,
    (void*)cluster_bwd<__nv_bfloat16>, (void*)cluster_bwd<float>,
};

// [bwd * 4 + is_bf16 * 2 + scalar], then the r3centered mode's mixed
// types at affine call sites (bf16 x, float output or dy):
// [8 + bwd * 2 + scalar]
void* const kKernels[12] = {
    (void*)norm_fwd_kernel<float, float, true>,
    (void*)norm_fwd_kernel<float, float, false>,
    (void*)norm_fwd_kernel<__nv_bfloat16, __nv_bfloat16, true>,
    (void*)norm_fwd_kernel<__nv_bfloat16, __nv_bfloat16, false>,
    (void*)norm_bwd_kernel<float, float, true>,
    (void*)norm_bwd_kernel<float, float, false>,
    (void*)norm_bwd_kernel<__nv_bfloat16, __nv_bfloat16, true>,
    (void*)norm_bwd_kernel<__nv_bfloat16, __nv_bfloat16, false>,
    (void*)norm_fwd_kernel<__nv_bfloat16, float, true>,
    (void*)norm_fwd_kernel<__nv_bfloat16, float, false>,
    (void*)norm_bwd_kernel<__nv_bfloat16, float, true>,
    (void*)norm_bwd_kernel<__nv_bfloat16, float, false>,
};

// The plan's invariants (ops/norm_kernel.py:_plan), checked before the
// launch: a plan that breaks one would index outside its buffers.  The
// r3centered mode takes a bf16 input in the standard layout; only it
// mixes types (float output, float dy), exactly at affine call sites, and
// only its backward with affine takes four sums.
bool plan_ok(const Args& a, int bwd, int itemsize, int vec, int grid,
             int mixed) {
  if (a.r3 && (itemsize != 2 || a.width != 0 ||
               mixed != (a.scale != nullptr)))
    return false;
  if (mixed && !a.r3) return false;
  if (a.n_sums != (bwd && mixed ? 4 : 2)) return false;
  const int dsz = mixed ? 4 : itemsize;  // dy's size (backward)
  const int n_tables = bwd ? 7 + a.n_sums : 7;
  const long long rx = (long long)a.rows_cap * a.G * itemsize;
  const long long rows =
      bwd ? ((rx + dsz - 1) / dsz * dsz + (long long)a.rows_cap * a.G * dsz +
             15) / 16 * 16
          : (rx + 15) / 16 * 16;
  return a.G > 0 && a.C % a.G == 0 && (a.width == 0 || a.G == a.C) &&
         (!vec || (a.G * itemsize) % 16 == 0) && a.rows_cap > 0 &&
         rows + 4LL * n_tables * a.G <= kDynSmem &&
         (long long)a.slabs_per_chunk * a.parts <= grid &&
         (long long)a.parts * a.rows_per_part >= a.n_px &&
         (long long)a.slabs_per_chunk * a.n_chunks * a.G >= (long long)a.B * a.C;
}

// The cluster path's invariants: the r3centered mode on 16-byte columns,
// G a power of two from 16 to 128 channels (Cv = G / 8 divides a warp),
// one cluster of 1-8 blocks per slab covering its pixels, and the
// workspace (a count and the (B, 2, C) table) where the backward sums
// dgamma and dbeta.  A launch whose shared memory exceeds what
// rl_norm_device allowed the kernel is refused by the runtime.
bool cluster_ok(const Args& a, int bwd, int itemsize, int vec, int grid,
                int mixed) {
  const int k = a.cluster, G = a.G;
  if (!a.r3 || itemsize != 2 || !vec || a.width != 0 ||
      mixed != (a.scale != nullptr) || a.n_sums != (bwd && mixed ? 4 : 2))
    return false;
  if (G < 16 || G > 128 || (G & (G - 1)) || a.C % G) return false;
  if (k < 1 || k > 8) return false;
  return (long long)grid == (long long)a.B * (a.C / G) * k &&
         (long long)a.rows_per_part * k >= a.n_px &&
         (!(bwd && mixed) ||
          (a.scratch != nullptr && a.dscale != nullptr && a.dbias != nullptr));
}

int launch(int bwd, int is_bf16, int vec, int grid, int mixed, Args& a,
           cudaStream_t stream) {
  cudaError_t err;
  if (a.cluster > 0) {
    if (!cluster_ok(a, bwd, is_bf16 ? 2 : 4, vec, grid, mixed))
      return static_cast<int>(cudaErrorInvalidValue);
    const int nt = cluster_threads(bwd, mixed);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(nt);
    cfg.dynamicSmemBytes = static_cast<size_t>(
        cluster_smem(a.rows_per_part, a.G, bwd, a.n_sums, a.cluster, nt));
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    void* params[] = {&a};
    err = cudaLaunchKernelExC(&cfg, kClusterKernels[bwd * 2 + mixed],
                              params);
  } else {
    if (!plan_ok(a, bwd, is_bf16 ? 2 : 4, vec, grid, mixed))
      return static_cast<int>(cudaErrorInvalidValue);
    void* fn = mixed ? kKernels[8 + bwd * 2 + (vec ? 0 : 1)]
                     : kKernels[bwd * 4 + is_bf16 * 2 + (vec ? 0 : 1)];
    void* params[] = {&a};
    err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params,
                                      kDynSmem, stream);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

Args args(const Config& k) {
  Args a{};
  a.B = k.B;
  a.n_px = k.n_px;
  a.C = k.C;
  a.G = k.G;
  a.width = k.width;
  a.leaky = k.leaky;
  a.r3 = k.r3;
  a.n_sums = k.n_sums;
  a.slope = k.slope;
  a.eps = k.eps;
  a.parts = k.parts;
  a.rows_per_part = k.rows_per_part;
  a.rows_cap = k.rows_cap;
  a.slabs_per_chunk = k.slabs_per_chunk;
  a.n_chunks = k.n_chunks;
  a.grid_reduce = k.grid_reduce;
  a.cluster = k.cluster;
  return a;
}

}  // namespace

// Once per device: raise the grid path's dynamic shared memory to
// kDynSmem and the cluster path's to half an SM's shared memory less the
// runtime's reserve (two cluster-path blocks share an SM), and report the
// SM count, the grid path's blocks per SM that fit (the least over its
// kernels) and shared memory per block, and the cluster path's shared
// memory per block.
extern "C" int rl_norm_device(int* n_sms, int* blocks_per_sm,
                              int* smem_bytes, int* cluster_smem_bytes) {
  int dev = 0, sm_smem = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  int least = 1 << 30;
  for (void* fn : kKernels) {
    if (err != cudaSuccess) break;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDynSmem);
    int n = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads,
                                                          kDynSmem);
    least = n < least ? n : least;
  }
  const int csmem = sm_smem / 2 - reserved;
  for (void* fn : kClusterKernels) {
    if (err != cudaSuccess) break;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               csmem);
  }
  *blocks_per_sm = least;
  *smem_bytes = kDynSmem;
  *cluster_smem_bytes = csmem;
  return static_cast<int>(err);
}

// scratch (grid path): B * parts * 2 * C + B * 2 * C floats, plus B * C /
// 4 for parity; the cluster path takes none.  out: x's type, or float for
// the r3centered mode with affine.  stats (or null): the residuals (B, C,
// 3), written.
extern "C" int rl_instance_norm(const void* x, void* out, const void* scale,
                                const void* bias, void* stats, void* scratch,
                                const Config* k, void* stream) {
  Args a = args(*k);
  a.x = x;
  a.out = out;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.stats = static_cast<float*>(stats);
  a.scratch = static_cast<float*>(scratch);
  return launch(0, k->is_bf16, k->vec, k->grid, k->out_f32, a,
                static_cast<cudaStream_t>(stream));
}

// scratch (grid path): B * parts * n_sums * C + B * n_sums * C floats;
// the cluster path with affine takes the workspace, 4 + B * 2 * C floats
// whose first int is 0 at the launch (and again after it), and none
// without.  dy: x's type, or float for the r3centered mode with affine;
// dx: x's type.
extern "C" int rl_instance_norm_bwd(const void* x, const void* dy,
                                    const void* stats, const void* scale,
                                    const void* bias, void* dx, void* dscale,
                                    void* dbias, void* scratch,
                                    const Config* k, void* stream) {
  Args a = args(*k);
  a.x = x;
  a.dy = dy;
  a.out = dx;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.stats = const_cast<float*>(static_cast<const float*>(stats));
  a.scratch = static_cast<float*>(scratch);
  a.dscale = static_cast<float*>(dscale);
  a.dbias = static_cast<float*>(dbias);
  return launch(1, k->is_bf16, k->vec, k->grid, k->dy_f32, a,
                static_cast<cudaStream_t>(stream));
}
