#!/usr/bin/env python3
"""Where an r3centered instance-norm call's device time goes on an NVIDIA
card (`renderloom_torch/csrc/instance_norm.cu`, K2 and K2b).

Two measurements, both on the card:

* **The launch floor.**  The device time of kernels that do nothing but
  launch and wait at barriers: an empty cooperative launch of the norm
  kernels' grid (132 blocks of 512 threads, 200 KB of dynamic shared
  memory each) with 0-3 grid barriers, and ordinary launches with a
  cluster dimension (1, 8 or 16 blocks a cluster) with 0-2 cluster
  barriers.
* **Phase stamps.**  An instrumented copy of the norm source, written
  and built under ``build/norm_probe/`` (the committed source does not
  change), in which thread 0 of every block reads ``%globaltimer`` at
  the start and end of each kernel and at each phase boundary the
  kernel marks with a numbered comment (``// 2. sums: ...``): the grid
  path's load, sums, grid barrier, L2 reduction of the partial rows,
  apply and dgamma/dbeta tail; the cluster path's load, sums, cluster
  barrier with the exchange of partial sums, apply and tail.  A phase's
  time adds up over a kernel's chunks.  Per shape it prints the
  kernel's span (first block's start to last block's end), the spread
  of the blocks' starts, and each phase's median and largest duration
  over the blocks.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 scripts/norm_probe_h100.py [--out build/norm_probe/probe.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from renderloom_torch.ops import _build  # noqa: E402
from renderloom_torch.ops import norm_kernel as NK  # noqa: E402

OUT = os.path.join(ROOT, "build", "norm_probe")
N_PROBE_BLOCKS = 4096

FLOOR_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void k_grid_sync(int n) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
}
__global__ void k_cluster_sync(int n) {
  cg::cluster_group c = cg::this_cluster();
  for (int i = 0; i < n; ++i) c.sync();
}

extern "C" int probe_coop(int grid, int threads, int smem, int n,
                          void* stream) {
  static bool set = false;
  if (!set) {
    cudaFuncSetAttribute((void*)k_grid_sync,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         227 * 1024);
    set = true;
  }
  void* args[] = {&n};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)k_grid_sync, dim3(grid), dim3(threads), args, smem,
      (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int probe_cluster(int grid, int threads, int smem, int cluster,
                             int n, void* stream) {
  static bool set = false;
  if (!set) {
    cudaFuncSetAttribute((void*)k_cluster_sync,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         227 * 1024);
    cudaFuncSetAttribute((void*)k_cluster_sync,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, k_cluster_sync, n);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
"""

# Inserted before the namespaces of the instrumented copy.  PROBE_AT(k)
# ends the phase that runs (if any) and starts phase k, so a phase's time
# adds up over a kernel's chunk loop.
PROBE_HEAD = r"""
#define RL_PROBE_BLOCKS %d
#define RL_PROBE_N %d
__device__ unsigned long long g_probe[RL_PROBE_BLOCKS * (RL_PROBE_N + 2)];
__device__ __forceinline__ unsigned long long rl_now() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define PROBE_INIT() \
  unsigned long long _pt = rl_now(), _p0 = _pt, _pacc[RL_PROBE_N] = {}; \
  int _pk = -1
#define PROBE_AT(k) \
  do { \
    const unsigned long long _n = rl_now(); \
    if (_pk >= 0) _pacc[_pk] += _n - _pt; \
    _pt = _n; \
    _pk = (k); \
  } while (0)
#define PROBE_END() \
  do { \
    PROBE_AT(-1); \
    if (threadIdx.x == 0 && blockIdx.x < RL_PROBE_BLOCKS) { \
      unsigned long long* _o = g_probe + blockIdx.x * (RL_PROBE_N + 2); \
      _o[0] = _p0; \
      _o[1] = _pt; \
      for (int _i = 0; _i < RL_PROBE_N; ++_i) _o[2 + _i] = _pacc[_i]; \
    } \
  } while (0)
extern "C" int rl_probe_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(
      dst, g_probe, sizeof(unsigned long long) * (RL_PROBE_N + 2) * n);
}
extern "C" int rl_probe_clear() {
  static unsigned long long zero[RL_PROBE_BLOCKS * (RL_PROBE_N + 2)];
  return (int)cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
}
"""

# The phases a kernel of csrc/instance_norm.cu may mark with a numbered
# comment ("// 2. sums: ..."): the grid path's load, sums, grid barrier,
# reduction of the partial rows from L2, apply and dgamma/dbeta tail; the
# cluster path's load, sums, exchange of partial sums through distributed
# shared memory behind the cluster barrier, apply and tail.
PHASES = ("load", "sums", "barrier", "partials", "exchange", "apply", "tail")
STRIDE = len(PHASES) + 2        # per block: start, end, each phase's ns
PHASE_MARK = re.compile(r"^(\s*)// \d+\. ([a-z]+):", re.M)


def _kernel_bodies(src: str):
    """(start, end) of the body of every ``__global__`` kernel of ``src``
    taking ``(Args a)``: from after its ``{`` to its closing ``}``."""
    for m in re.finditer(r"\(Args a\)\s*\{", src):
        head = src[max(src.rfind(";", 0, m.start()),
                       src.rfind("}", 0, m.start())):m.start()]
        if "__global__" not in head:
            continue
        depth, i = 1, m.end()
        while depth:
            if src.startswith("//", i):
                i = src.index("\n", i)
                continue
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            i += 1
        yield m.end(), i - 1


def _instrument(body: str) -> str:
    """A kernel body with a stamp at its start, before each phase comment,
    before each ``return`` and at its end."""
    def mark(m):
        return f"{m.group(1)}PROBE_AT({PHASES.index(m.group(2))});\n" \
               + m.group(0)
    body = PHASE_MARK.sub(mark, body)
    body = re.sub(r"\breturn;", "{ PROBE_END(); return; }", body)
    return "\n  PROBE_INIT();" + body + "  PROBE_END();\n"


def _instrumented_source() -> str:
    src = (_build.CSRC / "instance_norm.cu").read_text()
    spans = [(a, b) for a, b in _kernel_bodies(src)
             if PHASE_MARK.search(src, a, b)]
    if not spans:
        raise RuntimeError("no kernel of instance_norm.cu marks its phases")
    unknown = {m.group(2) for a, b in spans
               for m in PHASE_MARK.finditer(src, a, b)} - set(PHASES)
    if unknown:
        raise RuntimeError(f"phases {sorted(unknown)} not in {PHASES}")
    for a, b in reversed(spans):
        src = src[:a] + _instrument(src[a:b]) + src[b:]
    head = src.index("namespace cg = cooperative_groups;")
    return (src[:head] + PROBE_HEAD % (N_PROBE_BLOCKS, len(PHASES))
            + src[head:])


def _nvcc(src: str, name: str) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, f"{name}.cu")
    so = os.path.join(OUT, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-o", so, cu], check=True,
                   capture_output=True, timeout=600)
    return ctypes.CDLL(so)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def floor() -> list:
    """Device ms per launch of empty kernels and lone barriers."""
    lib = _nvcc(FLOOR_SRC, "floor")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_coop.argtypes = [i, i, i, i, ptr]
    lib.probe_cluster.argtypes = [i, i, i, i, i, ptr]
    rows = []

    def run(name, fn):
        err = fn()
        torch.cuda.synchronize()
        if err:
            rows.append(dict(case=name, error=err))
            print(f"  {name}: CUDA error {err}")
            return
        ms = CS.device_ms(fn, 50)
        rows.append(dict(case=name, device_us=ms * 1e3))
        print(f"  {name}: {ms * 1e3:.2f} us a launch")

    for n in (0, 1, 2, 3):
        run(f"cooperative 132 x 512, 200 KB, {n} grid barriers",
            lambda n=n: lib.probe_coop(132, 512, 200 * 1024, n, _stream()))
    run("cooperative 132 x 512, 0 KB, 0 grid barriers",
        lambda: lib.probe_coop(132, 512, 0, 0, _stream()))
    for grid, threads, smem, cl in ((1, 256, 8192, 1), (8, 256, 8192, 8),
                                    (128, 256, 65536, 8),
                                    (256, 256, 65536, 16)):
        for n in (0, 1, 2):
            run(f"cluster launch {grid} x {threads}, {smem // 1024} KB, "
                f"cluster {cl}, {n} cluster barriers",
                lambda grid=grid, threads=threads, smem=smem, cl=cl, n=n:
                lib.probe_cluster(grid, threads, smem, cl, n, _stream()))
    return rows


# (shape, affine, leaky, direction): the smallest, a medium and the
# largest r3centered calls of a bf16 step or clip
STAMP_CASES = [
    ((8, 5, 5, 128), True, True, "bwd"),
    ((8, 5, 5, 128), True, True, "fwd"),
    ((1, 4, 4, 32), False, False, "bwd"),
    ((1, 4, 4, 32), False, False, "fwd"),
    ((4, 20, 30, 256), True, True, "bwd"),
    ((4, 40, 60, 256), True, True, "bwd"),
    ((4, 80, 120, 128), True, True, "bwd"),
    ((7, 80, 120, 128), True, True, "fwd"),
    ((4, 80, 120, 64), True, True, "fwd"),
    ((4, 40, 60, 256), True, True, "fwd"),
    ((4, 20, 30, 512), False, False, "fwd"),
    ((4, 9, 14, 512), True, True, "fwd"),
    ((4, 160, 240, 64), True, True, "bwd"),
    ((4, 320, 480, 32), True, True, "bwd"),
    ((7, 320, 480, 32), True, True, "fwd"),
]


def _summary(raw, n_blocks):
    blocks = [raw[k * STRIDE:(k + 1) * STRIDE] for k in range(n_blocks)]
    blocks = [b for b in blocks if b[1] > 0]
    starts = [b[0] for b in blocks]
    ends = [b[1] for b in blocks]
    out = dict(blocks=len(blocks),
               span_us=(max(ends) - min(starts)) / 1e3,
               start_spread_us=(max(starts) - min(starts)) / 1e3,
               block_us_median=statistics.median(
                   e - s for s, e in zip(starts, ends)) / 1e3)
    for k, name in enumerate(PHASES):
        vals = [b[2 + k] / 1e3 for b in blocks]
        if any(vals):
            out[f"{name}_us_median"] = statistics.median(vals)
            out[f"{name}_us_max"] = max(vals)
    return out


def stamps() -> list:
    """Phase stamps of the instrumented kernels at STAMP_CASES."""
    plain_lib = NK._library()
    probe = _nvcc(_instrumented_source(), "instance_norm_probe")
    probe.rl_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    rows = []
    for shape, affine, leaky, way in STAMP_CASES:
        slope = CS.LEAKY if leaky else None
        x, dy, s, b = CS._bwd_r3_inputs(shape, affine, 1000)
        stats = torch.empty((shape[0], shape[-1], 3), device="cuda")
        NK.instance_norm_cuda(x, s, b, slope, 1e-5, stats, r3centered=True)
        if way == "fwd":
            fn = lambda: NK.instance_norm_cuda(x, s, b, slope, 1e-5, stats,
                                               r3centered=True)
        else:
            fn = lambda: NK.instance_norm_bwd_cuda(x, dy, stats, s, b, slope,
                                                   r3centered=True)
        key = f"{way} {shape} affine={affine} leaky={leaky}"
        row = dict(case=key, device_us=CS.device_ms(fn, 40) * 1e3,
                   host_us=CS.host_us(fn))
        cfg = NK._config(x, 1 if way == "fwd" else 2, 0, slope,
                         1e-5 if way == "fwd" else 0.0, True, True,
                         out_f32=way == "fwd" and affine,
                         dy_f32=way == "bwd" and affine)[0]
        row["plan"] = {f: getattr(cfg, f) for f, _ in cfg._fields_}
        NK._lib = None
        saved = _build.load
        _build.load = lambda name: probe
        try:
            NK._library()
            n_geo = len(plain_lib.rl_norm_device.argtypes)
            probe.rl_norm_device(*[ctypes.byref(ctypes.c_int())
                                   for _ in range(n_geo)])
            row["probed_device_us"] = CS.device_ms(fn, 40) * 1e3
            torch.cuda.synchronize()
            probe.rl_probe_clear()
            fn()
            torch.cuda.synchronize()
            raw = (ctypes.c_ulonglong * (STRIDE * N_PROBE_BLOCKS))()
            probe.rl_probe_read(raw, N_PROBE_BLOCKS)
        finally:
            _build.load = saved
            NK._lib = plain_lib
        row.update(_summary(list(raw), N_PROBE_BLOCKS))
        rows.append(row)
        print(f"  {key}: " + ", ".join(
            f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if k not in ("case", "plan")))
        print(f"    plan {row['plan']}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(OUT, "probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("norm_probe_h100: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {CS.card_line()}")
    _build.build(["instance_norm"])
    print("launch floor (device us a launch, 50 launches behind a spin):")
    rows = floor()
    print("phase stamps (us; thread 0 of each block, %globaltimer):")
    res = dict(card=CS.card_line(), floor=rows, stamps=stamps())
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
