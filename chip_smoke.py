#!/usr/bin/env python3
"""Drive the PyTorch port (``renderloom_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a
CUDA device and the CUDA toolkit (``nvcc``); it builds the kernels from
``renderloom_torch/csrc`` into ``build/renderloom_torch/`` and then:

1. prints the card, its power limit, and the torch/CUDA versions, and
   builds every kernel (build time printed);
2. holds the instance-norm kernel (K2) against its plain twin at the
   generator's full-width shapes, and times kernel, twin and
   ``F.instance_norm``;
3. holds the rasterizer kernel (K1) against its plain twin at 29 frames
   of 320×480, f32 and bf16 labels, masks on and off, and times both;
4. runs the serving pipeline at full width (configs/hsm.yaml +
   configs/motion.yaml, 480×320, rate 4, 8 keyframes, one clip, seeded
   random weights): checks its output and that both kernels were
   launched, holds K2 against its twin at every shape the run gave it,
   and times the pipeline (frames/s, per-stage times, a profile);
5. holds the card's pipeline against the port's CPU pipeline at 64×96,
   rate 2, 3 keyframes, tiny widths, with identical weights;
6. prints the ``{"kernels": [...]}`` line, the card line, and last the
   ``{"ok": true, "device": {...}}`` line.

Any failed check raises, so the script exits non-zero.  Long outputs
(compiler reports, the profile table) go to ``build/chip_smoke/``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12               # H100 SXM, fp32 outside the tensor cores
LEAKY = 0.2


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def card_state() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float):
    """Least time for the work: bytes over HBM rate, fp32 operations
    over the fp32 peak, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float = 0.0) -> float:
    """Max |got − want|; raises where it exceeds atol + rtol·|want|."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    excess = (diff - atol - rtol * want.float().abs()).max().item()
    tol = f"{atol:.0e}" + (f" + {rtol:.0e}·|ref|" if rtol else "")
    ok = excess <= 0 and np.isfinite(err)
    print(f"  {name}: max_abs_err {err:.3e} (tol {tol}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: error {err} over tolerance {tol}")
    return err


def _write(name: str, text: str):
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        f.write(text)


# ---------------------------------------------------------------------------
# 1. card and build
# ---------------------------------------------------------------------------


def phase_build():
    from renderloom_torch.ops import _build

    print(f"card: {card_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    tic = time.perf_counter()
    logs = _build.build()
    print(f"built {_build.sources()} in {time.perf_counter() - tic:.1f} s "
          f"({len(logs)} compiled, the rest cached)")
    for name, log in logs.items():
        _write(f"ptxas_{name}.txt", log)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# 2. K2 instance norm
# ---------------------------------------------------------------------------

# (shape, dtype, affine, leaky): the generator's full-width shapes at 7
# segments.  Tolerance, as atol + rtol·|ref|: f32 1e-5 + 1e-5·|ref| (1e-4
# at C=512) — moments summed over up to 153600 pixels in another order
# than the twin's differ by ~1e-6 relative, so the error grows with the
# output's size, which the affine stretches past 10; bf16 8e-3 +
# 8e-3·|ref|, one bf16 ulp, since fp32 values a few ulp apart can round
# to neighbouring bf16 values.
K2_CASES = [
    ((7, 320, 480, 16), torch.float32, False, False),
    ((7, 320, 480, 32), torch.float32, True, True),
    ((7, 40, 60, 256), torch.float32, True, False),
    ((7, 20, 30, 512), torch.float32, True, True),
    ((7, 160, 240, 64), torch.bfloat16, True, True),
]


def _k2_tol(shape, dtype):
    if dtype == torch.bfloat16:
        return 8e-3, 8e-3
    tol = 1e-4 if shape[-1] >= 512 else 1e-5
    return tol, tol


def _norm_inputs(shape, dtype, affine, seed, loc=0.0, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (loc + scale * torch.randn(shape, device="cuda", generator=g)
         ).to(dtype)
    s = b = None
    if affine:
        s = 1.0 + 0.5 * torch.randn(shape[-1], device="cuda", generator=g)
        b = torch.randn(shape[-1], device="cuda", generator=g)
    return x, s, b


def _norm_check(name, x, s, b, slope):
    from renderloom_torch.ops import norm_kernel as NK

    atol, rtol = _k2_tol(tuple(x.shape), x.dtype)
    return compare(name, NK.instance_norm_cuda(x, s, b, slope),
                   NK.instance_norm_plain(x, s, b, slope), atol, rtol)


def _norm_times(x, s, b, slope, iters=20):
    """(kernel, twin, F.instance_norm, bound) in ms for one call."""
    from renderloom_torch.ops import norm_kernel as NK

    n = x.numel()
    ms = cuda_ms(lambda: NK.instance_norm_cuda(x, s, b, slope), iters)
    plain = cuda_ms(lambda: NK.instance_norm_plain(x, s, b, slope),
                    max(2, iters // 4), 1)
    xn = x.permute(0, 3, 1, 2)              # NCHW view, channels_last
    lib = cuda_ms(lambda: F.instance_norm(xn, weight=s, bias=b, eps=1e-5),
                  iters)
    # each input read once, each output written once; ~10 fp32
    # operations per element (shifted moments 4, apply 4, affine and
    # leaky 2)
    bnd, by = bound_ms(2 * n * x.element_size(), 10 * n)
    return ms, plain, lib, bnd, by


def phase_norm():
    print("K2 instance norm, kernel vs plain twin:")
    for i, (shape, dtype, affine, leaky) in enumerate(K2_CASES):
        x, s, b = _norm_inputs(shape, dtype, affine, seed=i)
        slope = LEAKY if leaky else None
        _norm_check(f"{shape} {str(dtype)[6:]} affine={affine} "
                    f"leaky={leaky}", x, s, b, slope)
        ms, plain, lib, bnd, _ = _norm_times(x, s, b, slope)
        print(f"    kernel {ms:.4f} ms, twin {plain:.4f} ms, "
              f"F.instance_norm {lib:.4f} ms, bound {bnd:.4f} ms")
    # the reference's fp32 contract: mean 4096, std 1e-2 keeps its variance
    x, _, _ = _norm_inputs((7, 40, 60, 256), torch.float32, False, 9,
                           loc=4096.0, scale=1e-2)
    _norm_check("(7, 40, 60, 256) float32 mean 4096 std 1e-2", x, None,
                None, None)
    from renderloom_torch.ops import norm_kernel as NK

    x64 = x.double()
    ref = (x64 - x64.mean((1, 2), keepdim=True)) / torch.sqrt(
        x64.var((1, 2), unbiased=False, keepdim=True) + 1e-5)
    compare("  the same against the float64 reference",
            NK.instance_norm_cuda(x).double(), ref, 2e-3)


# ---------------------------------------------------------------------------
# 3. K1 rasterizer
# ---------------------------------------------------------------------------

F_RASTER, H_FULL, W_FULL = 29, 320, 480


def _poses(F_: int, H: int, W: int, seed: int):
    """Joints spread over the frame (and a few pixels past its edges),
    about a fifth of them below the confidence threshold."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform([-8, -8], [W + 8, H + 8], (F_, 19, 2))
    conf = np.where(rng.uniform(size=(F_, 19)) > 0.2, 0.9, 0.0)
    return (torch.tensor(coords, dtype=torch.float32, device="cuda"),
            torch.tensor(conf, dtype=torch.float32, device="cuda"))


def raster_bound(F_, H, W, label_bytes, emit_masks):
    n_px = F_ * H * W
    n_bytes = n_px * 22 * label_bytes + (8 * n_px if emit_masks else 0)
    # per pixel: 19 gaussians (~8 ops each), 18 skeleton capsules (~30),
    # the label assembly (~10), and 39 mask capsules (~20) with masks
    flops = n_px * (19 * 8 + 18 * 30 + 10 + (39 * 20 if emit_masks else 0))
    return bound_ms(n_bytes, flops)


def phase_raster():
    from renderloom_torch.ops import rasterize_kernel as RK

    print(f"K1 rasterizer, kernel vs plain twin "
          f"({F_RASTER} frames, {H_FULL}x{W_FULL}):")
    coords, conf = _poses(F_RASTER, H_FULL, W_FULL, seed=0)
    tables = [t.contiguous() for t in
              RK.build_tables(coords, conf, H_FULL, W_FULL)]
    result = None
    for dtype in (torch.float32, torch.bfloat16):
        for masks in (False, True):
            got = RK.rasterize_tables_cuda(*tables, H_FULL, W_FULL, dtype,
                                           masks)
            want = RK.rasterize_tables_plain(*tables, H_FULL, W_FULL, dtype,
                                             masks)
            tol = 1e-5 if dtype == torch.float32 else 8e-3
            err = compare(f"label {str(dtype)[6:]} masks={masks}",
                          got["label"], want["label"], tol)
            if masks:
                for k in ("mask", "part_mask"):
                    compare(f"  {k} (exact)", got[k], want[k], 0.0)
            ms = cuda_ms(lambda: RK.rasterize_tables_cuda(
                *tables, H_FULL, W_FULL, dtype, masks))
            plain = cuda_ms(lambda: RK.rasterize_tables_plain(
                *tables, H_FULL, W_FULL, dtype, masks), 3, 1)
            bnd, by = raster_bound(F_RASTER, H_FULL, W_FULL,
                                   got["label"].element_size(), masks)
            print(f"    kernel {ms:.4f} ms, twin {plain:.4f} ms, "
                  f"bound {bnd:.4f} ms ({by})")
            if dtype == torch.float32 and not masks:    # the serving call
                result = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                              bound_ms=bnd, bound_by=by)
    return result


# ---------------------------------------------------------------------------
# 4. full-width pipeline
# ---------------------------------------------------------------------------


def _bench_inputs(K, H, W, device):
    """bench.py:bench_e2e's inputs, from numpy seed 0."""
    rng = np.random.default_rng(0)
    motion = rng.uniform(-0.4, 0.4, (19, 2, K))
    conf = np.full((19, 1, K), 0.9)
    keys = rng.uniform(0, 1, (K, H, W, 3))
    as_t = lambda a: torch.tensor(a[None], dtype=torch.float32,
                                  device=device)
    return as_t(motion), as_t(conf), as_t(keys)


def _count_norms(gen) -> int:
    """Instance-norm launches per generator call: one per InstanceNorm
    module and one per SPADE."""
    from renderloom_torch.models.layers import InstanceNorm, Spade

    return sum(isinstance(m, (InstanceNorm, Spade)) for m in gen.modules())


def _norm_recorder(seen: Counter):
    """Forward pre-hook counting (shape, dtype, affine, slope) of the
    norm each InstanceNorm / Spade module is about to run."""
    from renderloom_torch.models.layers import InstanceNorm

    def hook(module, args):
        x = args[0]
        affine = isinstance(module, InstanceNorm)
        slope = args[1] if affine and len(args) > 1 else None
        seen[(tuple(x.shape), x.dtype, affine, slope)] += 1
    return hook


def _stage_times(fn_parts, motion, conf, keys, rate, K):
    """Host-clock time of each pipeline stage, synchronised between
    stages (the pipeline's own calls, in its order)."""
    from renderloom_torch.data.hsm import prepare_batch
    from renderloom_torch.eval.motion_infer import bucket_length
    from renderloom_torch.eval.pipeline import (FLOW,
                                                assemble_keyframe_stream)
    from renderloom_torch.ops.flow import upsample_background

    interp, rollout, data_cfg = fn_parts
    L = (K - 1) * rate + 1
    times = {}

    def timed(name, f):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = f()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - tic) * 1e3
        return out

    with torch.inference_mode():
        pred, _, dconf = timed("motion", lambda: interp._run(
            motion, conf, rate, int(np.log2(rate)), bucket_length(L, rate)))
        backs = timed("flow", lambda: torch.stack([
            upsample_background(k, rate, **FLOW) for k in keys]))

        def prep():
            poses = torch.cat([pred[..., :L] * 256 + 256, dconf], dim=2)
            return prepare_batch(
                {"images": assemble_keyframe_stream(keys * 255.0, rate),
                 "dain": backs * 255.0,
                 "poses": poses.permute(0, 3, 1, 2).float()}, data_cfg)

        p = timed("prepare (raster)", prep)
        timed("rollout", lambda: rollout(
            {"label": p["label"], "back": p["back"], "key_img": p["image"]}))
    return times


def _profile(fn, args) -> str:
    """One profiled run: device time by kernel, and the kernels' busy
    share of the run's wall time (CUPTI's own buffer activity left
    out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        tic = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - tic) * 1e3
    dev = lambda e: (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0) or 0) / 1e3
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev(e) > 0
                   and not e.key.startswith(("Activity Buffer",
                                             "Buffer Flush"))),
                  key=dev, reverse=True)
    busy = sum(dev(e) for e in rows)
    lines = [f"profiled run: wall {wall:.2f} ms, kernels {busy:.2f} ms "
             f"({100 * busy / wall:.1f}% of wall), {len(rows)} kernels"]
    for e in rows[:25]:
        lines.append(f"  {dev(e):10.3f} ms  {e.count:6d}x  {e.key[:110]}")
    # which convolutions the device time goes to, by input shapes
    total = lambda e: (getattr(e, "device_time_total", None)
                       or getattr(e, "cuda_time_total", 0) or 0) / 1e3
    convs = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                    if e.key == "aten::cudnn_convolution"),
                   key=total, reverse=True)
    lines.append("convolutions by device time (input, weight shapes):")
    for e in convs[:20]:
        lines.append(f"  {total(e):10.3f} ms  {e.count:4d}x  "
                     f"{e.input_shapes[:2]}")
    return "\n".join(lines)


def phase_pipeline():
    from renderloom_torch.core.config import (load_motion_config,
                                              load_renderer_config)
    from renderloom_torch.eval.motion_infer import MotionInterpolator
    from renderloom_torch.eval.pipeline import build_pipeline
    from renderloom_torch.models.layers import InstanceNorm, Spade
    from renderloom_torch.ops import norm_kernel as NK
    from renderloom_torch.ops import rasterize_kernel as RK
    from renderloom_torch.train.gan import make_segment_rollout

    mcfg = load_motion_config(os.path.join(ROOT, "configs", "motion.yaml"))
    rcfg = load_renderer_config(os.path.join(ROOT, "configs", "hsm.yaml"))
    H, W = rcfg.data.model_height, rcfg.data.model_width
    rate, K = 4, 8
    L = (K - 1) * rate + 1
    print(f"pipeline: {W}x{H}, rate {rate}, {K} keyframes, 1 clip "
          f"(L = {L}), hsm.yaml + motion.yaml widths, random weights")
    tic = time.perf_counter()
    fn, m_model, gen = build_pipeline(mcfg, rcfg, rate, K, device="cuda")
    print(f"  built models in {time.perf_counter() - tic:.1f} s")
    motion, conf, keys = _bench_inputs(K, H, W, "cuda")

    # warm-up, recording the input of every instance norm of the run
    seen = Counter()
    hooks = [m.register_forward_pre_hook(_norm_recorder(seen))
             for m in gen.modules() if isinstance(m, (InstanceNorm, Spade))]
    fn(motion, conf, keys)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()

    # the counted run
    NK.instance_norm_cuda.launches = 0
    RK.rasterize_tables_cuda.launches = 0
    torch.cuda.synchronize()
    fused, sync = fn(motion, conf, keys)
    torch.cuda.synchronize()
    launches = {"rasterize": RK.rasterize_tables_cuda.launches,
                "instance_norm": NK.instance_norm_cuda.launches}
    want_norms = _count_norms(gen) * (rate - 1)
    print(f"  launches in one run: {launches} (K2 expected {want_norms} = "
          f"{_count_norms(gen)} per generator step x {rate - 1} steps)")
    if launches != {"rasterize": 1, "instance_norm": want_norms}:
        raise AssertionError(f"kernel launches {launches}")
    if sum(seen.values()) != want_norms:
        raise AssertionError(f"recorded {sum(seen.values())} norms")

    if tuple(fused.shape) != (1, L, H, W, 3):
        raise AssertionError(f"fused shape {tuple(fused.shape)}")
    if not bool(torch.isfinite(fused).all()):
        raise AssertionError("non-finite output")
    key_unit = (keys * 255.0).float() / 127.5 - 1.0
    if not torch.equal(fused[:, ::rate], key_unit):
        raise AssertionError("keyframes did not pass through exactly")
    print(f"  output {tuple(fused.shape)} finite, keyframes exact, "
          f"checksum {float(sync):.6e}, range [{fused.min().item():.3f}, "
          f"{fused.max().item():.3f}]")

    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn(motion, conf, keys)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - tic)
    fps = len(runs) * L / sum(runs)
    print(f"  e2e_interp_frames_per_sec {fps:.3f} (runs of "
          + ", ".join(f"{r * 1e3:.1f}" for r in runs) + " ms per clip; "
          f"SM clock, power, temperature right after: {card_state()})")

    interp = MotionInterpolator(m_model, np.zeros((19, 2), np.float32),
                                np.ones((19, 2), np.float32), "cuda")
    stages = _stage_times((interp, make_segment_rollout(gen, rate),
                           rcfg.data), motion, conf, keys, rate, K)
    print("  stages (ms, synchronised): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()))
    prof = _profile(fn, (motion, conf, keys))
    _write("profile.txt", prof)
    print("  " + "\n  ".join(prof.splitlines()))

    # K2 at every shape the run gave it: hold against the twin, and sum
    # kernel, twin, library and bound times over the run's launches
    print(f"  K2 at the run's {len(seen)} distinct shapes:")
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    err, bound_by = 0.0, Counter()
    for i, ((shape, dtype, affine, slope), n) in enumerate(sorted(
            seen.items(), key=lambda kv: -np.prod(kv[0][0]))):
        x, s, b = _norm_inputs(shape, dtype, affine, seed=100 + i)
        err = max(err, _norm_check(f"{n:3d}x {shape} affine={affine} "
                                   f"leaky={slope is not None}", x, s, b,
                                   slope))
        ms, plain, lib, bnd, by = _norm_times(x, s, b, slope, iters=10)
        bound_by[by] += n * bnd
        for k, v in zip(tot, (ms, plain, lib, bnd)):
            tot[k] += n * v
    print(f"  K2 per clip: kernel {tot['ms']:.3f} ms, twin "
          f"{tot['plain_ms']:.3f} ms, F.instance_norm "
          f"{tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms")
    # bound_by: what bounds the shapes that carry most of the summed bound
    norm_entry = dict(max_abs_err=err, bound_by=bound_by.most_common(1)[0][0],
                      **tot,
                      shape=f"{want_norms} launches over {len(seen)} "
                            f"shapes, B=7, C 16-512, summed per clip")
    return launches, fps, norm_entry


# ---------------------------------------------------------------------------
# 5. card pipeline vs CPU pipeline
# ---------------------------------------------------------------------------


def phase_cpu_match():
    from renderloom_torch.core import config as C
    from renderloom_torch.eval.pipeline import build_pipeline

    H, W, rate, K = 64, 96, 2, 3
    mcfg = C.MotionConfig(
        transformer=C.TransformerConfig(hidden_dim=32, nheads=4,
                                        dim_feedforward=64, enc_layers=2,
                                        dec_layers=2, dropout=0.0),
        pos_encode=C.PosEncodeConfig(hidden_dim=32))
    rcfg = C.RendererConfig(
        gen=C.GeneratorConfig(
            num_filters=4, max_num_filters=16, num_layers=6,
            num_downsamples=4, do_checkpoint=False,
            mask=C.MaskNetConfig(num_filters=4, max_num_filters=16,
                                 num_downsamples=3, num_res_blocks=1),
            embed=C.EmbedConfig(num_filters=4, max_num_filters=16,
                                num_downsamples=4)),
        data=C.RendererDataConfig(model_width=W, model_height=H,
                                  load_width=W, load_height=H))
    # statistics that keep the random transformer's joints in the frame
    mean = np.zeros((19, 2), np.float32)
    mean[-1] = (-0.8, -0.85)
    std = np.full((19, 2), 0.02, np.float32)
    rng = np.random.default_rng(1)
    motion = np.stack([rng.uniform(-0.9, -0.7, (1, 19, K)),
                       rng.uniform(-0.9, -0.8, (1, 19, K))], axis=2)
    conf = np.full((1, 19, 1, K), 0.9)
    keys = rng.uniform(0, 1, (1, K, H, W, 3))
    outs = []
    for device in ("cpu", "cuda"):
        fn, _, _ = build_pipeline(mcfg, rcfg, rate, K, mean=mean, std=std,
                                  device=device)
        as_t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        fused, _ = fn(as_t(motion), as_t(conf), as_t(keys))
        outs.append(fused.cpu())
    print(f"card pipeline vs CPU pipeline ({W}x{H}, rate {rate}, {K} "
          f"keyframes, tiny widths, same weights):")
    compare("fused frames", outs[1], outs[0], 1e-3)


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    tic = time.perf_counter()
    phase_build()
    phase_norm()
    raster = phase_raster()
    launches, fps, norm = phase_pipeline()
    phase_cpu_match()
    kernels = [
        dict(name="rasterize", route="cuda",
             source="renderloom_torch/csrc/rasterize.cu",
             replaces="renderloom/ops/rasterize_pallas.py:408",
             launches=launches["rasterize"], library_ms=None,
             shape=f"{F_RASTER}x{H_FULL}x{W_FULL}x22 f32 label, no masks",
             **raster),
        dict(name="instance_norm", route="cuda",
             source="renderloom_torch/csrc/instance_norm.cu",
             replaces="renderloom/ops/norm_pallas.py:150",
             launches=launches["instance_norm"], **norm),
    ]
    print(f"e2e_interp_frames_per_sec {fps:.3f}; chip_smoke done in "
          f"{time.perf_counter() - tic:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
