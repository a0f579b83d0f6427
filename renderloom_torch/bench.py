"""Benchmark harness of the port: prints ONE JSON line.

Port of the repository's ``bench.py`` to ``renderloom_torch`` on the
CUDA device, with its three metrics and shapes (``BENCH_METRIC``):

* ``e2e`` (default): ``e2e_interp_frames_per_sec``, one clip at
  480×320, rate 4, 8 keyframes, 3 timed runs after 2 warm-up runs, both
  models in bf16 with the parity-layout generator (``fastpath=True``),
  seeded random weights (motion seed 0, generator seed 1).  With
  ``BENCH_SERVE=frozen`` it times the pipeline exported and loaded back
  (``renderloom_torch.eval.export``, written under ``build/bench/``) in
  place of the live one;
* ``motion_train``: ``motion_train_seqs_per_sec``, the motion
  transformer's train step (``MotionConfig()``, the reference's
  motion.yaml, in bf16) at B 16, L 321, 20 timed steps after 3 warm-up;
* ``gan_train``: ``gan_train_windows_per_sec``, the renderer's train
  step (``RendererConfig()``, the reference's HSM.yaml, in bf16, no
  ``do_checkpoint``) on batch 4 (``BENCH_GAN_BATCH``) × 4-frame
  prepared windows at 480×320, 4 timed steps after 1 warm-up.

Each time is the host clock over synchronised runs.  There is no CPU
fallback: without a CUDA device it raises, and only ``--device cpu``
runs it on the CPU, at ``bench.py``'s reduced CPU shapes in float32,
tagged ``"scaled"``.  The JSON line carries ``metric``, ``value``,
``unit``, ``vs_baseline`` (null: no published number), ``device`` and,
on the card, the card's name; everything else the run prints goes to
stderr.

Run: ``python -m renderloom_torch.bench`` (``--device cpu`` for the
reduced CPU run).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from renderloom_torch.core.config import MotionConfig, RendererConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_e2e(device: torch.device, frozen: bool = False, rate: int = 4,
              keyframes: int = 8, repeats: int = 3) -> dict:
    """End-to-end interpolation throughput in output frames/s."""
    from renderloom_torch.eval.pipeline import build_pipeline

    on_card = device.type == "cuda"
    dtype = "bfloat16" if on_card else "float32"
    mcfg = MotionConfig(compute_dtype=dtype)
    rcfg = RendererConfig(compute_dtype=dtype)
    if not on_card:     # reduced shapes, tagged below
        rcfg = dataclasses.replace(rcfg, data=dataclasses.replace(
            rcfg.data, model_height=64, model_width=96))
        rate, keyframes, repeats = 2, 4, 2
    H, W = rcfg.data.model_height, rcfg.data.model_width
    fn, m_model, gen = build_pipeline(mcfg, rcfg, rate, keyframes,
                                      device=device, fastpath=on_card)
    if frozen:
        from renderloom_torch.eval.export import (export_pipeline,
                                                  load_exported,
                                                  save_exported)
        path = os.path.join(ROOT, "build", "bench",
                            f"pipeline_{device.type}.pt2")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_exported(path, *export_pipeline(fn, m_model, gen, 1, keyframes,
                                             H, W, rate, device))
        fn, _ = load_exported(path)

    rng = np.random.default_rng(0)
    K, L = keyframes, (keyframes - 1) * rate + 1
    as_dev = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                       device=device)
    motion = as_dev(rng.uniform(-0.4, 0.4, (1, 19, 2, K)))
    conf = as_dev(np.full((1, 19, 1, K), 0.9))
    keys = as_dev(rng.uniform(0, 1, (1, K, H, W, 3)))

    carry = torch.zeros((), device=device)
    for _ in range(2):      # warm-up: cuDNN's algorithm choices
        _, carry = fn(motion + carry, conf, keys + carry)
    _sync(device)
    tic = time.perf_counter()
    for _ in range(repeats):
        _, carry = fn(motion + carry, conf, keys + carry)
    _sync(device)
    wall = time.perf_counter() - tic
    result = {"metric": "e2e_interp_frames_per_sec",
              "value": round(repeats * L / wall, 2), "unit": "frame/s",
              "vs_baseline": None, "serve": "frozen" if frozen else "live"}
    if not on_card:
        result["scaled"] = f"{H}x{W} rate{rate} (CPU-reduced shapes)"
    return result


def bench_motion_train(device: torch.device, steps: int = 20,
                       warmup: int = 3) -> dict:
    """Motion-transformer train-step throughput (seq/s)."""
    from renderloom_torch.train.motion import (create_motion_state,
                                               make_train_step)

    on_card = device.type == "cuda"
    cfg = MotionConfig(compute_dtype="bfloat16" if on_card else "float32")
    if not on_card:     # reduced shapes, tagged below
        cfg = dataclasses.replace(cfg, batch_size=4, dataset=dataclasses
                                  .replace(cfg.dataset, max_seq_length=65))
        steps, warmup = 5, 1
    state = create_motion_state(cfg, device, seed=0)
    step = make_train_step(cfg, np.zeros((19, 2), np.float32),
                           np.ones((19, 2), np.float32))
    L, B = cfg.dataset.max_seq_length, cfg.batch_size
    rng = np.random.default_rng(0)
    batch = {"motion3d": torch.as_tensor(
                 rng.normal(0, 0.3, (B, 52, 3, L)).astype(np.float32),
                 device=device),
             "pad_mask": torch.zeros((B, L), dtype=torch.bool,
                                     device=device)}
    for _ in range(warmup):
        metrics = step(state, batch)
    float(metrics["loss/total"])
    tic = time.perf_counter()
    for _ in range(steps):
        metrics = step(state, batch)
    float(metrics["loss/total"])       # steps chain through the state
    wall = time.perf_counter() - tic
    result = {"metric": "motion_train_seqs_per_sec",
              "value": round(steps * B / wall, 2), "unit": "seq/s",
              "vs_baseline": None}
    if not on_card:
        result["scaled"] = "L=65 B=4 (CPU-reduced shapes)"
    return result


def bench_gan_train(device: torch.device, steps: int = 4,
                    warmup: int = 1) -> dict:
    """Renderer GAN train-step throughput (windows/s): batch 4 × 4-frame
    windows at 480×320, per-frame D and G updates."""
    from renderloom_torch.train.gan import (create_gan_state,
                                            make_gan_train_step,
                                            make_perceptual)

    on_card = device.type == "cuda"
    cfg = RendererConfig(compute_dtype="bfloat16" if on_card else "float32")
    cfg = dataclasses.replace(
        cfg, batch_size=int(os.environ.get("BENCH_GAN_BATCH",
                                           cfg.batch_size)),
        gen=dataclasses.replace(cfg.gen, do_checkpoint=False))
    if not on_card:     # reduced shapes, tagged below
        # the 8×8 hand crops of 64×96 frames take one hand layer fewer
        # (the last would convolve a 1×1 map with a 4×4 kernel)
        cfg = dataclasses.replace(
            cfg, batch_size=2,
            gen=dataclasses.replace(cfg.gen, num_filters=4,
                                    max_num_filters=32),
            dis=dataclasses.replace(cfg.dis, hand=dataclasses.replace(
                cfg.dis.hand, num_layers=cfg.dis.hand.num_layers - 1)),
            data=dataclasses.replace(cfg.data, model_height=64,
                                     model_width=96, max_frames=3))
        steps, warmup = 2, 1
    H, W = cfg.data.model_height, cfg.data.model_width
    state = create_gan_state(cfg, device, seed=0)
    step = make_gan_train_step(cfg, make_perceptual(cfg, device, seed=0))
    B, L = cfg.batch_size, cfg.data.max_frames
    rng = np.random.default_rng(0)
    as_dev = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    batch = {"label": as_dev(rng.uniform(-1, 1, (B, L, H, W, 22))),
             "image": as_dev(rng.uniform(-1, 1, (B, L, H, W, 3))),
             "back": as_dev(rng.uniform(-1, 1, (B, L, H, W, 3))),
             "fg_mask": as_dev(rng.uniform(0, 1, (B, L, H, W, 1)) > 0.5)}
    for _ in range(warmup):
        metrics = step(state, batch)
    float(metrics["g/total"])
    tic = time.perf_counter()
    for _ in range(steps):
        metrics = step(state, batch)
    float(metrics["g/total"])
    wall = time.perf_counter() - tic
    result = {"metric": "gan_train_windows_per_sec",
              "value": round(steps * B / wall, 3), "unit": "window/s",
              "vs_baseline": None}
    if not on_card:
        result["scaled"] = (f"{H}x{W} small-gen, hand D one layer fewer "
                            "(CPU-reduced shapes)")
    return result


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="renderloom_torch benchmark "
                                            "(BENCH_METRIC=e2e|motion_"
                                            "train|gan_train)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default), or cpu for the reduced CPU run")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("renderloom_torch.bench: no CUDA device; pass "
                           "--device cpu for the reduced CPU run")
    which = os.environ.get("BENCH_METRIC", "e2e")
    serve = os.environ.get("BENCH_SERVE", "live")
    if which not in ("e2e", "motion_train", "gan_train"):
        raise ValueError(f"BENCH_METRIC={which!r}: e2e, motion_train or "
                         "gan_train")
    if serve not in ("live", "frozen"):
        raise ValueError(f"BENCH_SERVE={serve!r}: live or frozen")
    with contextlib.redirect_stdout(sys.stderr):
        if which == "motion_train":
            result = bench_motion_train(device)
        elif which == "gan_train":
            result = bench_gan_train(device)
        else:
            result = bench_e2e(device, frozen=serve == "frozen")
    result["device"] = device.type
    if device.type == "cuda":
        result["card"] = torch.cuda.get_device_name(device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
