"""Train the pose-guided neural renderer (GAN) with the PyTorch port.

Port of the JAX package's ``renderloom/cli/train_renderer.py``: windows
from the HumanSloMo h5 (``--h5``; :class:`HsmReader`, train phase,
read and decoded on a prefetch thread two batches ahead) or random ones
(``--synthetic``) go through the train-mode preparation and the
per-frame D/G step on the device.  Every epoch follows the JAX loop:

* the frame-count curriculum: every ``update_frame_step`` epochs the
  window grows by one frame (``reader.set_max_frames``, which also
  recomputes the steps per epoch; the synthetic windows keep their
  length, as in JAX);
* ``train/`` metrics to ``<out-dir>/metrics.jsonl`` every 10 steps
  (:class:`MetricLogger`, the JAX package's lines) and a console line
  per epoch with ``steps_per_sec``;
* every 4 epochs, ``evaluate_h5`` over the test clips on the current
  generator (``convert.flax_trees(state.gen)``) with the training
  perceptual loss, logged under ``eval/``;
* a ``torch.save`` checkpoint (both networks with their power-iteration
  state, both optimizers, the step and the draw generator) every 4
  epochs and after the last;
* with ``--profile-dir``, a ``torch.profiler`` trace of steps 3–8 of the
  first epoch.

The VGG19 perceptual term needs pretrained weights (``VGG19_NPZ`` or
``data/vgg19_features.npz``) unless ``--allow-random-vgg`` or
``--synthetic`` is given.  The epoch loop is :func:`train`, which takes
the readers; :func:`main` builds them from ``--h5``.

It runs on the CUDA device unless ``--device cpu`` is given, and
without a CUDA device it refuses to run.

Usage:
  python -m renderloom_torch.cli.train_renderer --config configs/hsm.yaml \\
      --h5 HumanSlomo.h5 --out-dir runs/renderer_torch
  python -m renderloom_torch.cli.train_renderer --synthetic \\
      --config configs/hsm.yaml --epochs 1 --steps-per-epoch 4
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

import renderloom_torch
from renderloom_torch.cli import cli_device
from renderloom_torch.convert import flax_trees
from renderloom_torch.core.config import RendererConfig, load_renderer_config
from renderloom_torch.core.logging import MetricLogger, snapshot_source
from renderloom_torch.data.hsm import HsmReader
from renderloom_torch.data.prefetch import prefetch
from renderloom_torch.eval.render_eval import evaluate_h5
from renderloom_torch.train.gan import (create_gan_state, make_gan_train_step,
                                        make_perceptual)
from renderloom_torch.utils.profiling import trace

TRAIN_LOG_EVERY = 10     # steps between ``train/`` records, as in JAX


def synthetic_batches(rng: np.random.Generator, n: int, batch: int,
                      frames: int, h0: int, w0: int):
    """``n`` raw windows of ``frames`` frames at h0×w0, as the JAX CLI's
    ``synthetic_batches`` draws them (numpy arrays)."""
    for _ in range(n):
        poses = np.zeros((batch, frames, 19, 3), np.float32)
        poses[..., 0] = rng.uniform(10, w0 - 10, (batch, frames, 19))
        poses[..., 1] = rng.uniform(10, h0 - 10, (batch, frames, 19))
        poses[..., 2] = 0.9
        yield {
            "images": rng.integers(0, 255, (batch, frames, h0, w0, 3),
                                   dtype=np.uint8),
            "dain": rng.integers(0, 255, (batch, frames, h0, w0, 3),
                                 dtype=np.uint8),
            "poses": poses,
        }


def save_checkpoint(path: str, state) -> None:
    torch.save({"step": state.step, "gen": state.gen.state_dict(),
                "dis": state.dis.state_dict(),
                "opt_g": state.opt_g.state_dict(),
                "opt_d": state.opt_d.state_dict(),
                "rng": state.rng.get_state()}, path)


def load_checkpoint(path: str, state) -> None:
    ckpt = torch.load(path, map_location=state.opt_g.flat.device)
    state.gen.load_state_dict(ckpt["gen"])
    state.dis.load_state_dict(ckpt["dis"])
    state.opt_g.load_state_dict(ckpt["opt_g"])
    state.opt_d.load_state_dict(ckpt["opt_d"])
    state.rng.set_state(ckpt["rng"].cpu())      # mapped to the device
    state.step = ckpt["step"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="renderloom_torch renderer "
                                            "training")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--out-dir", type=str, default="runs/renderer_torch")
    p.add_argument("--h5", type=str, default=None,
                   help="HumanSlomo.h5 path (overrides the config)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="train on random windows (no h5 needed)")
    p.add_argument("--allow-random-vgg", action="store_true",
                   help="proceed without pretrained VGG19 weights (the "
                        "perceptual loss then uses random features — NOT "
                        "the reference objective)")
    p.add_argument("--steps-per-epoch", type=int, default=20,
                   help="synthetic mode only")
    p.add_argument("--height", type=int, default=None,
                   help="override model and load height")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--eval-keyframes", type=int, default=None)
    p.add_argument("--eval-video-dir", type=str, default=None,
                   help="write per-clip grid videos during eval")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler trace of steps 3-8")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def config_of(args: argparse.Namespace) -> RendererConfig:
    """The renderer config of ``--config`` with the command line's
    overrides."""
    cfg = load_renderer_config(args.config) if args.config \
        else RendererConfig()
    if args.batch_size:
        cfg = dataclasses.replace(cfg, batch_size=args.batch_size)
    if args.height or args.width:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data,
            model_height=args.height or cfg.data.model_height,
            load_height=args.height or cfg.data.load_height,
            model_width=args.width or cfg.data.model_width,
            load_width=args.width or cfg.data.load_width))
    return cfg


def train(args: argparse.Namespace, reader=None, test_reader=None) -> dict:
    """The training run of ``args`` over ``reader`` (train windows:
    ``__len__``, ``batches(rng, batch_size)``, ``set_max_frames``) and
    ``test_reader`` (what ``evaluate_h5`` reads), or over synthetic
    windows when ``reader`` is None.  Returns the final train state and,
    per epoch run, its steps, seconds, seconds spent waiting for the
    next batch, the window length, and the evaluation's seconds."""
    device = cli_device("train_renderer", args.device)
    cfg = config_of(args)
    seed = args.seed if args.seed is not None else cfg.seed
    epochs = args.epochs or cfg.optim.nr_epochs
    d = cfg.data

    os.makedirs(args.out_dir, exist_ok=True)
    logger = MetricLogger(args.out_dir)
    snapshot_source(args.out_dir, os.path.dirname(renderloom_torch.__file__))
    steps_per_epoch = (max(len(reader) // cfg.batch_size, 1)
                       if reader is not None else args.steps_per_epoch)

    # the synthetic smoke never claims the reference objective
    perceptual = make_perceptual(
        cfg, device, seed,
        require_pretrained=not (args.allow_random_vgg or args.synthetic))
    state = create_gan_state(cfg, device, seed, steps_per_epoch)
    n_g = sum(x.numel() for x in state.gen.parameters())
    n_d = sum(x.numel() for x in state.dis.parameters())
    print(f"device: {device}  generator params: {n_g:,}  "
          f"discriminator params: {n_d:,}")
    ckpt_path = os.path.join(args.out_dir, "checkpoint.pt")
    if args.resume and os.path.exists(ckpt_path):
        load_checkpoint(ckpt_path, state)
        print(f"resumed at step {state.step}")
    step_fn = make_gan_train_step(cfg, perceptual, data_cfg=d)

    rng = np.random.default_rng(seed)
    start_epoch = state.step // steps_per_epoch
    max_frames = d.max_frames
    history = []
    for epoch in range(start_epoch, epochs):
        # curriculum: the window grows by one frame every update_frame_step
        # epochs
        want_frames = d.max_frames + epoch // d.update_frame_step
        if reader is not None and want_frames != max_frames:
            max_frames = want_frames
            reader.set_max_frames(max_frames)
            steps_per_epoch = max(len(reader) // cfg.batch_size, 1)
            print(f"curriculum: window -> {max_frames} frames")

        tic = time.perf_counter()
        batches = (prefetch(reader.batches(rng, cfg.batch_size), depth=2)
                   if reader is not None else
                   synthetic_batches(rng, steps_per_epoch, cfg.batch_size,
                                     max_frames, d.load_height,
                                     d.load_width))
        metrics = {}
        n_steps = 0
        wait = 0.0
        profiling = contextlib.ExitStack()
        try:
            while True:
                t0 = time.perf_counter()
                raw = next(batches, None)
                wait += time.perf_counter() - t0
                if raw is None:
                    break
                if args.profile_dir and epoch == start_epoch:
                    if n_steps == 2:           # past the first steps
                        profiling.enter_context(trace(args.profile_dir))
                    elif n_steps == 8:
                        profiling.close()
                batch = {k: torch.from_numpy(np.asarray(
                    raw[k], np.float32 if k == "poses" else None)).to(device)
                    for k in ("images", "dain", "poses")}
                metrics = step_fn(state, batch)
                n_steps += 1
                if n_steps % TRAIN_LOG_EVERY == 0:
                    logger.log(state.step,
                               {k: float(v) for k, v in metrics.items()},
                               prefix="train/")
        finally:
            profiling.close()
            if reader is not None:
                batches.close()
        wall = time.perf_counter() - tic
        record = {"epoch": epoch, "steps": n_steps, "seconds": wall,
                  "wait_seconds": wait, "frames": max_frames}
        if metrics:
            scalars = {k: float(v) for k, v in metrics.items()}
            scalars["steps_per_sec"] = n_steps / wall
            logger.console(state.step, scalars, header=f"epoch {epoch} ")

        if test_reader and (epoch + 1) % 4 == 0:
            tic = time.perf_counter()
            results = evaluate_h5(*flax_trees(state.gen), cfg, test_reader,
                                  max_keyframes=args.eval_keyframes,
                                  perceptual=perceptual,
                                  video_dir=args.eval_video_dir,
                                  device=device)
            record["eval_seconds"] = time.perf_counter() - tic
            logger.log(state.step, results, prefix="eval/")
            logger.console(state.step, results, header="eval ")

        if (epoch + 1) % 4 == 0 or epoch == epochs - 1:
            save_checkpoint(ckpt_path, state)
            print(f"checkpoint: {ckpt_path}")
        history.append(record)
    logger.close()
    return {"state": state, "epochs": history}


def main(argv=None) -> Optional[dict]:
    args = parse_args(argv)
    cli_device("train_renderer", args.device)
    reader = test_reader = None
    if not args.synthetic:
        d = config_of(args).data
        h5_path = args.h5 or d.h5_file
        reader = HsmReader(h5_path, d.train_video_list or [], "train",
                           d.max_frames)
        test_reader = HsmReader(h5_path, d.test_video_list, "test",
                                d.max_frames)
    return train(args, reader, test_reader)


if __name__ == "__main__":
    main()
