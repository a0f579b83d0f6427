"""Train the pose-guided neural renderer (GAN) with the PyTorch port.

Port of the JAX package's ``renderloom/cli/train_renderer.py`` in its
``--synthetic`` mode: random raw windows (uint8 frames and DAIN
backgrounds at load size, poses inside the frame) go through the
train-mode preparation and the per-frame D/G step on the device;
metrics print every epoch and go to ``<out-dir>/metrics.jsonl``, and a
``torch.save`` checkpoint (both networks with their power-iteration
state, both optimizers, the step and the draw generator) is written
every 4 epochs and after the last.  The per-epoch learning-rate policy
and the frame-count curriculum are those of the JAX CLI.  The VGG19
perceptual loss runs on fixed random weights (no weights are loaded
yet).  Reading HumanSloMo h5 files, prefetch, the periodic evaluation
and profiling are not ported yet.

It runs on the CUDA device unless ``--device cpu`` is given, and
without a CUDA device it refuses to run.

Usage:
  python -m renderloom_torch.cli.train_renderer --synthetic \\
      --config configs/hsm.yaml --out-dir runs/renderer_torch \\
      --epochs 1 --steps-per-epoch 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from renderloom_torch.cli import cli_device
from renderloom_torch.core.config import RendererConfig, load_renderer_config
from renderloom_torch.train.gan import (create_gan_state, make_gan_train_step,
                                        make_perceptual)


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
    state.rng.set_state(ckpt["rng"])
    state.step = ckpt["step"]


def main(argv=None):
    p = argparse.ArgumentParser(description="renderloom_torch renderer "
                                            "training")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--out-dir", type=str, default="runs/renderer_torch")
    p.add_argument("--synthetic", action="store_true",
                   help="train on random windows (the only data source "
                        "ported so far)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--steps-per-epoch", type=int, default=20)
    p.add_argument("--height", type=int, default=None,
                   help="override model and load height")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    if not args.synthetic:
        raise SystemExit("train_renderer: only --synthetic is ported; the "
                         "HumanSloMo h5 reader is not")
    device = cli_device("train_renderer", args.device)

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
    seed = args.seed if args.seed is not None else cfg.seed
    epochs = args.epochs or cfg.optim.nr_epochs
    d = cfg.data
    steps_per_epoch = args.steps_per_epoch

    os.makedirs(args.out_dir, exist_ok=True)
    state = create_gan_state(cfg, device, seed, steps_per_epoch)
    n_g = sum(x.numel() for x in state.gen.parameters())
    n_d = sum(x.numel() for x in state.dis.parameters())
    print(f"device: {device}  generator params: {n_g:,}  "
          f"discriminator params: {n_d:,}")
    ckpt_path = os.path.join(args.out_dir, "checkpoint.pt")
    if args.resume and os.path.exists(ckpt_path):
        load_checkpoint(ckpt_path, state)
        print(f"resumed at step {state.step}")
    step_fn = make_gan_train_step(cfg, make_perceptual(cfg, device, seed),
                                  data_cfg=d)

    rng = np.random.default_rng(seed)
    start_epoch = state.step // steps_per_epoch
    log = open(os.path.join(args.out_dir, "metrics.jsonl"), "a")
    try:
        for epoch in range(start_epoch, epochs):
            # curriculum: the window grows by one frame every
            # update_frame_step epochs
            frames = d.max_frames + epoch // d.update_frame_step
            tic = time.perf_counter()
            metrics = {}
            for raw in synthetic_batches(rng, steps_per_epoch,
                                         cfg.batch_size, frames,
                                         d.load_height, d.load_width):
                batch = {k: torch.from_numpy(v).to(device)
                         for k, v in raw.items()}
                metrics = step_fn(state, batch)
            scalars = {k: float(v) for k, v in metrics.items()}
            scalars["steps_per_sec"] = (steps_per_epoch
                                        / (time.perf_counter() - tic))
            print(f"epoch {epoch} step {state.step} " + " ".join(
                f"{k}={v:.4g}" for k, v in sorted(scalars.items())))
            log.write(json.dumps({"step": state.step, **scalars}) + "\n")
            log.flush()
            if (epoch + 1) % 4 == 0 or epoch == epochs - 1:
                save_checkpoint(ckpt_path, state)
                print(f"checkpoint: {ckpt_path}")
    finally:
        log.close()


if __name__ == "__main__":
    main()
