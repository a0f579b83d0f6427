"""Train the 2-D pose head on (image, pose) pairs.

Port of the JAX package's ``renderloom/cli/train_pose.py``: single
frames and their poses from a HumanSloMo h5 (``--h5``: ``max_frames=1``
windows of :class:`HsmReader`, the poses scaled to ``--height`` ×
``--width``, read on a prefetch thread two batches ahead) or procedural
blob images (``--synthetic``), resized to ``--height`` × ``--width``
(``ops.image.resize_bilinear``), train the head (``train.pose``), with
``--occlude-rate`` setting the random-erase augmentation's rate.  Every
epoch follows the JAX loop: ``train/`` metrics to
``<out-dir>/metrics.jsonl`` every 20 steps and a console line with
``steps_per_sec``; a ``torch.save`` checkpoint (``model``, ``opt``,
``step``, ``seed``; ``core.checkpoint.read_params`` reads its model)
every 5 epochs and after the last; ``--resume`` continues from it.
After training, ``python -m renderloom_torch.cli.extract_pose`` writes
openpose JSONs with it.

The epoch loop is :func:`train`, which takes the reader; :func:`main`
builds it from ``--h5``.  It runs on the CUDA device unless ``--device
cpu`` is given, and without a CUDA device it refuses to run.

Usage:
  python -m renderloom_torch.cli.train_pose --h5 HumanSlomo.h5 \\
      --out-dir runs/pose_torch --height 256 --width 384
  python -m renderloom_torch.cli.train_pose --synthetic --epochs 1
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

import renderloom_torch
from renderloom_torch.cli import cli_device
from renderloom_torch.cli.train_flow import train_epochs, video_list
from renderloom_torch.core.config import PoseNetConfig, load_pose_config
from renderloom_torch.core.logging import MetricLogger, snapshot_source
from renderloom_torch.data.hsm import HsmReader
from renderloom_torch.data.prefetch import prefetch
from renderloom_torch.models.posenet import N_JOINTS
from renderloom_torch.ops.image import resize_bilinear
from renderloom_torch.train.pose import (create_pose_state,
                                         make_pose_train_step)

TRAIN_LOG_EVERY = 20     # steps between ``train/`` records, as in JAX


def synthetic_batches(rng: np.random.Generator, n: int, batch: int,
                      h: int, w: int):
    """Procedural images, as the JAX CLI draws them: a gaussian blob per
    joint on a ring around a random centre, joint j in channel j mod 3,
    confidence 0.9."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(n):
        imgs = np.zeros((batch, h, w, 3), np.float32)
        poses = np.zeros((batch, N_JOINTS, 3), np.float32)
        for b in range(batch):
            base = rng.uniform((w * .25, h * .25), (w * .75, h * .75))
            for j in range(N_JOINTS):
                cx = np.clip(base[0] + w * .15
                             * np.cos(2 * np.pi * j / N_JOINTS), 4, w - 4)
                cy = np.clip(base[1] + h * .15
                             * np.sin(2 * np.pi * j / N_JOINTS), 4, h - 4)
                imgs[b, :, :, j % 3] += np.exp(
                    -((xx - cx) ** 2 + (yy - cy) ** 2) / 30.0)
                poses[b, j] = (cx, cy, 0.9)
        yield {"images": np.clip(imgs, 0, 1), "poses": poses}


def hsm_frame_batches(reader: HsmReader, rng: np.random.Generator,
                      batch: int, h: int, w: int):
    """Single frames and their poses, scaled to (h, w), from the
    ``max_frames=1`` windows of ``reader``."""
    for win in reader.batches(rng, batch):
        imgs = win["images"][:, 0]              # (B, H0, W0, 3) uint8
        poses = win["poses"][:, 0].astype(np.float32)
        poses[..., 0] *= w / imgs.shape[2]
        poses[..., 1] *= h / imgs.shape[1]
        yield {"images": imgs, "poses": poses}


def save_checkpoint(path: str, state) -> str:
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "opt": state.opt.state_dict(), "seed": state.seed}, path)
    return path


def load_checkpoint(path: str, state) -> None:
    ckpt = torch.load(path, map_location=state.opt.flat.device)
    state.model.load_state_dict(ckpt["model"])
    state.opt.load_state_dict(ckpt["opt"])
    state.step, state.seed = ckpt["step"], ckpt["seed"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="renderloom_torch pose training")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--h5", type=str, default=None)
    p.add_argument("--out-dir", type=str, required=True)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=384)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--steps-per-epoch", type=int, default=50,
                   help="synthetic mode only")
    p.add_argument("--occlude-rate", type=float, default=None,
                   help="random-erase occlusion augmentation "
                        "probability (see PoseNetConfig.occlude_rate)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def config_of(args: argparse.Namespace) -> PoseNetConfig:
    cfg = load_pose_config(args.config) if args.config else PoseNetConfig()
    if args.occlude_rate is not None:
        cfg = dataclasses.replace(cfg, occlude_rate=args.occlude_rate)
    return cfg


def train(args: argparse.Namespace, reader=None) -> dict:
    """The training run of ``args`` over ``reader`` (``__len__`` and
    ``batches`` of 1-frame windows), or over synthetic blob images when
    ``reader`` is None.  Returns the final train state and per epoch its
    steps, seconds and seconds spent waiting for the next batch."""
    device = cli_device("train_pose", args.device)
    cfg = config_of(args)
    epochs = args.epochs or cfg.nr_epochs
    H, W = args.height, args.width
    os.makedirs(args.out_dir, exist_ok=True)
    logger = MetricLogger(args.out_dir)
    snapshot_source(args.out_dir, os.path.dirname(renderloom_torch.__file__))
    steps_per_epoch = (max(len(reader) // cfg.batch_size, 1)
                       if reader is not None else args.steps_per_epoch)

    state = create_pose_state(cfg, device, args.seed)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"device: {device}  PoseNet parameters: {n_params:,}")
    ckpt_path = os.path.join(args.out_dir, "checkpoint.pt")
    if args.resume and os.path.exists(ckpt_path):
        load_checkpoint(ckpt_path, state)
        print(f"resumed at step {state.step}")
    step_fn = make_pose_train_step(cfg)

    rng = np.random.default_rng(args.seed)

    def batches():
        if reader is None:
            return synthetic_batches(rng, steps_per_epoch, cfg.batch_size,
                                     H, W)
        return prefetch(hsm_frame_batches(reader, rng, cfg.batch_size, H, W),
                        depth=2)

    def step(raw):
        imgs = torch.from_numpy(raw["images"]).to(device)
        imgs = imgs.float() / 255.0 if imgs.dtype == torch.uint8 \
            else imgs.float()
        return step_fn(state, {
            "images": resize_bilinear(imgs, H, W),
            "poses": torch.from_numpy(raw["poses"]).to(device)})

    history = train_epochs(state, epochs, steps_per_epoch, batches, step,
                           logger, lambda: save_checkpoint(ckpt_path, state),
                           TRAIN_LOG_EVERY)
    logger.close()
    return {"state": state, "epochs": history}


def main(argv=None) -> dict:
    args = parse_args(argv)
    cli_device("train_pose", args.device)
    reader = None
    if not args.synthetic:
        if not args.h5:
            raise SystemExit("--h5 required without --synthetic")
        reader = HsmReader(args.h5, video_list(args.h5), phase="train",
                           max_frames=1)
    return train(args, reader)


if __name__ == "__main__":
    main()
