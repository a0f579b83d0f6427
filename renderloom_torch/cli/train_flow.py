"""Train the learned flow interpolator (the trainable DAIN replacement).

Port of the JAX package's ``renderloom/cli/train_flow.py``: triplets of
consecutive frames from a HumanSloMo h5 (``--h5``: every sliding
window of 3 ``train_images`` frames, :class:`HsmReader` with
``max_frames=3``, read on a prefetch thread two batches ahead) or
procedurally translated patterns (``--synthetic``), resized to
``--height`` × ``--width`` (the antialiased bilinear resize of
``jax.image.resize``, ``ops.image.resize_bilinear``), train the UNet
with middle-frame supervision (``train.flow``).  Every epoch follows
the JAX loop: ``train/`` metrics to ``<out-dir>/metrics.jsonl`` every
20 steps and a console line with ``steps_per_sec``; a ``torch.save``
checkpoint (``model``, ``opt``, ``step``; ``core.checkpoint.
read_params`` reads its model) every 5 epochs and after the last;
``--resume`` continues from it.

The epoch loop is :func:`train`, which takes the reader; :func:`main`
builds it from ``--h5``.  It runs on the CUDA device unless ``--device
cpu`` is given, and without a CUDA device it refuses to run.

Usage:
  python -m renderloom_torch.cli.train_flow --h5 HumanSlomo.h5 \\
      --out-dir runs/flow_torch --height 256 --width 384
  python -m renderloom_torch.cli.train_flow --synthetic --epochs 1
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

import renderloom_torch
from renderloom_torch.cli import cli_device
from renderloom_torch.core.config import FlowConfig, load_flow_config
from renderloom_torch.core.logging import MetricLogger, snapshot_source
from renderloom_torch.data.hsm import HsmReader
from renderloom_torch.data.prefetch import prefetch
from renderloom_torch.ops.image import resize_bilinear
from renderloom_torch.train.flow import (create_flow_state,
                                         make_flow_train_step)

TRAIN_LOG_EVERY = 20     # steps between ``train/`` records, as in JAX
SAVE_EVERY = 5           # epochs between checkpoints, as in JAX


def synthetic_triplets(rng: np.random.Generator, n: int, batch: int,
                       h: int, w: int):
    """Smoothly translating random patterns, as the JAX CLI draws them:
    frame 1 is the exact midpoint of the motion, so the flow is
    learnable and the supervision clean."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(n):
        out = np.zeros((batch, 3, h, w, 3), np.float32)
        for b in range(batch):
            phase = rng.uniform(0, 6.28, (3,))
            freq = rng.uniform(0.05, 0.2, (3,))
            dx, dy = rng.uniform(-4, 4, 2)
            for i, t in enumerate((0.0, 0.5, 1.0)):
                for c in range(3):
                    out[b, i, :, :, c] = 0.5 + 0.5 * np.sin(
                        freq[c] * (xx - dx * t)
                        + freq[c] * 0.7 * (yy - dy * t) + phase[c])
        yield {"frames": out}


def resize_frames(frames: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, T, H0, W0, 3) uint8 or float frames → float32 in [0, 1] at
    (h, w)."""
    B, T, H0, W0, C = frames.shape
    x = frames.float() / 255.0 if frames.dtype == torch.uint8 \
        else frames.float()
    return resize_bilinear(x.reshape(B * T, H0, W0, C), h, w).reshape(
        B, T, h, w, C)


def save_checkpoint(path: str, state) -> str:
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "opt": state.opt.state_dict()}, path)
    return path


def load_checkpoint(path: str, state) -> None:
    ckpt = torch.load(path, map_location=state.opt.flat.device)
    state.model.load_state_dict(ckpt["model"])
    state.opt.load_state_dict(ckpt["opt"])
    state.step = ckpt["step"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="renderloom_torch flow training")
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
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def config_of(args: argparse.Namespace) -> FlowConfig:
    return load_flow_config(args.config) if args.config else FlowConfig()


def train(args: argparse.Namespace, reader=None) -> dict:
    """The training run of ``args`` over ``reader`` (``__len__`` and
    ``batches`` of 3-frame windows), or over synthetic triplets when
    ``reader`` is None.  Returns the final train state and per epoch its
    steps, seconds and seconds spent waiting for the next batch."""
    device = cli_device("train_flow", args.device)
    cfg = config_of(args)
    epochs = args.epochs or cfg.nr_epochs
    H, W = args.height, args.width
    if H % 2 ** cfg.levels or W % 2 ** cfg.levels:
        raise ValueError(f"height and width must be divisible by "
                         f"{2 ** cfg.levels}")
    os.makedirs(args.out_dir, exist_ok=True)
    logger = MetricLogger(args.out_dir)
    snapshot_source(args.out_dir, os.path.dirname(renderloom_torch.__file__))
    steps_per_epoch = (max(len(reader) // cfg.batch_size, 1)
                       if reader is not None else args.steps_per_epoch)

    state = create_flow_state(cfg, device, args.seed)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"device: {device}  flow UNet parameters: {n_params:,}")
    ckpt_path = os.path.join(args.out_dir, "checkpoint.pt")
    if args.resume and os.path.exists(ckpt_path):
        load_checkpoint(ckpt_path, state)
        print(f"resumed at step {state.step}")
    step_fn = make_flow_train_step(cfg)

    rng = np.random.default_rng(args.seed)

    def batches():
        if reader is None:
            return synthetic_triplets(rng, steps_per_epoch, cfg.batch_size,
                                      H, W)
        return prefetch(({"frames": b["images"]} for b in
                         reader.batches(rng, cfg.batch_size)), depth=2)

    history = train_epochs(
        state, epochs, steps_per_epoch, batches,
        lambda raw: step_fn(state, {"frames": resize_frames(
            torch.from_numpy(raw["frames"]).to(device), H, W)}),
        logger, lambda: save_checkpoint(ckpt_path, state), TRAIN_LOG_EVERY)
    logger.close()
    return {"state": state, "epochs": history}


def train_epochs(state, epochs: int, steps_per_epoch: int, batches, step,
                 logger, save, log_every: int) -> list:
    """The JAX flow and pose CLIs' epoch loop, from the epoch the state's
    step count reached: ``step(raw)`` over the iterator ``batches()``
    gives (closed after the epoch where it can be), ``train/`` records
    every ``log_every`` steps, a console line per epoch with
    ``steps_per_sec``, ``save()`` (which returns the checkpoint's path)
    every SAVE_EVERY epochs and after the last.  Returns per epoch its
    steps, seconds and seconds spent waiting for the next batch."""
    history = []
    for epoch in range(state.step // steps_per_epoch, epochs):
        tic = time.perf_counter()
        source = batches()
        metrics, n_steps, wait = {}, 0, 0.0
        try:
            while True:
                t0 = time.perf_counter()
                raw = next(source, None)
                wait += time.perf_counter() - t0
                if raw is None:
                    break
                metrics = step(raw)
                n_steps += 1
                if n_steps % log_every == 0:
                    logger.log(state.step,
                               {k: float(v) for k, v in metrics.items()},
                               prefix="train/")
        finally:
            if hasattr(source, "close"):
                source.close()
        wall = time.perf_counter() - tic
        if metrics:
            scalars = {k: float(v) for k, v in metrics.items()}
            scalars["steps_per_sec"] = n_steps / wall
            logger.console(state.step, scalars, header=f"epoch {epoch} ")
        if (epoch + 1) % SAVE_EVERY == 0 or epoch == epochs - 1:
            print(f"checkpoint: {save()}")
        history.append({"epoch": epoch, "steps": n_steps, "seconds": wall,
                        "wait_seconds": wait})
    return history


def video_list(h5_path: str):
    """The clips of the h5 that have train frames."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        return [k for k in f.keys() if "train_images" in f[k]]


def main(argv=None) -> dict:
    args = parse_args(argv)
    cli_device("train_flow", args.device)
    reader = None
    if not args.synthetic:
        if not args.h5:
            raise SystemExit("--h5 required without --synthetic")
        # every sliding window of 3 consecutive frames is a triplet
        reader = HsmReader(args.h5, video_list(args.h5), phase="train",
                           max_frames=3)
    return train(args, reader)


if __name__ == "__main__":
    main()
