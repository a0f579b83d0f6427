"""Train the motion transformer with the PyTorch port.

Port of the JAX package's ``renderloom/cli/train_motion.py``: raw
windows from the AMASS joints h5 (``--h5``; :class:`AmassReader`, the
train split, read on a prefetch thread two batches ahead) or procedural
sinusoid motion (``--synthetic``) go through the motion train step
(synthesis on the device, dropout, the clipped AMSGrad update).  Every
epoch follows the JAX loop: ``train/`` metrics to
``<out-dir>/metrics.jsonl`` every 20 steps and a console line with
``steps_per_sec``; every ``eval_step`` epochs the evaluation over the
test split (:class:`MotionEvaluator`, ``--eval-limit`` samples at most),
logged under ``eval/``; a ``torch.save`` checkpoint (``model``,
``opt``, ``step``, ``rng``, ``dropout_rng``; ``core.checkpoint.
read_params`` reads its model) every ``save_step`` epochs and after the
last; with ``--profile-dir``, a ``torch.profiler`` trace of steps 3–8.
With ``--h5`` the normalization statistics come from the cached files
of ``data_root`` or are computed from the train split and cached there.

The epoch loop is :func:`train`, which takes the readers; :func:`main`
builds them from ``--h5``.  It runs on the CUDA device unless
``--device cpu`` is given, and without a CUDA device it refuses to run.

Under ``torchrun`` it trains data-parallel (``renderloom_torch.
parallel``; NCCL on the card, gloo with ``--device cpu``): the config's
``batch_size`` is the global batch, split evenly over the ranks; each
rank reads its strided share of the samples (``process_shard``; every
rank draws the epoch's order from a generator seeded by (seed, epoch))
and takes ``steps_per_epoch`` steps, the synthetic batches are drawn
whole and sliced, and rank 0 alone writes the metrics, the evaluation
and the checkpoints.  Without ``torchrun`` it runs at world size 1.

Usage:
  python -m renderloom_torch.cli.train_motion --config configs/motion.yaml \\
      --h5 AMASS_3D_joints.h5 --out-dir runs/motion_torch
  python -m renderloom_torch.cli.train_motion --synthetic --epochs 1
  torchrun --standalone --nproc_per_node=4 -m \\
      renderloom_torch.cli.train_motion --h5 AMASS_3D_joints.h5
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import os
import time
from typing import Optional

import numpy as np
import torch

import renderloom_torch
from renderloom_torch.cli import cli_device
from renderloom_torch.core.config import MotionConfig, load_motion_config
from renderloom_torch.core.logging import (MetricLogger, NullLogger,
                                           snapshot_source)
from renderloom_torch.data.amass import AmassReader, load_or_compute_stats
from renderloom_torch.data.prefetch import prefetch
from renderloom_torch.eval.motion_eval import MotionEvaluator
from renderloom_torch.parallel import mesh
from renderloom_torch.train.motion import (create_motion_state,
                                           make_train_step)
from renderloom_torch.utils.profiling import trace

TRAIN_LOG_EVERY = 20     # steps between ``train/`` records, as in JAX


def synthetic_batches(rng: np.random.Generator, n_batches: int,
                      batch_size: int, seq_len: int):
    """Procedural stand-in for AMASS: smooth random sinusoid joint
    paths, as the JAX CLI draws them."""
    for _ in range(n_batches):
        t = np.linspace(0, 4 * np.pi, seq_len, dtype=np.float32)
        freq = rng.uniform(0.5, 2.0, (batch_size, 52, 3, 1))
        phase = rng.uniform(0, 2 * np.pi, (batch_size, 52, 3, 1))
        amp = rng.uniform(0.1, 0.6, (batch_size, 52, 3, 1))
        motion = amp * np.sin(freq * t[None, None, None, :] + phase)
        yield {"motion3d": motion.astype(np.float32),
               "pad_mask": np.zeros((batch_size, seq_len), dtype=bool)}


def save_checkpoint(path: str, state) -> None:
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "opt": state.opt.state_dict(),
                "rng": state.rng.get_state(),
                "dropout_rng": (None if state.dropout_rng is None
                                else state.dropout_rng.get_state())}, path)


def load_checkpoint(path: str, state) -> None:
    ckpt = torch.load(path, map_location=state.opt.flat.device)
    state.model.load_state_dict(ckpt["model"])
    state.opt.load_state_dict(ckpt["opt"])
    state.rng.set_state(ckpt["rng"].cpu())
    # a checkpoint imported from the reference (cli/import_checkpoint)
    # has no dropout generator: the fresh one, seeded from the config
    if ckpt["dropout_rng"] is not None:
        state.dropout_rng.set_state(ckpt["dropout_rng"].cpu())
    state.step = ckpt["step"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="renderloom_torch motion "
                                            "training")
    p.add_argument("--config", type=str, default=None,
                   help="yaml config (reference layout accepted)")
    p.add_argument("--out-dir", type=str, default="runs/motion_torch")
    p.add_argument("--h5", type=str, default=None,
                   help="AMASS_3D_joints.h5 path (overrides the config)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="train on procedural motion (no h5 needed)")
    p.add_argument("--steps-per-epoch", type=int, default=50,
                   help="synthetic mode only")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler trace of steps 3-8")
    p.add_argument("--eval-limit", type=int, default=None,
                   help="cap eval samples for quick runs")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def config_of(args: argparse.Namespace) -> MotionConfig:
    cfg = load_motion_config(args.config) if args.config else MotionConfig()
    if args.batch_size:
        cfg = dataclasses.replace(cfg, batch_size=args.batch_size)
    return cfg


def train(args: argparse.Namespace, reader=None, test_reader=None) -> dict:
    """The training run of ``args`` over ``reader`` (the train split:
    ``__len__``, ``samples``, ``read_motion``, ``batches``) with
    ``test_reader`` evaluated, or over synthetic motion when ``reader``
    is None.  Returns the final train state, the statistics, and per
    epoch run its steps, seconds, seconds spent waiting for the next
    batch and the evaluation's seconds."""
    with mesh.torchrun(cli_device("train_motion", args.device)) as device:
        return _train(args, device, reader, test_reader)


def _train(args, device, reader, test_reader) -> dict:
    cfg = config_of(args)
    seed = args.seed if args.seed is not None else cfg.seed
    epochs = args.epochs or cfg.optim.nr_epochs
    d = cfg.dataset
    rank, size = mesh.world()
    rank_batch = mesh.local_batch(cfg.batch_size)
    if mesh.backend():
        print(f"world: {size} backend: {mesh.backend()}")

    os.makedirs(args.out_dir, exist_ok=True)
    logger = MetricLogger(args.out_dir) if rank == 0 else NullLogger()
    if rank == 0:
        snapshot_source(args.out_dir,
                        os.path.dirname(renderloom_torch.__file__))

    evaluator = None
    if reader is not None:
        # rank 0 computes and caches the statistics and views; the other
        # ranks read its files
        with mesh.rank_zero_first():
            mean, std = load_or_compute_stats(reader, d)
            if test_reader is not None:
                evaluator = MotionEvaluator(
                    cfg, test_reader, mean, std,
                    os.path.join(d.data_root, "evaluation_view.npy"))
        steps_per_epoch = max(len(reader) // cfg.batch_size, 1)
    else:
        mean = np.zeros((19, 2), np.float32)
        std = np.ones((19, 2), np.float32)
        steps_per_epoch = args.steps_per_epoch

    state = create_motion_state(cfg, device, seed, steps_per_epoch)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"device: {device}  motion transformer parameters: {n_params:,}")
    ckpt_path = os.path.join(args.out_dir, "checkpoint.pt")
    if args.resume and os.path.exists(ckpt_path):
        load_checkpoint(ckpt_path, state)
        print(f"resumed at step {state.step}")
    step_fn = make_train_step(cfg, mean, std)

    rng = np.random.default_rng(seed)
    start_epoch = state.step // steps_per_epoch
    history = []
    for epoch in range(start_epoch, epochs):
        tic = time.perf_counter()
        if size > 1:        # the ranks agree on the epoch's order
            rng = np.random.default_rng([seed, epoch])
        source = (prefetch(reader.batches(rng, rank_batch, d.max_seq_length,
                                          d.train_sample_rate), depth=2)
                  if reader is not None else
                  map(mesh.shard_batch,
                      synthetic_batches(rng, steps_per_epoch,
                                        cfg.batch_size, d.max_seq_length)))
        # every rank takes the same number of steps
        batches = (itertools.islice(source, steps_per_epoch) if size > 1
                   else source)
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
                metrics = step_fn(state, {
                    k: torch.from_numpy(raw[k]).to(device)
                    for k in ("motion3d", "pad_mask")})
                n_steps += 1
                if n_steps % TRAIN_LOG_EVERY == 0:
                    logger.log(state.step,
                               {k: float(v) for k, v in metrics.items()},
                               prefix="train/")
        finally:
            profiling.close()
            if reader is not None:
                source.close()
        wall = time.perf_counter() - tic
        record = {"epoch": epoch, "steps": n_steps, "seconds": wall,
                  "wait_seconds": wait}
        if metrics:
            scalars = {k: float(v) for k, v in metrics.items()}
            scalars["steps_per_sec"] = n_steps / wall
            logger.console(state.step, scalars, header=f"epoch {epoch} ")

        if evaluator and rank == 0 and (epoch + 1) % cfg.eval_step == 0:
            tic = time.perf_counter()
            results = evaluator.evaluate(state.model, limit=args.eval_limit)
            record["eval_seconds"] = time.perf_counter() - tic
            logger.log(state.step, results, prefix="eval/")
            logger.console(state.step, results, header="eval ")

        if rank == 0 and ((epoch + 1) % cfg.save_step == 0
                          or epoch == epochs - 1):
            save_checkpoint(ckpt_path, state)
            print(f"checkpoint: {ckpt_path}")
        history.append(record)
    logger.close()
    return {"state": state, "mean": mean, "std": std, "epochs": history}


def main(argv=None) -> Optional[dict]:
    args = parse_args(argv)
    cli_device("train_motion", args.device)
    reader = test_reader = None
    if not args.synthetic:
        d = config_of(args).dataset
        h5_path = args.h5 or d.h5_file
        reader = AmassReader(h5_path, d.train_split)
        test_reader = AmassReader(h5_path, d.test_split)
    return train(args, reader, test_reader)


if __name__ == "__main__":
    main()
