"""Upsample openpose pose folders with a trained motion transformer.

Port of the JAX package's ``renderloom/cli/infer_motion.py``, the
contract of the reference's ``Human_Motion_Modelling/inference.py:83-93``:
``--pose-dir`` holds one subfolder of openpose JSONs per clip (or is one
clip itself); ``Predict_motion/<clip>`` and ``Linear_motion/<clip>`` are
written under ``--save-dir``.  ``--ckpt`` is an ``.npz`` of flax trees or
a ``torch.save`` of the model's ``state_dict``
(:mod:`renderloom_torch.core.checkpoint`); an orbax checkpoint needs JAX.
The normalization statistics are the cached files of the config's
``dataset`` section (zeros/ones, with a warning, where there are none).

It runs on the CUDA device unless ``--device cpu`` is given, and
without a CUDA device it refuses to run.

Usage:
  python -m renderloom_torch.cli.infer_motion --ckpt motion.npz \\
      --pose-dir example/poses --save-dir example/out --upsample-rate 8
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from renderloom_torch.cli import cli_device
from renderloom_torch.core.checkpoint import ORBAX_HELP, read_params
from renderloom_torch.core.config import (MotionConfig, MotionDatasetConfig,
                                          load_motion_config)
from renderloom_torch.data.amass import load_or_compute_stats
from renderloom_torch.eval.motion_infer import make_interpolator
from renderloom_torch.train.gan import set_float32_precision

CKPT_HELP = ("motion weights: an .npz of flax trees (keys params/...) or a "
             "torch.save of the model's state_dict; " + ORBAX_HELP)


def load_stats(cfg: MotionDatasetConfig):
    """(mean, std) from the cached statistics, else zeros/ones with a
    warning."""
    try:
        return load_or_compute_stats(None, cfg)
    except FileNotFoundError:
        print("WARNING: no normalization stats found; using zeros/ones "
              "(results will be wrong unless the model was trained so)")
        return np.zeros((19, 2), np.float32), np.ones((19, 2), np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(description="renderloom_torch motion "
                                            "inference")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--ckpt", type=str, required=True, help=CKPT_HELP)
    p.add_argument("--pose-dir", type=str, required=True,
                   help="input low-FPS pose path (subfolders of JSONs)")
    p.add_argument("--save-dir", type=str, required=True)
    p.add_argument("--upsample-rate", type=int, default=8,
                   help="insert rate-1 frames between keyframes (pow 2)")
    p.add_argument("--seed", type=int, default=123,
                   help="accepted as in the JAX CLI; nothing is drawn, "
                        "every weight comes from --ckpt")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    device = cli_device("infer_motion", args.device)
    set_float32_precision()
    cfg = load_motion_config(args.config) if args.config else MotionConfig()
    params = read_params(args.ckpt)
    print(f"loaded motion weights from {args.ckpt}")
    mean, std = load_stats(cfg.dataset)
    interp = make_interpolator(cfg, params, mean, std, device)

    clips = sorted(
        f for f in os.listdir(args.pose_dir)
        if os.path.isdir(os.path.join(args.pose_dir, f)))
    if not clips:
        clips = [""]          # pose-dir itself is a single clip
    for clip in clips:
        pose_path = os.path.join(args.pose_dir, clip)
        pred_dir = os.path.join(args.save_dir, "Predict_motion", clip)
        lin_dir = os.path.join(args.save_dir, "Linear_motion", clip)
        interp.interpolate_openpose(pose_path, args.upsample_rate,
                                    pred_dir, lin_dir)
        print(f"clip {clip or '.'}: wrote {pred_dir} and {lin_dir}")


if __name__ == "__main__":
    main()
