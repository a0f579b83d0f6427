"""Render high-FPS frames from keyframes + upsampled poses.

Port of the JAX package's ``renderloom/cli/infer_renderer.py`` (the
reference's ``Pose_Guided_Neural_Rendering/inference.py:11-47``):
``--input-dir`` holds ``inputs/`` (low-FPS keyframes), ``DAIN/``
(per-frame warped backgrounds) and ``Predict_motion/`` (upsampled
openpose JSONs from the motion stage); fused frames are written to
``Generated_frames/``.  If ``DAIN/`` is missing, the backgrounds are
synthesized (:func:`synthesize_backgrounds`) with pyramidal
Lucas-Kanade flow or, with ``--flow-ckpt``, the learned flow UNet
(:func:`load_flow_interp`; a ``train_flow`` checkpoint or an ``.npz``
of its flax tree).

``--ckpt`` is a ``train_renderer`` checkpoint or an ``.npz`` of flax
trees (:mod:`renderloom_torch.core.checkpoint`); an orbax checkpoint
needs JAX.  It runs on the CUDA device unless ``--device cpu`` is
given, and without a CUDA device it refuses to run.

Usage:
  python -m renderloom_torch.cli.infer_renderer \\
      --ckpt runs/renderer_torch/checkpoint.pt --input-dir example/test
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np
import torch

from renderloom_torch.cli import cli_device
from renderloom_torch.convert import load_flax_params
from renderloom_torch.core.checkpoint import (ORBAX_HELP, read_params,
                                              read_renderer)
from renderloom_torch.core.config import (FlowConfig, RendererConfig,
                                          SloMoConfig, load_flow_config,
                                          load_renderer_config)
from renderloom_torch.eval.render_eval import render_folder
from renderloom_torch.models.flownet import make_learned_interp
from renderloom_torch.models.superslomo import SuperSloMo
from renderloom_torch.ops.flow import upsample_background
from renderloom_torch.train.flow import build_flow_model
from renderloom_torch.train.gan import set_float32_precision

SLOMO_CKPT_HELP = ("Super SloMo weights at the published widths: a torch.save "
                   "of the model's state_dict, or an .npz of the flax tree "
                   "(keys params/flow_net/..., params/time_net/...)")
FLOW_CKPT_HELP = ("a renderloom_torch.cli.train_flow checkpoint, or an .npz "
                  "of the flax tree (keys params/...); " + ORBAX_HELP)
CKPT_HELP = ("renderer weights: a renderloom_torch.cli.train_renderer "
             "checkpoint, or an .npz of flax trees (keys params/... and "
             "batch_stats/...); " + ORBAX_HELP)


def load_flow_interp(flow_ckpt: str, flow_config: Optional[str] = None,
                     device="cuda") -> Callable:
    """The learned flow backend ``interp_fn(a, b, t)``
    (``models.flownet.make_learned_interp``, bounded by the config's
    ``max_disp``) with the UNet weights at ``flow_ckpt``: a
    ``train_flow`` checkpoint or an ``.npz`` of the flax tree."""
    cfg = load_flow_config(flow_config) if flow_config else FlowConfig()
    model = load_flax_params(build_flow_model(cfg), read_params(flow_ckpt))
    return make_learned_interp(model.to(device).eval(),
                               max_disp=cfg.max_disp)


def load_slomo(slomo_ckpt: str, device="cuda") -> SuperSloMo:
    """Super SloMo at its published widths with the weights at
    ``slomo_ckpt`` (:data:`SLOMO_CKPT_HELP`), on ``device``."""
    model = load_flax_params(SuperSloMo(SloMoConfig()),
                             read_params(slomo_ckpt))
    return model.to(device).eval()


@torch.inference_mode()
def synthesize_backgrounds(input_dir: str, dain_dir: str, rate: int,
                           device="cuda",
                           interp_fn: Optional[Callable] = None,
                           slomo: Optional[SuperSloMo] = None) -> int:
    """Fill a DAIN/-equivalent folder with flow-interpolated frames
    (``upsample_background`` at its defaults on ``device``: LK, the
    learned ``interp_fn``, or Super SloMo) as ``%05d.png``; returns the
    number of frames written."""
    from PIL import Image

    keys = sorted(f for f in os.listdir(input_dir)
                  if f.lower().endswith((".png", ".jpg", ".jpeg")))
    frames = np.stack([
        np.asarray(Image.open(os.path.join(input_dir, f)).convert("RGB"))
        for f in keys]).astype(np.float32) / 255.0
    dense = upsample_background(torch.from_numpy(frames).to(device), rate,
                                interp_fn=interp_fn, slomo=slomo)
    arr = (dense.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    os.makedirs(dain_dir, exist_ok=True)
    for i in range(arr.shape[0]):
        Image.fromarray(arr[i]).save(os.path.join(dain_dir, f"{i:05d}.png"))
    return arr.shape[0]


def main(argv=None):
    p = argparse.ArgumentParser(description="renderloom_torch renderer "
                                            "inference")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--ckpt", type=str, required=True, help=CKPT_HELP)
    p.add_argument("--input-dir", type=str, required=True)
    p.add_argument("--out-name", type=str, default="Generated_frames")
    p.add_argument("--clip", type=str, default=None,
                   help="process one clip subfolder only")
    p.add_argument("--upsample-rate", type=int, default=4,
                   help="used when synthesizing missing backgrounds")
    p.add_argument("--seed", type=int, default=123,
                   help="accepted as in the JAX CLI; nothing is drawn, "
                        "every weight comes from --ckpt")
    p.add_argument("--flow-ckpt", type=str, default=None,
                   help="learned flow checkpoint for background synthesis "
                        "(default: pyramidal LK): " + FLOW_CKPT_HELP)
    p.add_argument("--flow-config", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    device = cli_device("infer_renderer", args.device)
    set_float32_precision()
    cfg = load_renderer_config(args.config) if args.config \
        else RendererConfig()
    interp_fn = load_flow_interp(args.flow_ckpt, args.flow_config, device) \
        if args.flow_ckpt else None
    params_g, stats_g = read_renderer(args.ckpt)
    print(f"loaded renderer weights from {args.ckpt}")

    inputs_root = os.path.join(args.input_dir, "inputs")
    dain_root = os.path.join(args.input_dir, "DAIN")
    pose_root = os.path.join(args.input_dir, "Predict_motion")
    out_root = os.path.join(args.input_dir, args.out_name)

    clips = [args.clip] if args.clip else sorted(
        f for f in os.listdir(inputs_root)
        if os.path.isdir(os.path.join(inputs_root, f)))
    if not clips:
        clips = [""]

    for clip in clips:
        input_dir = os.path.join(inputs_root, clip)
        dain_dir = os.path.join(dain_root, clip)
        pose_dir = os.path.join(pose_root, clip)
        out_dir = os.path.join(out_root, clip)
        if not os.path.isdir(dain_dir) or not os.listdir(dain_dir):
            print(f"clip {clip or '.'}: no DAIN folder — synthesizing "
                  "backgrounds with the flow interpolator")
            n = synthesize_backgrounds(input_dir, dain_dir,
                                       args.upsample_rate, device, interp_fn)
            print(f"  wrote {n} background frames")
        n = render_folder(params_g, stats_g, cfg, input_dir, dain_dir,
                          pose_dir, out_dir, device)
        print(f"clip {clip or '.'}: wrote {n} frames to {out_dir}")


if __name__ == "__main__":
    main()
