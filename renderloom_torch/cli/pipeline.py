"""End-to-end clip interpolation from files: keyframes + poses → frames.

Port of the JAX package's ``renderloom/cli/pipeline.py``, in five
stages:

  0. without ``--pose-dir``: the keyframe poses extracted by the pose
     head of ``--pose-ckpt`` at 256×384 (``extract_pose.
     extract_folder``), ``poses/``;
  1. motion upsampling: low-FPS openpose JSONs → dense pose JSONs
     (``MotionInterpolator.interpolate_openpose``), ``Predict_motion/``
     and ``Linear_motion/``;
  2. background synthesis: flow-interpolated keyframes
     (``infer_renderer.synthesize_backgrounds``; LK, the learned UNet
     of ``--flow-ckpt``, or with ``--background superslomo`` Super
     SloMo with the weights of ``--slomo-ckpt``), ``DAIN/``;
  3. rendering: the pose-conditioned SPADE rollout with soft
     compositing (``render_eval.render_folder``), ``Generated_frames/``;
  4. optional mp4/gif export (imageio).

The checkpoints are the port's ``torch.save`` files or ``.npz`` files of
flax trees (:mod:`renderloom_torch.core.checkpoint`); an orbax
checkpoint needs JAX.  It runs on the CUDA device unless ``--device
cpu`` is given, and without a CUDA device it refuses to run.  Each model
computes in its config's ``compute_dtype``.

Usage:
  python -m renderloom_torch.cli.pipeline --frames-dir clip/frames \\
      --pose-dir clip/poses --motion-ckpt motion.npz \\
      --renderer-ckpt runs/renderer_torch/checkpoint.pt \\
      --out-dir clip/out --rate 4
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from renderloom_torch.cli import cli_device
from renderloom_torch.cli import extract_pose, infer_motion, infer_renderer
from renderloom_torch.core.checkpoint import read_params, read_renderer
from renderloom_torch.core.config import (MotionConfig, PoseNetConfig,
                                          RendererConfig, load_motion_config,
                                          load_pose_config,
                                          load_renderer_config)
from renderloom_torch.eval.motion_infer import make_interpolator
from renderloom_torch.eval.render_eval import render_folder
from renderloom_torch.train.gan import set_float32_precision


def main(argv=None) -> dict:
    """Run the stages; returns each stage's seconds (``pose`` without
    ``--pose-dir``, ``motion``, ``background``, ``render`` and, with
    ``--video``, ``video``), file reading and writing included."""
    p = argparse.ArgumentParser(
        description="renderloom_torch end-to-end interpolation")
    p.add_argument("--frames-dir", type=str, required=True,
                   help="low-FPS keyframe images")
    p.add_argument("--pose-dir", type=str, default=None,
                   help="low-FPS openpose JSONs for the same frames "
                        "(omit to extract them with --pose-ckpt)")
    p.add_argument("--pose-ckpt", type=str, default=None,
                   help="pose-head weights: extracts the poses of "
                        "--frames-dir when --pose-dir is not given "
                        "(stage 0); " + extract_pose.CKPT_HELP)
    p.add_argument("--pose-config", type=str, default=None)
    p.add_argument("--motion-ckpt", type=str, required=True,
                   help=infer_motion.CKPT_HELP)
    p.add_argument("--renderer-ckpt", type=str, required=True,
                   help=infer_renderer.CKPT_HELP)
    p.add_argument("--motion-config", type=str, default=None)
    p.add_argument("--renderer-config", type=str, default=None)
    p.add_argument("--out-dir", type=str, required=True)
    p.add_argument("--rate", type=int, default=4,
                   help="upsampling factor (power of two)")
    p.add_argument("--video", type=str, default=None,
                   help="optional output mp4 path")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--seed", type=int, default=123,
                   help="accepted as in the JAX CLI; nothing is drawn, "
                        "every weight comes from the checkpoints")
    p.add_argument("--flow-ckpt", type=str, default=None,
                   help="learned flow checkpoint for stage 2 (default: "
                        "pyramidal LK): " + infer_renderer.FLOW_CKPT_HELP)
    p.add_argument("--flow-config", type=str, default=None)
    p.add_argument("--background", choices=("lk", "superslomo"),
                   default="lk",
                   help="stage 2's interpolator: Lucas-Kanade (or the "
                        "learned UNet of --flow-ckpt), or Super SloMo "
                        "(needs --slomo-ckpt)")
    p.add_argument("--slomo-ckpt", type=str, default=None,
                   help="with --background superslomo: " +
                        infer_renderer.SLOMO_CKPT_HELP)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    if args.pose_dir is None and not args.pose_ckpt:
        raise SystemExit("either --pose-dir (external openpose JSONs) or "
                         "--pose-ckpt (the pose head) is required")
    if args.background == "superslomo" and not args.slomo_ckpt:
        raise SystemExit("--background superslomo needs --slomo-ckpt")
    if args.background == "superslomo" and args.flow_ckpt:
        raise SystemExit("--flow-ckpt is the LK backend's learned UNet; "
                         "--background superslomo takes --slomo-ckpt")
    device = cli_device("pipeline", args.device)
    set_float32_precision()
    os.makedirs(args.out_dir, exist_ok=True)
    seconds = {}

    # the learned backgrounds' weights, read before any stage runs
    interp_fn = infer_renderer.load_flow_interp(
        args.flow_ckpt, args.flow_config, device) if args.flow_ckpt else None
    slomo = infer_renderer.load_slomo(args.slomo_ckpt, device) \
        if args.background == "superslomo" else None

    # ---- stage 0 (optional): pose extraction ------------------------
    pose_dir = args.pose_dir
    if pose_dir is None:
        tic = time.perf_counter()
        pcfg = load_pose_config(args.pose_config) if args.pose_config \
            else PoseNetConfig()
        pose_dir = os.path.join(args.out_dir, "poses")
        n = extract_pose.extract_folder(
            extract_pose.load_pose_model(args.pose_ckpt, pcfg, device),
            args.frames_dir, pose_dir, 256, 384)
        seconds["pose"] = time.perf_counter() - tic
        print(f"pose: extracted {n} openpose JSONs to {pose_dir} "
              f"({seconds['pose']:.2f} s)")

    # ---- stage 1: motion upsampling ---------------------------------
    tic = time.perf_counter()
    mcfg = load_motion_config(args.motion_config) if args.motion_config \
        else MotionConfig()
    mean, std = infer_motion.load_stats(mcfg.dataset)
    interp = make_interpolator(mcfg, read_params(args.motion_ckpt), mean,
                               std, device)
    pred_dir = os.path.join(args.out_dir, "Predict_motion")
    lin_dir = os.path.join(args.out_dir, "Linear_motion")
    interp.interpolate_openpose(pose_dir, args.rate, pred_dir, lin_dir)
    seconds["motion"] = time.perf_counter() - tic
    print(f"motion: wrote dense poses to {pred_dir} "
          f"({seconds['motion']:.2f} s)")

    # ---- stage 2: background synthesis ------------------------------
    tic = time.perf_counter()
    dain_dir = os.path.join(args.out_dir, "DAIN")
    n_back = infer_renderer.synthesize_backgrounds(
        args.frames_dir, dain_dir, args.rate, device, interp_fn, slomo)
    seconds["background"] = time.perf_counter() - tic
    backend = "Super SloMo" if slomo is not None else \
        "learned" if interp_fn else "LK"
    print(f"background: wrote {n_back} flow-interpolated frames "
          f"({backend} backend, {seconds['background']:.2f} s)")

    # ---- stage 3: neural rendering ----------------------------------
    tic = time.perf_counter()
    rcfg = load_renderer_config(args.renderer_config) \
        if args.renderer_config else RendererConfig()
    params_g, stats_g = read_renderer(args.renderer_ckpt)
    out_frames = os.path.join(args.out_dir, "Generated_frames")
    n = render_folder(params_g, stats_g, rcfg, args.frames_dir, dain_dir,
                      pred_dir, out_frames, device)
    seconds["render"] = time.perf_counter() - tic
    print(f"render: wrote {n} fused frames to {out_frames} "
          f"({seconds['render']:.2f} s)")

    # ---- stage 4: video export --------------------------------------
    if args.video:
        from PIL import Image

        from renderloom_torch.utils.visualize import write_video

        tic = time.perf_counter()
        names = sorted(os.listdir(out_frames))
        frames = [np.asarray(Image.open(os.path.join(out_frames, f)))
                  for f in names]
        written = write_video(frames, args.video, args.fps)
        seconds["video"] = time.perf_counter() - tic
        print(f"video: {written} ({len(frames)} frames @ {args.fps})")
    return seconds


if __name__ == "__main__":
    main()
