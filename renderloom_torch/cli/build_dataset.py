"""Dataset production CLI.

Port of the JAX package's ``renderloom/cli/build_dataset.py``: one entry
point for the ``HumanSloMo_Dataset`` shell-script stage
(``download.sh``/``gen_dataset.sh``/``gen_h5.sh``) plus the background
warping that replaces the external DAIN scripts
(``scripts/DAIN_{train,test}.py``).

Subcommands:
  download    write a youtube-dl script for the missing videos
  extract     pull the clips' frames out of the mp4s (768×512)
  warp        DAIN-equivalent backgrounds from the Lucas-Kanade
              interpolator (``ops/flow.py``; train mode: frame i+1 from
              i and i+2; test mode: every in-between frame at --rate),
              on the CUDA device unless --device cpu is given
  alphapose   write the shell driver of the external AlphaPose detector
  pack-hsm    folder tree → HumanSlomo.h5
  pack-amass  AMASS npz archives → AMASS_3D_joints.h5 (needs the
              external human_body_prior package)

Usage:
  python -m renderloom_torch.cli.build_dataset extract --videos videos \\
      --clips train_list.json --out frames
  python -m renderloom_torch.cli.build_dataset warp --frames frames \\
      --out DAIN --mode train
  python -m renderloom_torch.cli.build_dataset pack-hsm --root data \\
      --out HumanSlomo.h5
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from renderloom_torch.cli import cli_device


def cmd_download(args):
    from renderloom_torch.data.builders import emit_download_script
    n = emit_download_script(args.csv, args.videos, args.out)
    print(f"wrote {n} download commands to {args.out}")
    return n


def cmd_extract(args):
    from renderloom_torch.data.builders import extract_clips
    n = extract_clips(args.videos, args.clips, args.out)
    print(f"extracted {n} frames to {args.out}")
    return n


def cmd_warp(args):
    """Backgrounds for every clip folder under ``--frames``, written as
    ``<out>/<clip>/NNNNN.png``; returns {clip: seconds}, from reading the
    frames to writing the PNGs."""
    from PIL import Image

    from renderloom_torch.ops.flow import (train_background,
                                           upsample_background)

    device = cli_device("build_dataset warp", args.device)
    seconds = {}
    for clip in sorted(os.listdir(args.frames)):
        src = os.path.join(args.frames, clip)
        if not os.path.isdir(src):
            continue
        tic = time.perf_counter()
        files = sorted(f for f in os.listdir(src)
                       if f.lower().endswith((".png", ".jpg")))
        frames = np.stack([
            np.asarray(Image.open(os.path.join(src, f)).convert("RGB"))
            for f in files]).astype(np.float32) / 255.0
        x = torch.from_numpy(frames).to(device)
        with torch.no_grad():
            out = (train_background(x) if args.mode == "train"
                   else upsample_background(x, args.rate))
        arr = (torch.clamp(out, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        dst = os.path.join(args.out, clip)
        os.makedirs(dst, exist_ok=True)
        for i in range(arr.shape[0]):
            Image.fromarray(arr[i]).save(os.path.join(dst, f"{i:05d}.png"))
        seconds[clip] = time.perf_counter() - tic
        print(f"{clip}: {arr.shape[0]} background frames")
    return seconds


def cmd_alphapose(args):
    """Write the shell driver of the external AlphaPose detector
    (``HumanSloMo_Dataset/scripts/gen_run_alphapose.py:11-21``; pose
    extraction stays external)."""
    clips = sorted(d for d in os.listdir(args.frames)
                   if os.path.isdir(os.path.join(args.frames, d)))
    with open(args.out, "w") as f:
        for clip in clips:
            indir = os.path.join(args.frames, clip)
            outdir = os.path.join(args.poses, clip)
            f.write(
                "python3 scripts/demo_inference.py "
                "--cfg configs/halpe_136/resnet/"
                "256x192_res50_lr1e-3_2x-regression.yaml "
                "--checkpoint pretrained_models/halpe136_fast_res50_"
                "256x192.pth "
                f"--indir {indir} --outdir {outdir} "
                "--format open --pose_track\n")
    print(f"wrote {len(clips)} AlphaPose commands to {args.out}")
    return len(clips)


def cmd_pack_hsm(args):
    from renderloom_torch.data.builders import pack_hsm_h5
    counts = pack_hsm_h5(args.root, args.out)
    print(f"packed {len(counts)} clips "
          f"({sum(counts.values())} frames) into {args.out}")
    return counts


def cmd_pack_amass(args):
    from renderloom_torch.core.config import MotionDatasetConfig
    from renderloom_torch.data.builders import pack_amass_h5
    cfg = MotionDatasetConfig()
    splits = list(cfg.train_split) + list(cfg.test_split)
    n = pack_amass_h5(args.root, args.out, splits, args.body_model)
    print(f"packed {n} motions into {args.out}")
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="renderloom_torch dataset "
                                            "builder")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("download")
    d.add_argument("--csv", required=True)
    d.add_argument("--videos", default="videos")
    d.add_argument("--out", default="tmp.sh")
    d.set_defaults(fn=cmd_download)

    e = sub.add_parser("extract")
    e.add_argument("--videos", required=True)
    e.add_argument("--clips", required=True, help="train/test list json")
    e.add_argument("--out", required=True)
    e.set_defaults(fn=cmd_extract)

    w = sub.add_parser("warp")
    w.add_argument("--frames", required=True,
                   help="folder of per-clip frame folders")
    w.add_argument("--out", required=True)
    w.add_argument("--mode", choices=("train", "test"), default="train")
    w.add_argument("--rate", type=int, default=4)
    w.add_argument("--device", type=str, default="cuda")
    w.set_defaults(fn=cmd_warp)

    ap = sub.add_parser("alphapose")
    ap.add_argument("--frames", required=True)
    ap.add_argument("--poses", required=True)
    ap.add_argument("--out", default="run_alphapose.sh")
    ap.set_defaults(fn=cmd_alphapose)

    h = sub.add_parser("pack-hsm")
    h.add_argument("--root", required=True)
    h.add_argument("--out", default="HumanSlomo.h5")
    h.set_defaults(fn=cmd_pack_hsm)

    a = sub.add_parser("pack-amass")
    a.add_argument("--root", required=True)
    a.add_argument("--out", default="AMASS_3D_joints.h5")
    a.add_argument("--body-model", default="")
    a.set_defaults(fn=cmd_pack_amass)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
