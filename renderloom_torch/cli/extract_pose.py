"""Extract openpose-format JSONs from frame folders with the pose head.

Port of the JAX package's ``renderloom/cli/extract_pose.py``: every
frame is resized to ``--height`` × ``--width``, run through
:class:`~renderloom_torch.models.posenet.PoseNet` in batches of 8,
decoded by the soft-argmax (``decode_heatmaps``), scaled back to the
frame's own pixels and written as ``<stem>_keypoints.json`` in the
BODY25 schema that :mod:`renderloom_torch.data.openpose` reads.

``--ckpt`` is a ``train_pose`` checkpoint or an ``.npz`` of the flax
tree (:mod:`renderloom_torch.core.checkpoint`); an orbax checkpoint
needs JAX.  It runs on the CUDA device unless ``--device cpu`` is
given, and without a CUDA device it refuses to run.

Usage:
  python -m renderloom_torch.cli.extract_pose \\
      --ckpt runs/pose_torch/checkpoint.pt --frames clips/ --poses out/
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from renderloom_torch.cli import cli_device
from renderloom_torch.convert import load_flax_params
from renderloom_torch.core.checkpoint import ORBAX_HELP, read_params
from renderloom_torch.core.config import PoseNetConfig, load_pose_config
from renderloom_torch.models.posenet import PoseNet, decode_heatmaps
from renderloom_torch.train.gan import set_float32_precision
from renderloom_torch.train.pose import build_pose_model

CKPT_HELP = ("pose-head weights: a renderloom_torch.cli.train_pose "
             "checkpoint, or an .npz of the flax tree (keys params/...); "
             + ORBAX_HELP)


def load_pose_model(ckpt: str, cfg: PoseNetConfig, device) -> PoseNet:
    """The pose head of ``cfg`` with the weights at ``ckpt``, in
    evaluation mode on ``device``."""
    set_float32_precision()
    model = load_flax_params(build_pose_model(cfg), read_params(ckpt))
    return model.to(device).eval()


def _openpose_json(kps: np.ndarray, conf: np.ndarray) -> dict:
    """19-joint (x, y) + conf → an openpose BODY25-style person (the
    inverse of :mod:`renderloom_torch.data.openpose`'s reader: joints
    0–14 and the toes at 19 and 22; the hand means as one-point hand
    lists)."""
    body = np.zeros((25, 3), np.float32)
    body[:15, :2] = kps[:15]
    body[:15, 2] = conf[:15]
    body[19, :2] = kps[15]
    body[19, 2] = conf[15]
    body[22, :2] = kps[16]
    body[22, 2] = conf[16]
    left = [float(kps[17, 0]), float(kps[17, 1]), float(conf[17])]
    right = [float(kps[18, 0]), float(kps[18, 1]), float(conf[18])]
    return {
        "pose_keypoints_2d": [float(v) for v in body.reshape(-1)],
        "hand_left_keypoints_2d": left,
        "hand_right_keypoints_2d": right,
    }


@torch.inference_mode()
def extract_folder(model: PoseNet, frames_dir: str, out_dir: str,
                   height: int, width: int, batch: int = 8) -> int:
    """Write one openpose JSON per frame of ``frames_dir`` (PNG or JPEG,
    sorted by name) to ``out_dir``; returns the number written.  The
    last batch is padded with zero images to ``batch``, as the JAX CLI
    keeps its shapes static."""
    from PIL import Image

    device = next(model.parameters()).device
    names = sorted(f for f in os.listdir(frames_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for i in range(0, len(names), batch):
        chunk = names[i:i + batch]
        imgs, scales = [], []
        for f in chunk:
            im = Image.open(os.path.join(frames_dir, f)).convert("RGB")
            scales.append((im.width / width, im.height / height))
            imgs.append(np.asarray(im.resize((width, height)),
                                   np.float32) / 255.0)
        arr = np.stack(imgs)
        if len(chunk) < batch:
            arr = np.concatenate(
                [arr, np.zeros((batch - len(chunk),) + arr.shape[1:],
                               np.float32)])
        kps, conf = decode_heatmaps(model(torch.from_numpy(arr).to(device)))
        kps, conf = kps.cpu().numpy(), conf.cpu().numpy()
        for j, f in enumerate(chunk):
            sx, sy = scales[j]
            pts = kps[j] * np.asarray([[sx, sy]], np.float32)
            stem = os.path.splitext(f)[0]
            with open(os.path.join(out_dir, f"{stem}_keypoints.json"),
                      "w") as fh:
                json.dump({"version": 1.3,
                           "people": [_openpose_json(pts, conf[j])]}, fh)
            n += 1
    return n


def main(argv=None) -> int:
    """Extract every clip of ``--frames``; returns the JSONs written."""
    p = argparse.ArgumentParser(
        description="renderloom_torch pose extraction (openpose JSONs)")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--ckpt", type=str, required=True, help=CKPT_HELP)
    p.add_argument("--frames", type=str, required=True,
                   help="folder of frames, or folder of clip subfolders")
    p.add_argument("--poses", type=str, required=True)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=384)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    device = cli_device("extract_pose", args.device)
    cfg = load_pose_config(args.config) if args.config else PoseNetConfig()
    model = load_pose_model(args.ckpt, cfg, device)
    print(f"loaded pose weights from {args.ckpt}")

    subdirs = sorted(d for d in os.listdir(args.frames)
                     if os.path.isdir(os.path.join(args.frames, d)))
    total = 0
    for clip in subdirs or [""]:
        n = extract_folder(model, os.path.join(args.frames, clip),
                           os.path.join(args.poses, clip), args.height,
                           args.width)
        print(f"clip {clip or '.'}: {n} pose JSONs")
        total += n
    print(f"wrote {total} JSONs to {args.poses}")
    return total


if __name__ == "__main__":
    main()
