"""Renderer evaluation and folder rendering.

Port of the JAX package's ``renderloom/eval/render_eval.py`` (the
reference's ``Pose_Guided_Neural_Rendering/models/evaluator.py``):

* :func:`evaluate_h5` — the training-time metric
  (``evaluate_from_dataset``, evaluator.py:48-147): per test clip, the
  autoregressive rollout at sample rate 2 (even frames pass through as
  keyframes), foreground-masked PSNR/SSIM (and LPIPS) on the generated
  frames, for the fused output and for the warped background;
* :func:`render_folder` — the inference path (``evaluate_from_folder``,
  evaluator.py:165-269): an ``inputs/`` + ``DAIN/`` + ``Predict_motion/``
  folder triple → generated frames as PNGs, its array core
  :func:`render_frames`.

Both take the generator's weights as numpy flax trees (the JAX
``state.params_g`` and ``state.stats_g``), build the inference
generator on ``device`` through ``make_inference_pair`` (``fastpath``
selects the parity-layout generator, as in ``build_pipeline``; it takes
the NHWC label as JAX's does), prepare frames with the port's
``prepare_batch`` (the label kernel) and run the port's rollouts.
Unlike JAX, the last chunk of :func:`render_frames` is not padded to a
fixed shape: eager PyTorch compiles no shapes, and the frames are the
same.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from renderloom_torch.core.config import RendererConfig
from renderloom_torch.data import openpose as op_io
from renderloom_torch.data.hsm import prepare_batch
from renderloom_torch.ops.image import masked_metrics
from renderloom_torch.train.gan import (make_inference_pair, make_rollout,
                                        make_segment_rollout,
                                        rollout_chunked,
                                        segment_rollout_chunked)


@torch.inference_mode()
def evaluate_h5(params_g: dict, stats_g: dict, cfg: RendererConfig, reader,
                max_keyframes: Optional[int] = None, chunk: int = 64,
                perceptual=None, video_dir: Optional[str] = None,
                device="cuda", fastpath: bool = False) -> Dict[str, float]:
    """Training-time evaluation over the h5 test split
    (evaluator.py:48-147).

    ``reader`` is an :class:`~renderloom_torch.data.hsm.HsmReader` in the
    test phase (its ``video_list``, ``n_frames`` and ``read_test_frame``
    are used).  Pass a :class:`~renderloom_torch.models.perceptual.
    PerceptualLoss` as ``perceptual`` to also report uncalibrated
    LPIPS-vgg (``*_LPIPS``).  ``video_dir`` writes a per-clip
    Fuse/Mask/Warp/GT/Skeleton grid video.  ``chunk`` bounds device
    memory: the rollout runs ``chunk`` frames (``chunk // 2`` segments)
    at a time.  Returns the metrics averaged over generated frames."""
    sample_rate = 2
    gen = make_inference_pair(cfg, params_g, stats_g, device, fastpath)
    seg_rollout = make_segment_rollout(gen, sample_rate)
    gen_rollout = make_rollout(gen)
    d = cfg.data
    totals = {"DAIN_PSNR": 0.0, "DAIN_SSIM": 0.0, "OURS_PSNR": 0.0,
              "OURS_SSIM": 0.0}
    if perceptual is not None:
        totals.update({"DAIN_LPIPS": 0.0, "OURS_LPIPS": 0.0})
    cnt = 0
    as_t = lambda a: torch.from_numpy(a)[None].to(device)

    for vid in reader.video_list:
        if vid not in reader.n_frames:
            continue
        total = reader.n_frames[vid]
        limit = max_keyframes if max_keyframes is not None else d.eval_frames
        seq_len = min(limit * sample_rate + 1, total)

        frames = [reader.read_test_frame(vid, i) for i in range(seq_len)]
        prep = prepare_batch(
            {"images": as_t(np.stack([f["image"] for f in frames])),
             "dain": as_t(np.stack([f["dain"] for f in frames])),
             "poses": as_t(np.stack([f["pose"] for f in frames]))}, d)
        batch = {"label": prep["label"], "back": prep["back"],
                 "key_img": prep["image"]}
        if (seq_len - 1) % sample_rate == 0:
            fused, masks = segment_rollout_chunked(
                seg_rollout, batch, sample_rate,
                seg_chunk=max(chunk // sample_rate, 1))
        else:
            batch["is_key"] = torch.as_tensor(
                np.arange(seq_len) % sample_rate == 0)
            fused, masks = rollout_chunked(gen_rollout, batch, chunk=chunk)

        if video_dir:
            from renderloom_torch.utils.visualize import make_grid_video

            np_ = lambda x: x.float().cpu().numpy()
            streams = {"Fuse": list(np_(fused[0])),
                       "Mask": list(np_(masks[0, ..., 0])),
                       "Warp": list(np_(prep["back"][0])),
                       "GT": list(np_(prep["image"][0])),
                       "Skeleton": list(np_(prep["label"][0, ..., :3]))}
            os.makedirs(video_dir, exist_ok=True)
            make_grid_video(streams, os.path.join(video_dir, f"{vid}.mp4"))

        # the generated (non-keyframe) frames in one metrics call per
        # clip: psnr averages per-sample values and the equal-sized ssim
        # maps mean identically, so this matches the reference's
        # frame-by-frame accumulation
        gen_idx = torch.as_tensor(
            [i for i in range(seq_len) if i % sample_rate != 0],
            dtype=torch.long, device=fused.device)
        if gen_idx.numel() == 0:
            continue
        fg = prep["fg_mask"][0, gen_idx]
        gt = prep["image"][0, gen_idx]
        ours = fused[0, gen_idx].float()
        back = prep["back"][0, gen_idx]
        n = int(gen_idx.numel())
        for name, x in (("OURS", ours), ("DAIN", back)):
            ps, ss = masked_metrics(x, gt, fg)
            totals[f"{name}_PSNR"] += float(ps) * n
            totals[f"{name}_SSIM"] += float(ss) * n
            if perceptual is not None:
                totals[f"{name}_LPIPS"] += float(
                    perceptual.lpips(x * fg, gt * fg).float().sum())
        cnt += n

    return {k: v / max(cnt, 1) for k, v in totals.items()}


def _folder_images(path: str) -> List[str]:
    return [os.path.join(path, f) for f in sorted(os.listdir(path))
            if f.lower().endswith((".png", ".jpg", ".jpeg"))]


@torch.inference_mode()
def render_frames(gen, cfg: RendererConfig, keys: np.ndarray,
                  dain: np.ndarray, poses: np.ndarray, rate: int, device
                  ) -> Iterator[Tuple[int, np.ndarray]]:
    """:func:`render_folder`'s array core.  ``keys`` (K, H0, W0, 3) uint8
    keyframes, ``dain`` (L, H0, W0, 3) uint8 backgrounds (the DAIN frame
    at t, not t−1) and ``poses`` (L, 19, 3) joints in pixels + confidence,
    L = (K − 1)·rate + 1, through ``gen`` (``make_inference_pair``'s
    generator on ``device``, either layout).  Yields
    ``(start, frames)``: the uint8 (n, H, W, 3) frames from index
    ``start`` on, one segment-aligned chunk at a time.

    Each chunk starts at a keyframe, which resets the autoregressive
    chain, so no carry crosses chunks and the segments of a chunk run
    as one batch; device memory stays O(chunk).  A chunk's closing
    keyframe is yielded only by the last chunk (it opens the next)."""
    seq_len = (len(keys) - 1) * rate + 1
    images = np.zeros((seq_len,) + dain.shape[1:], np.uint8)
    images[::rate] = keys
    rollout = make_segment_rollout(gen, rate)
    S = (seq_len - 1) // rate
    seg_chunk = max(min(16, S), 64 // rate)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))[None].to(
        device)
    for s0 in range(0, S, seg_chunk):
        s1 = min(s0 + seg_chunk, S)
        start, end = s0 * rate, s1 * rate + 1
        prep = prepare_batch(
            {"images": as_t(images[start:end]),
             "dain": as_t(dain[start:end]),
             "poses": as_t(poses[start:end].astype(np.float32))},
            cfg.data, want_masks=False)
        fused, _ = rollout({"label": prep["label"], "back": prep["back"],
                            "key_img": prep["image"]})
        valid = (end - start) if s1 == S else (end - start - 1)
        frames = ((fused[0, :valid].float() * 0.5 + 0.5).clamp(0, 1)
                  * 255).to(torch.uint8)
        yield start, frames.cpu().numpy()


def render_folder(params_g: dict, stats_g: dict, cfg: RendererConfig,
                  input_dir: str, dain_dir: str, pose_dir: str,
                  out_dir: str, device="cuda",
                  fastpath: bool = False) -> int:
    """Folder inference (evaluator.py:165-269): keyframe images +
    DAIN-interpolated backgrounds + upsampled pose JSONs → fused frames
    written as ``out_dir/%05d.png``.  Returns the number of frames."""
    from PIL import Image

    load = lambda path: np.asarray(Image.open(path).convert("RGB"))
    key_paths = _folder_images(input_dir)
    dain_paths = _folder_images(dain_dir)
    num_poses = sum(f.endswith(".json") for f in os.listdir(pose_dir))
    num_keys = len(key_paths)
    # rate = 2^⌊log2((F−1)/(K−1))⌋ (evaluator.py:187-191)
    ratio = max((num_poses - 1) // max(num_keys - 1, 1), 1)
    rate = 2 ** int(math.log2(ratio))
    seq_len = (num_keys - 1) * rate + 1

    # poses: openpose JSONs in image coordinates (unnormalized read)
    motion, conf, _ = op_io.read_openpose_dir(pose_dir, scale=1.0,
                                              offset=0.0)
    poses = np.concatenate([motion.transpose(2, 0, 1),
                            conf.transpose(2, 0, 1)], axis=2)[:seq_len]
    keys = np.stack([load(p) for p in key_paths])
    dain = np.stack([load(p) for p in dain_paths[:seq_len]])

    gen = make_inference_pair(cfg, params_g, stats_g, device, fastpath)
    os.makedirs(out_dir, exist_ok=True)
    for start, frames in render_frames(gen, cfg, keys, dain, poses, rate,
                                       device):
        for i, frame in enumerate(frames):
            Image.fromarray(frame).save(
                os.path.join(out_dir, f"{start + i:05d}.png"))
    return seq_len
