"""Visualization: skeleton frames, GIF and grid videos, the evaluation
report.

Port of the JAX package's ``renderloom/utils/visualize.py`` (the
reference's ``Human_Motion_Modelling/utils/visualize.py:12-189`` and
``Pose_Guided_Neural_Rendering/utils/visualize.py:38-85``):

* :func:`print_evaluation` — the console and ``history.txt`` report;
* :func:`render_skeleton_frames` — a motion's colored-skeleton frames,
  rasterized by K1 (``csrc/rasterize.cu``) in its cfhw layout on the
  card, at most :data:`SKELETON_CHUNK` frames a launch, and by its plain
  twin on the CPU; :func:`motion2gif` writes them as a GIF;
* :func:`make_grid_video` / :func:`write_video` — grid videos of named
  frame streams.

imageio is imported only when a GIF or video is written.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

# frames per K1 launch in render_skeleton_frames: the cfhw layout also
# writes 19 heatmap channels and two masks, 24 float32 planes a frame
# (25.2 MB at 512×512), so 32 frames take 0.81 GB a launch
SKELETON_CHUNK = 32
SKELETON_BRUSH = 2.0        # skeleton_image(..., brush=2.0) in JAX


def print_evaluation(results: Mapping[str, float], epoch: int = 0,
                     history_path: Optional[str] = None) -> str:
    """Console and history.txt evaluation report
    (Human_Motion_Modelling/utils/visualize.py:12-27); returns the
    text."""
    lines = [f"--------- evaluation (epoch {epoch}) ---------"]
    for key in sorted(results):
        lines.append(f"  {key:<14s} {results[key]:.6f}")
    text = "\n".join(lines)
    print(text, flush=True)
    if history_path:
        os.makedirs(os.path.dirname(history_path) or ".", exist_ok=True)
        with open(history_path, "a") as f:
            f.write(text + "\n")
    return text


def render_skeleton_frames(motion: np.ndarray, height: int = 512,
                           width: int = 512, device="cuda") -> np.ndarray:
    """(19, 2, L) joint positions in pixel coordinates → (L, H, W, 3)
    uint8 skeleton frames (the reference's ``joints2image``,
    Human_Motion_Modelling/utils/visualize.py:67-189): every joint with
    confidence one, limbs of brush 2 (``skeleton_image(..., brush=2.0)``
    in JAX), clipped to [0, 1] and scaled by 255 with truncation.  On a
    CUDA ``device`` each chunk of at most :data:`SKELETON_CHUNK` frames
    is one K1 launch in the cfhw layout (its heatmaps and masks are
    written and dropped); on the CPU the twin computes the same.  A CUDA
    request without a card raises."""
    from renderloom_torch.ops.rasterize_kernel import (build_tables,
                                                       rasterize_tables)

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render_skeleton_frames: no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    coords = torch.as_tensor(np.ascontiguousarray(
        np.asarray(motion).transpose(2, 0, 1)), dtype=torch.float32)
    frames = []
    for lo in range(0, coords.shape[0], SKELETON_CHUNK):
        c = coords[lo:lo + SKELETON_CHUNK].to(device)
        tables = build_tables(c, torch.ones(c.shape[:2], device=device),
                              height, width)
        skel = rasterize_tables(*(t.contiguous() for t in tables), height,
                                width, emit_masks=True, layout="cfhw",
                                brush=SKELETON_BRUSH)["skeleton"]
        u8 = (torch.clamp(skel, 0.0, 1.0) * 255.0).to(torch.uint8)
        frames.append(u8.permute(0, 2, 3, 1).cpu().numpy())
    return np.concatenate(frames)


def motion2gif(motion: np.ndarray, path: str, height: int = 512,
               width: int = 512, fps: int = 25, scale: float = 128.0,
               offset: float = 256.0, device="cuda") -> str:
    """Write a skeleton GIF for a (19, 2, L) normalized motion
    (``motion2gif``, utils/visualize.py:29-64; the render transform ×128
    + 256 of models/evaluator.py:248-250); returns the path."""
    import imageio.v2 as imageio

    pixels = motion * scale + offset
    frames = render_skeleton_frames(pixels, height, width, device)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imageio.mimsave(path, list(frames), duration=1.0 / fps)
    return path


def make_grid_video(streams: Dict[str, List[np.ndarray]], path: str,
                    fps: int = 30, cols: int = 3) -> str:
    """2×3-style grid mp4 of named frame streams (Predict/Mask/Fuse/
    DAIN/GT/Skeleton; Pose_Guided_Neural_Rendering/utils/visualize.py:
    38-85).  Streams are equal-length lists of (H, W, 3) or
    (H, W) arrays in [0, 1] or [-1, 1]."""
    names = list(streams)
    n = len(names)
    rows = (n + cols - 1) // cols
    length = min(len(v) for v in streams.values())

    def to_u8(img):
        img = np.asarray(img, dtype=np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        if img.min() < 0:
            img = img * 0.5 + 0.5
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    grids = []
    for i in range(length):
        tiles = [to_u8(streams[k][i]) for k in names]
        h, wd = tiles[0].shape[:2]
        tiles = [t if t.shape[:2] == (h, wd) else
                 np.zeros((h, wd, 3), np.uint8) for t in tiles]
        while len(tiles) < rows * cols:
            tiles.append(np.zeros((h, wd, 3), np.uint8))
        grid = np.concatenate([
            np.concatenate(tiles[r * cols:(r + 1) * cols], axis=1)
            for r in range(rows)], axis=0)
        # mp4 needs even dims
        grids.append(grid[:grid.shape[0] // 2 * 2,
                          :grid.shape[1] // 2 * 2])
    return write_video(grids, path, fps)


def write_video(frames: List[np.ndarray], path: str, fps: int = 30
                ) -> str:
    """Write frames as mp4 when an ffmpeg backend exists, else as a GIF
    next to the requested path; returns the path written."""
    import imageio.v2 as imageio

    try:
        with imageio.get_writer(path, fps=fps) as w:
            for f in frames:
                w.append_data(f)
        return path
    except (ValueError, ImportError):
        alt = os.path.splitext(path)[0] + ".gif"
        imageio.mimsave(alt, frames, duration=1.0 / fps)
        print(f"no mp4 backend — wrote {alt} instead")
        return alt
