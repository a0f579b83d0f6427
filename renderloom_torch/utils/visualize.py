"""Grid videos of named frame streams.

Port of ``make_grid_video`` and ``write_video`` of the JAX package's
``renderloom/utils/visualize.py`` (the reference's
``Pose_Guided_Neural_Rendering/utils/visualize.py:38-85``): numpy frames
in, an mp4 (or a GIF where imageio has no mp4 backend) out.  imageio is
imported only when a video is written.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def make_grid_video(streams: Dict[str, List[np.ndarray]], path: str,
                    fps: int = 30, cols: int = 3) -> str:
    """2×3-style grid mp4 of named frame streams (Predict/Mask/Fuse/
    DAIN/GT/Skeleton).  Streams are equal-length lists of (H, W, 3) or
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
