"""The skeleton topology, colours, brush and mask radii of the pose
label, and the joints' validity test.  Frozen copy of the constants of
the port's ``ops/rasterize.py``, which :mod:`rlbench.reference.ops.raster`
rasterizes with.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# 14 body edges + 4 extremity edges for the 19-joint layout
# (keypoint2img.py:150-173)
POSE_EDGES_19 = np.array([
    [0, 1], [1, 8],
    [1, 2], [2, 3], [3, 4],
    [1, 5], [5, 6], [6, 7],
    [8, 9], [9, 10], [10, 11],
    [8, 12], [12, 13], [13, 14],
    [4, 18], [7, 17], [11, 16], [14, 15],
], dtype=np.int64)

POSE_COLORS_19 = np.array([
    [153, 0, 51], [153, 0, 0],
    [153, 51, 0], [153, 102, 0], [153, 153, 0],
    [102, 153, 0], [51, 153, 0], [0, 153, 0],
    [0, 153, 51], [0, 153, 102], [0, 153, 153],
    [0, 102, 153], [0, 51, 153], [0, 0, 153],
    [208, 208, 0], [0, 208, 0], [0, 208, 208], [0, 0, 208],
], dtype=np.float32)

# joints that use the (lower) foot confidence threshold
FOOT_JOINTS = np.array([8, 9, 10, 11, 12, 13, 14, 15, 16], dtype=np.int64)

# human-mask limb groups with brush radii (HSM_auto_dataset.py:262-276)
MASK_EDGES = np.array([
    [0, 1],                                              # head
    [1, 2], [2, 3], [3, 4], [1, 5], [5, 6], [6, 7],      # arms
    [8, 9], [9, 10], [10, 11], [8, 12], [12, 13], [13, 14],  # legs
    [4, 18], [7, 17],                                    # hands
    [11, 16], [14, 15],                                  # feet
    [1, 8], [2, 9], [5, 12],                             # body
], dtype=np.int64)
MASK_EDGE_RADII = np.array([15.0] * 17 + [20.0] * 3, dtype=np.float32)
MASK_JOINT_RADII = np.array([30.0] + [15.0] * 18, dtype=np.float32)

SKELETON_BRUSH = 4.0          # drawEdge bw=4 (HSM_auto_dataset.py:251)


def _in_frame(coords, conf, height, width, thr):
    x, y = coords[..., 0], coords[..., 1]
    return (x >= 0) & (y >= 0) & (x < width) & (y < height) & (conf > thr)


def valid_joints(coords: torch.Tensor, conf: torch.Tensor, height: int,
                 width: int, thres: float = 0.001,
                 foot_thres: float = 0.001) -> torch.Tensor:
    """(..., J) bool: inside the frame and above the per-joint
    confidence threshold (feet use ``foot_thres``)."""
    J = coords.shape[-2]
    thr = torch.full((J,), thres, dtype=torch.float32, device=coords.device)
    thr[torch.as_tensor(FOOT_JOINTS, device=coords.device)] = foot_thres
    return _in_frame(coords, conf, height, width, thr)


def segment_dist2(px, py, ax, ay, bx, by):
    """SQUARED distance from pixels (px, py) to segments a→b; every
    consumer compares it against a squared radius."""
    dx, dy = bx - ax, by - ay
    len2 = dx * dx + dy * dy
    t = ((px - ax) * dx + (py - ay) * dy) / torch.clamp(len2, min=1e-6)
    t = torch.clamp(t, 0.0, 1.0)
    cx = ax + t * dx
    cy = ay + t * dy
    return (px - cx) ** 2 + (py - cy) ** 2


