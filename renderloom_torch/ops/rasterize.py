"""Pose rasterization in plain PyTorch: gaussian heatmaps, colored
skeleton, human masks (deterministic/eval path).

Port of the JAX package's ``renderloom/ops/rasterize.py``.  The skeleton
topology and brush constants are copied here so the port stands alone.
Every field is a closed form over the pixel grid: heatmaps are
``exp(-d²/2σ²)`` around the floored joint, limbs are capsules (distance
to segment, compared squared), overlapping limb colors average.
Outputs are channel-major (F, C, H, W) like the JAX functions; the
serving path's NHWC label comes from the kernel in
:mod:`renderloom_torch.ops.rasterize_kernel`, which shares these
constants.
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


def _grid(height: int, width: int, device):
    ys = torch.arange(height, dtype=torch.float32, device=device)
    xs = torch.arange(width, dtype=torch.float32, device=device)
    return ys[:, None], xs[None, :]


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


def gaussian_heatmaps(coords, conf, height, width, sigma,
                      thres: float = 0.001) -> torch.Tensor:
    """(F, J, 2) xy + (F, J) conf → (F, J, H, W) unit-peak gaussians
    around the floored joint; ``sigma`` is (J,)."""
    x = torch.floor(coords[..., 0])[..., None, None]
    y = torch.floor(coords[..., 1])[..., None, None]
    valid = _in_frame(coords, conf, height, width, thres)
    ys, xs = _grid(height, width, coords.device)
    d2 = (xs - x) ** 2 + (ys - y) ** 2
    maps = torch.exp(-d2 / (2.0 * sigma[:, None, None] ** 2))
    return maps * valid[..., None, None].float()


def skeleton_image(coords, conf, height, width, thres: float = 0.001,
                   foot_thres: float = 0.001,
                   brush: float = SKELETON_BRUSH) -> torch.Tensor:
    """(F, J, 2) xy + (F, J) conf → (F, 3, H, W) colored skeleton in
    [0, 1]: limbs are capsules of radius ``brush`` with endpoint dots of
    radius ``2·brush``; an edge is drawn when both joints are valid."""
    dev = coords.device
    edges = torch.as_tensor(POSE_EDGES_19, device=dev)
    colors = torch.as_tensor(POSE_COLORS_19, device=dev) / 255.0
    valid = valid_joints(coords, conf, height, width, thres, foot_thres)
    safe = torch.where(valid[..., None], coords, torch.zeros_like(coords))
    a = safe[:, edges[:, 0]][..., None, None]          # (F, E, 2, 1, 1)
    b = safe[:, edges[:, 1]][..., None, None]
    edge_ok = valid[:, edges[:, 0]] & valid[:, edges[:, 1]]
    ys, xs = _grid(height, width, dev)
    ax, ay, bx, by = a[:, :, 0], a[:, :, 1], b[:, :, 0], b[:, :, 1]
    d2_seg = segment_dist2(xs, ys, ax, ay, bx, by)      # (F, E, H, W)
    d2_a = (xs - ax) ** 2 + (ys - ay) ** 2
    d2_b = (xs - bx) ** 2 + (ys - by) ** 2
    cover = ((d2_seg <= brush * brush) | (d2_a <= (2 * brush) ** 2)
             | (d2_b <= (2 * brush) ** 2))
    cover = (cover & edge_ok[..., None, None]).float()
    n = cover.sum(dim=1)
    rgb = torch.einsum("fehw,ec->fchw", cover, colors)
    return rgb / torch.clamp(n, min=1.0)[:, None]


def human_masks(coords, conf, height, width, thres: float = 0.001
                ) -> torch.Tensor:
    """(F, J, 2) xy + (F, J) conf → (F, H, W) bool: union of joint disks
    and limb capsules around the floored joints."""
    dev = coords.device
    valid = _in_frame(coords, conf, height, width, thres)
    xi = torch.floor(coords[..., 0])
    yi = torch.floor(coords[..., 1])
    ys, xs = _grid(height, width, dev)
    d2_joint = ((xs - xi[..., None, None]) ** 2
                + (ys - yi[..., None, None]) ** 2)
    radii_j = torch.as_tensor(MASK_JOINT_RADII, device=dev)[:, None, None]
    mask = ((d2_joint <= radii_j * radii_j)
            & valid[..., None, None]).any(dim=1)
    edges = torch.as_tensor(MASK_EDGES, device=dev)
    radii = torch.as_tensor(MASK_EDGE_RADII, device=dev)[:, None, None]
    pa = lambda v: v[:, edges[:, 0]][..., None, None]
    pb = lambda v: v[:, edges[:, 1]][..., None, None]
    d2_seg = segment_dist2(xs, ys, pa(xi), pa(yi), pb(xi), pb(yi))
    edge_ok = valid[:, edges[:, 0]] & valid[:, edges[:, 1]]
    capsule = (d2_seg <= radii * radii) & edge_ok[..., None, None]
    return mask | capsule.any(dim=1)


def rasterize_frames(coords: torch.Tensor, conf: torch.Tensor, height: int,
                     width: int, gauss_sigma: float = 5.0,
                     thres: float = 0.001,
                     foot_thres: float = 0.001) -> Dict[str, torch.Tensor]:
    """Deterministic label stack of F frames: ``heatmaps`` (F,19,H,W) and
    ``skeleton`` (F,3,H,W) in [0, 1], ``mask``/``part_mask`` (F,H,W) bool
    (the part mask is empty without the train-time limb draw)."""
    J = coords.shape[-2]
    sigma = torch.full((J,), gauss_sigma, dtype=torch.float32,
                       device=coords.device)
    mask = human_masks(coords, conf, height, width, thres)
    return {"heatmaps": gaussian_heatmaps(coords, conf, height, width,
                                          sigma, thres),
            "skeleton": skeleton_image(coords, conf, height, width, thres,
                                       foot_thres),
            "mask": mask, "part_mask": torch.zeros_like(mask)}
