"""2-D pose estimation head: frames → 19-joint keypoints.

Port of the JAX package's ``renderloom/models/posenet.py``: a compact
encoder predicting per-joint heatmap logits at 1/4 resolution
(:class:`PoseNet`), decoded with a soft-argmax to sub-pixel keypoints in
the openpose 19-joint layout (:func:`decode_heatmaps`), so the pipeline
can extract its keyframe poses without an external model.

Tensors are NHWC.  The convolutions pad as flax's ``"SAME"`` does
(:class:`~renderloom_torch.models.layers.SameConv`: the 7×7 stride-2
stem pads (2, 3) on an even side, the 3×3 stride-2 conv (0, 1)), compute
in the model's dtype on float32 parameters, and the logits come out in
float32.  Parameter names are flax's automatic ones (``Conv_0``,
``Conv_1``, ``_ResBlock_{i}/Conv_{0,1}`` (``Conv_2``, the 1×1 shortcut,
only where a block changes the width), ``Conv_2`` the logits).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from renderloom_torch.models.layers import SameConv, set_compute_dtype

N_JOINTS = 19
STRIDE = 4          # heatmap resolution = image / STRIDE
LEAKY_SLOPE = 0.1


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


class _ResBlock(nn.Module):
    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.Conv_0 = SameConv(in_ch, features, 3)
        self.Conv_1 = SameConv(features, features, 3)
        if in_ch != features:
            self.Conv_2 = SameConv(in_ch, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_1(_leaky(self.Conv_0(x)))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return _leaky(x + h)


class PoseNet(nn.Module):
    """(B, H, W, 3) in [0, 1] → heatmap logits (B, ⌈H/4⌉, ⌈W/4⌉, 19)
    float32.  The logits conv starts at zero
    (:func:`~renderloom_torch.convert.flax_init_`)."""

    def __init__(self, base: int = 32, blocks: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = SameConv(3, base, 7, 2)
        self.Conv_1 = SameConv(base, base * 2, 3, 2)
        for i in range(blocks):
            setattr(self, f"_ResBlock_{i}", _ResBlock(base * 2, base * 2))
        self.Conv_2 = SameConv(base * 2, N_JOINTS, 1)
        self.Conv_2.zero_init = True
        self.blocks = blocks
        self.dtype = dtype
        set_compute_dtype(self, dtype)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = _leaky(self.Conv_0(img.to(self.dtype)))
        x = _leaky(self.Conv_1(x))
        for i in range(self.blocks):
            x = getattr(self, f"_ResBlock_{i}")(x)
        return self.Conv_2(x).float()


def decode_heatmaps(logits: torch.Tensor, beta: float = 25.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft-argmax decode: (B, h, w, J) logits → keypoints (B, J, 2) in
    image pixels (x, y), each cell's centre at (i + 0.5)·STRIDE, and
    confidences (B, J) = sigmoid(max logit)."""
    B, h, w, J = logits.shape
    flat = logits.reshape(B, h * w, J)
    attn = torch.softmax(beta * flat, dim=1).reshape(B, h, w, J)
    ys = torch.arange(h, dtype=torch.float32,
                      device=logits.device)[None, :, None, None]
    xs = torch.arange(w, dtype=torch.float32,
                      device=logits.device)[None, None, :, None]
    y = (attn * ys).sum(dim=(1, 2))
    x = (attn * xs).sum(dim=(1, 2))
    kps = torch.stack([(x + 0.5) * STRIDE, (y + 0.5) * STRIDE], dim=-1)
    conf = torch.sigmoid(flat.max(dim=1).values)
    return kps, conf
