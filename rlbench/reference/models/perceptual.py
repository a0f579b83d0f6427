"""The VGG19 perceptual loss in plain PyTorch: the ReLU taps of an NHWC
input in ImageNet-normalized space and the weighted L1 over them.
Frozen copy of the VGG19 branch of the port's ``models/perceptual.py``;
weights come from the flax tree the caller hands in.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from rlbench.reference.convert import load_flax_params
from rlbench.reference.models.layers import Conv

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# VGG19 conv plan: (block, convs in block, channels)
VGG19_PLAN = [(1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512),
              (5, 4, 512)]
DEFAULT_LAYERS = ("relu_1_1", "relu_2_1", "relu_3_1", "relu_4_1",
                  "relu_5_1")
DEFAULT_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)

class VGG19Features(nn.Module):
    """VGG19 trunk emitting the requested ReLU taps of an NHWC input in
    ImageNet-normalized space.  Every conv of the blocks up to the
    deepest tap exists (the flax tree has them all); the forward stops
    at the last tap, since nothing reads what follows it."""

    def __init__(self, layers: Sequence[str] = DEFAULT_LAYERS):
        super().__init__()
        self.layers = tuple(layers)
        deepest = max(int(name.split("_")[1]) for name in self.layers)
        self.plan = [p for p in VGG19_PLAN if p[0] <= deepest]
        ch = 3
        for block, n_convs, out in self.plan:
            for i in range(1, n_convs + 1):
                setattr(self, f"conv_{block}_{i}", Conv(ch, out, 3))
                ch = out

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        taps = {}
        for block, n_convs, _ in self.plan:
            if block > 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
            for i in range(1, n_convs + 1):
                x = torch.relu(getattr(self, f"conv_{block}_{i}")(x))
                tap = f"relu_{block}_{i}"
                if tap in self.layers:
                    taps[tap] = x
                if len(taps) == len(self.layers):
                    return taps
        return taps


class PerceptualLoss(nn.Module):
    """L1 perceptual criterion: ``loss(pred, target)`` over the taps of
    the VGG19 trunk, whose weights load from the flax tree ``params``."""

    def __init__(self, layers: Sequence[str], weights: Sequence[float],
                 params: dict):
        super().__init__()
        self.layers, self.weights = tuple(layers), tuple(weights)
        self.model = VGG19Features(layers)
        load_flax_params(self.model, params)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    def renormalize(self, x: torch.Tensor) -> torch.Tensor:
        """[-1, 1] → ImageNet-normalized."""
        return ((x + 1.0) / 2.0 - self.mean) / self.std

    def forward(self, pred: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
        f_pred = self.model(self.renormalize(pred))
        with torch.no_grad():
            f_tgt = self.model(self.renormalize(target))
        loss = 0.0
        for name, w in zip(self.layers, self.weights):
            loss = loss + w * (f_pred[name] - f_tgt[name]).abs().float().mean()
        return loss
