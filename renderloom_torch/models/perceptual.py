"""VGG19 perceptual loss.

Port of the VGG19 path of the JAX package's
``renderloom/models/perceptual.py`` (``VGG19Features``,
``PerceptualLoss``): inputs in [-1, 1] are renormalized to ImageNet
statistics, run through the VGG19 trunk (3×3 convolutions with zero
padding 1, ReLU, 2×2 max pools that drop an odd edge, as flax's
``"SAME"`` and ``max_pool`` do), and compared with L1 at ``relu_1_1 …
relu_5_1`` with weights ``[1/32, 1/16, 1/8, 1/4, 1]``; the target's
features carry no gradient.

The repository ships no VGG19 weights and the port loads none yet: the
trunk runs with fixed random weights (seeded lecun-normal kernels, zero
biases, :func:`renderloom_torch.convert.random_init_`), the JAX
package's fallback, or with a flax tree loaded through
:func:`renderloom_torch.convert.load_flax_params` (the tests load the
one the JAX package drew).

``PerceptualLoss(..., compute_dtype)`` runs the trunk in that dtype, as
the flax module's ``dtype``: the renormalized input and the float32
kernels are cast to it at each convolution, and each tap's L1 is
reduced in float32.  :meth:`PerceptualLoss.lpips` is the JAX package's
uncalibrated LPIPS-style distance.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from renderloom_torch.models.layers import Conv, set_compute_dtype

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
    """L1 perceptual criterion: ``loss(pred, target)`` over the taps."""

    def __init__(self, layers: Sequence[str] = DEFAULT_LAYERS,
                 weights: Sequence[float] = DEFAULT_WEIGHTS,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weights = tuple(weights)
        self.model = set_compute_dtype(VGG19Features(layers), compute_dtype)
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
        for name, w in zip(self.model.layers, self.weights):
            loss = loss + w * (f_pred[name] - f_tgt[name]).abs().float().mean()
        return loss

    def lpips(self, pred: torch.Tensor,
              target: torch.Tensor) -> torch.Tensor:
        """LPIPS-style distance with uniform weights, one value per batch
        element: the squared difference of channel-unit-normalized
        features, averaged over H, W and C, summed over the taps and
        divided by their count."""
        f_pred = self.model(self.renormalize(pred))
        f_tgt = self.model(self.renormalize(target))
        dist = 0.0
        for name in self.model.layers:
            d = _unit_normalize(f_pred[name]) - _unit_normalize(f_tgt[name])
            dist = dist + (d * d).mean(dim=(1, 2, 3))
        return dist / len(self.model.layers)


def _unit_normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Each pixel's channel vector scaled to unit L2 norm (NHWC)."""
    norm = torch.sqrt((feat * feat).sum(dim=-1, keepdim=True))
    return feat / (norm + eps)
