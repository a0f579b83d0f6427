"""Experimental motion discriminator (off by default, like the
reference: ``use_dis: False``; no training path uses it).

Port of the JAX package's ``renderloom/models/motion_discriminator.py``
(the reference's ``Discriminator_2D``): the (B, C, L) pose matrix is a
1×L image with C channels (NHWC (B, 1, L, C)), run through 3×3
convolutions with leaky ReLUs and (1, 3) max pools of stride (1, 2),
ending in a patch-GAN map or a globally pooled logit.  Module names
follow the flax tree.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from renderloom_torch.models.layers import Conv, leaky


class MotionDiscriminator(nn.Module):
    def __init__(self, channels: Sequence[int] = (38, 64, 96, 128),
                 use_patch_gan: bool = False, use_sigmoid: bool = False):
        super().__init__()
        ch = tuple(channels)
        self.channels = ch
        self.use_patch_gan = use_patch_gan
        self.use_sigmoid = use_sigmoid
        self.conv_in = Conv(ch[0], ch[1], 3)
        for i in range(1, len(ch) - 1):
            setattr(self, f"conv_{i}a", Conv(ch[i], ch[i + 1], 3))
            setattr(self, f"conv_{i}b", Conv(ch[i + 1], ch[i + 1], 3))
        self.head = Conv(ch[-1], 1, 1, use_bias=False)

    def forward(self, motion: torch.Tensor) -> torch.Tensor:
        """(B, C, L) → (B, 1, L', 1) logits (patch-GAN) or (B, 1, 1, 1)."""
        B, C, L = motion.shape
        x = leaky(self.conv_in(motion.transpose(1, 2).reshape(B, 1, L, C)))
        for i in range(1, len(self.channels) - 1):
            x = leaky(getattr(self, f"conv_{i}a")(x))
            x = leaky(getattr(self, f"conv_{i}b")(x))
            x = F.max_pool2d(x.permute(0, 3, 1, 2), (1, 3), (1, 2),
                             (0, 1)).permute(0, 2, 3, 1)
        if not self.use_patch_gan:
            x = x.mean(dim=(1, 2), keepdim=True)
        x = self.head(x)
        return torch.sigmoid(x) if self.use_sigmoid else x
