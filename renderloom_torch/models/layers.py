"""Renderer building blocks, inference only: convolutions, instance norm,
SPADE and the residual blocks of the generator and the mask net.

Port of the JAX package's ``renderloom/models/layers.py``.  Module
forwards take and return NHWC tensors like the JAX modules.  The
convolutions run on the NCHW view of an NHWC tensor (``permute``, which
on the card is a channels_last tensor to cuDNN), so no copy is made on
the way in or out.

Spectral norm is folded into the weights before they are loaded
(:func:`renderloom_torch.convert.fold_spectral_norm`), so ``SNConv`` is a
plain convolution here; its ``spectral`` flag only tells the random
initializer to normalize the weight.  Every instance norm goes through
:func:`renderloom_torch.ops.norm_kernel.instance_norm`: the CUDA kernel
for a tensor on the card, its plain twin for a tensor on the CPU.

Parameter names follow the flax param tree (``conv``, ``norm``,
``spade0``, ...), so :mod:`renderloom_torch.convert` loads a JAX tree by
name.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from renderloom_torch.ops.norm_kernel import instance_norm

LEAKY_SLOPE = 0.2


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


class Conv(nn.Module):
    """2-D convolution of NHWC tensors with symmetric zero padding
    ``(k − 1) // 2``.  For the odd kernels of the shipped configs that is
    flax's ``"SAME"`` at stride 1, and at stride 2 it is torch's padding,
    which the JAX ``SNConv`` pads explicitly (layers.py:284-299)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = (kernel - 1) // 2
        self.weight = nn.Parameter(
            torch.empty(features, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class SNConv(nn.Module):
    """Conv whose weight was spectral-normalized when ``spectral``
    (folded at load time; the flax module keeps ``conv`` as its child)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, spectral: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.spectral = spectral
        self.conv = Conv(in_ch, features, kernel, stride, use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class InstanceNorm(nn.Module):
    """Affine instance norm; ``slope`` fuses the following leaky into the
    kernel's store."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor,
                slope: Optional[float] = None) -> torch.Tensor:
        return instance_norm(x.contiguous(), self.weight, self.bias, slope)


class ConvBlock(nn.Module):
    """'CNA': conv → (instance norm) → leaky | sigmoid | none."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, spectral: bool = True,
                 norm: str = "instance", activation: str = "leaky"):
        super().__init__()
        if norm not in ("instance", "none"):
            raise ValueError(f"unknown norm {norm!r}")
        if activation not in ("leaky", "sigmoid", "none"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.conv = SNConv(in_ch, features, kernel, stride, spectral)
        self.norm = InstanceNorm(features) if norm == "instance" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        slope = LEAKY_SLOPE if self.activation == "leaky" else None
        if self.norm is not None:
            x = self.norm(x, slope)         # the leaky rides in the store
        elif slope is not None:
            x = leaky(x)
        return torch.sigmoid(x) if self.activation == "sigmoid" else x


class Spade(nn.Module):
    """SPADE: param-free instance norm modulated by (γ, β) from one k×k
    conv of the condition map: ``norm(x)·(1 + γ) + β``."""

    def __init__(self, features: int, cond_ch: int, kernel: int = 1):
        super().__init__()
        self.affine = Conv(cond_ch, 2 * features, kernel)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        out = instance_norm(x.contiguous())
        H, W = x.shape[1:3]
        if cond.shape[1:3] != (H, W):
            # "nearest-exact" picks the pixels jax.image.resize picks;
            # torch's "nearest" takes the other ones on a ×2 downsample
            cond = F.interpolate(cond.permute(0, 3, 1, 2), size=(H, W),
                                 mode="nearest-exact").permute(0, 2, 3, 1)
        gamma, beta = self.affine(cond).chunk(2, dim=-1)
        return out * (1.0 + gamma) + beta


class SpadeResBlock(nn.Module):
    """Pre-act SPADE residual block 'NACNAC', hidden = min(in, out), and a
    SPADE → 1×1 conv shortcut when the channel counts differ."""

    def __init__(self, in_ch: int, features: int, cond_ch: int,
                 kernel: int = 3, spade_kernel: int = 1,
                 spectral: bool = True):
        super().__init__()
        hidden = min(in_ch, features)
        self.spade0 = Spade(in_ch, cond_ch, spade_kernel)
        self.conv0 = SNConv(in_ch, hidden, kernel, 1, spectral)
        self.spade1 = Spade(hidden, cond_ch, spade_kernel)
        self.conv1 = SNConv(hidden, features, kernel, 1, spectral)
        self.shortcut = in_ch != features
        if self.shortcut:
            self.spade_s = Spade(in_ch, cond_ch, spade_kernel)
            self.conv_s = SNConv(in_ch, features, 1, 1, spectral)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = self.conv0(leaky(self.spade0(x, cond)))
        h = self.conv1(leaky(self.spade1(h, cond)))
        s = self.conv_s(self.spade_s(x, cond)) if self.shortcut else x
        return s + h


class ResBlockCNACN(nn.Module):
    """Post-act residual block 'CNACN' with affine instance norms, and a
    conv → norm shortcut when the channel counts differ."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 spectral: bool = True):
        super().__init__()
        hidden = min(in_ch, features)
        self.conv0 = SNConv(in_ch, hidden, kernel, 1, spectral)
        self.norm0 = InstanceNorm(hidden)
        self.conv1 = SNConv(hidden, features, kernel, 1, spectral)
        self.norm1 = InstanceNorm(features)
        self.shortcut = in_ch != features
        if self.shortcut:
            self.conv_s = SNConv(in_ch, features, 1, 1, spectral)
            self.norm_s = InstanceNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm0(self.conv0(x), LEAKY_SLOPE)
        h = self.norm1(self.conv1(h))
        s = self.norm_s(self.conv_s(x)) if self.shortcut else x
        return s + h


def avg_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """3×3 average pool, stride 2, padding 1, count_include_pad=True."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1,
                     count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 upsample (for ×2 torch's "nearest" and jax agree)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                      mode="nearest")
    return y.permute(0, 2, 3, 1)
