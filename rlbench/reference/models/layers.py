"""Renderer building blocks in plain float32 PyTorch: convolutions,
spectral norm, instance norm, SPADE and the residual blocks of the
generator, the mask net and the discriminators.  Frozen copy of the
port's ``models/layers.py`` with every instance norm the plain one
(:mod:`rlbench.reference.ops.norm`) and without recomputation: the
config's ``do_checkpoint`` changes memory, not the function.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from rlbench.reference.ops.image import resize_bilinear
from rlbench.reference.ops.norm import instance_norm

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
        self.compute_dtype = torch.float32
        self.weight = nn.Parameter(
            torch.empty(features, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias \
            else None

    def forward(self, x: torch.Tensor,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``weight`` (default: the parameter) is the OIHW kernel to
        convolve with, e.g. a spectral-normalized one.  Input, kernel
        and bias are cast to ``compute_dtype`` (a no-op where they have
        it already)."""
        dt = self.compute_dtype
        w = self.weight if weight is None else weight
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), w.to(dt), b,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype,
                      types: tuple = (Conv,)) -> nn.Module:
    """Every module of ``types`` under ``module`` computes in ``dtype``."""
    for m in module.modules():
        if isinstance(m, types):
            m.compute_dtype = dtype
    return module


def cast_weights_(module: nn.Module, types: tuple = (Conv,)) -> nn.Module:
    """Cast the weight and bias of each module of ``types`` under
    ``module`` to its compute dtype, once, for inference; everything
    else (the norms' γ, β) stays as it is."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, types):
                for name in ("weight", "bias"):
                    p = getattr(m, name)
                    if p is not None:
                        p.data = p.data.to(m.compute_dtype)
    return module


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """flax's ``_l2_normalize``: ``x · rsqrt(Σx² + eps)``."""
    return x * torch.rsqrt((x * x).sum() + eps)


class SNConv(nn.Module):
    """Conv with optional spectral weight normalization (the flax module
    keeps ``conv`` as its child).  Without power-iteration state (see
    :func:`enable_spectral_norm`) it is a plain convolution whose weight
    was folded at load time."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, spectral: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.spectral = spectral
        self.conv = Conv(in_ch, features, kernel, stride, use_bias)

    def sn_weight(self, update_stats: bool = False) -> torch.Tensor:
        """The kernel the convolution uses: with power-iteration state,
        flax's ``SpectralNorm`` step on the HWIO kernel reshaped to
        (H·W·I, O): ``v = l2n(u Wᵀ)``, ``u' = l2n(v W)`` (both without
        gradient), ``σ = v W u'ᵀ`` (with gradient into W), the kernel
        over σ (σ = 0 leaves it as it is).  ``update_stats`` stores u'
        and σ."""
        w = self.conv.weight
        if not hasattr(self, "sn_u"):
            return w
        mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
        with torch.no_grad():
            v = _l2_normalize(self.sn_u @ mat.T)
            u = _l2_normalize(v @ mat)
        sigma = (v @ mat @ u.T)[0, 0]
        if update_stats:
            with torch.no_grad():
                self.sn_u.copy_(u)
                self.sn_sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``weight``: a kernel :meth:`sn_weight` gave earlier (the
        checkpointed branch of :class:`SpadeResBlock` normalizes outside
        the region it recomputes)."""
        if weight is None:
            weight = self.sn_weight(update_stats)
        return self.conv(x, weight)


def enable_spectral_norm(module: nn.Module) -> nn.Module:
    """Give every spectral :class:`SNConv` under ``module`` flax's
    power-iteration state: buffers ``sn_u`` (1, O) and ``sn_sigma``,
    zero here; :func:`rlbench.reference.convert.random_init_` or
    :func:`rlbench.reference.convert.load_flax_params` fills them.
    Training modules call this once after construction; serving modules
    never do."""
    for m in module.modules():
        if isinstance(m, SNConv) and m.spectral and not hasattr(m, "sn_u"):
            w = m.conv.weight
            m.register_buffer("sn_u", w.new_zeros((1, w.shape[0])))
            m.register_buffer("sn_sigma", w.new_zeros(()))
    return module


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

    def forward(self, x: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        x = self.conv(x, update_stats)
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
    SPADE → 1×1 conv shortcut when the channel counts differ.

    ``remat`` (the config's ``do_checkpoint``) is kept for the
    constructor's signature; the reference recomputes nothing.  The
    spectral-normalized kernels and the ``u`` update are computed once
    per call, before the branch."""

    def __init__(self, in_ch: int, features: int, cond_ch: int,
                 kernel: int = 3, spade_kernel: int = 1,
                 spectral: bool = True, remat: bool = False):
        super().__init__()
        hidden = min(in_ch, features)
        self.remat = remat
        self.spade0 = Spade(in_ch, cond_ch, spade_kernel)
        self.conv0 = SNConv(in_ch, hidden, kernel, 1, spectral)
        self.spade1 = Spade(hidden, cond_ch, spade_kernel)
        self.conv1 = SNConv(hidden, features, kernel, 1, spectral)
        self.shortcut = in_ch != features
        if self.shortcut:
            self.spade_s = Spade(in_ch, cond_ch, spade_kernel)
            self.conv_s = SNConv(in_ch, features, 1, 1, spectral)

    def _branch(self, x, cond, w0, w1):
        h = self.conv0(leaky(self.spade0(x, cond)), weight=w0)
        return self.conv1(leaky(self.spade1(h, cond)), weight=w1)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        w0 = self.conv0.sn_weight(update_stats)
        w1 = self.conv1.sn_weight(update_stats)
        h = self._branch(x, cond, w0, w1)
        s = (self.conv_s(self.spade_s(x, cond), update_stats)
             if self.shortcut else x)
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

    def forward(self, x: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        h = self.norm0(self.conv0(x, update_stats), LEAKY_SLOPE)
        h = self.norm1(self.conv1(h, update_stats))
        s = (self.norm_s(self.conv_s(x, update_stats)) if self.shortcut
             else x)
        return s + h


def avg_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """3×3 average pool, stride 2, padding 1, count_include_pad=True.

    The pool runs on a contiguous NCHW copy: on the card, torch 2.11's
    ``avg_pool2d`` backward for a channels_last input (the NCHW view of
    an NHWC tensor) returns wrong gradients (errors the size of the
    gradient itself), while its forward and the contiguous path agree
    with the CPU."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), 3, stride=2,
                     padding=1, count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 upsample (for ×2 torch's "nearest" and jax agree)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                      mode="nearest")
    return y.permute(0, 2, 3, 1)
