"""Renderer building blocks: convolutions, spectral norm, instance norm,
SPADE and the residual blocks of the generator, the mask net and the
discriminators.

Port of the JAX package's ``renderloom/models/layers.py``.  Module
forwards take and return NHWC tensors like the JAX modules.  The
convolutions run on the NCHW view of an NHWC tensor (``permute``, which
on the card is a channels_last tensor to cuDNN), so no copy is made on
the way in or out.

Spectral norm has two forms.  For serving it is folded into the weights
before they are loaded (:func:`renderloom_torch.convert.
fold_spectral_norm`), and ``SNConv`` is a plain convolution; its
``spectral`` flag only tells the random initializer to normalize the
weight.  For training, :func:`enable_spectral_norm` gives every spectral
``SNConv`` the power-iteration state of flax's ``nn.SpectralNorm``
(buffers ``sn_u`` (1, O) and ``sn_sigma``, the ``batch_stats`` entries
``conv/kernel/u`` and ``conv/kernel/sigma``), and each call divides the
kernel by σ from one power step; ``update_stats=True`` stores the new
``u`` and σ, as flax's ``update_stats`` does.

Every instance norm goes through :func:`renderloom_torch.ops.
norm_kernel.instance_norm`: the CUDA kernels for a tensor on the card,
their plain twins for a tensor on the CPU, with a gradient on either.

Compute dtype, as flax's ``dtype=``: parameters are float32 masters,
and a convolution casts its input and its kernel (and bias) to its
``compute_dtype`` (:func:`set_compute_dtype`; float32 by default),
accumulates in float32 and returns the compute dtype.  Under bfloat16
an instance norm takes the r3centered contract (:mod:`renderloom_torch.
ops.norm_kernel`): an affine norm returns float32, which the next
convolution casts back, a norm without affine returns bf16.  In
training the spectral norm runs in float32 on the float32 kernel, as
flax's ``SpectralNorm`` with float32 parameters does, and the
normalized kernel is cast at the convolution, so every gradient comes
back through the casts to the float32 parameters; the r3centered norm's
gradient is K2b's r3centered mode.  :func:`cast_weights_` casts the
convolutions' weights once for inference (the same numbers as the cast
at each call, half the bytes); the norms' γ, β stay float32.

Parameter names follow the flax param tree (``conv``, ``norm``,
``spade0``, ...), so :mod:`renderloom_torch.convert` loads a JAX tree by
name.

The layer variants of the JAX package's layer library that the shipped
configs do not use follow at the end: :class:`NonLocalBlock`,
:class:`PartialConv`, :class:`ApplyNoise`, :func:`hyper_conv2d`,
:func:`weight_demodulated_conv2d`, :class:`LayerNorm2d`,
:class:`HyperSpade`, :class:`PartialConvBlock`,
:class:`PartialResBlock` and :class:`PartialConv3d`; their instance
norms go through the same kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from renderloom_torch.ops import _build
from renderloom_torch.ops.image import resize_bilinear
from renderloom_torch.ops.norm_kernel import instance_norm
from renderloom_torch.ops.upconv_kernel import fold_weights, upconv

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
                weight: Optional[torch.Tensor] = None,
                upsample: bool = False) -> torch.Tensor:
        """``weight`` (default: the parameter) is the OIHW kernel to
        convolve with, e.g. a spectral-normalized one.  Input, kernel
        and bias are cast to ``compute_dtype`` (a no-op where they have
        it already).  ``upsample``: convolve :func:`upsample2x` of x; a
        float32 3×3 stride-1 call that wants no gradient runs both as
        one kernel (:mod:`renderloom_torch.ops.upconv_kernel`), every
        other call as ``upsample2x`` then ``F.conv2d``."""
        dt = self.compute_dtype
        w = self.weight if weight is None else weight
        b = None if self.bias is None else self.bias.to(dt)
        if upsample:
            wants_grad = torch.is_grad_enabled() and (
                x.requires_grad or w.requires_grad
                or (b is not None and b.requires_grad))
            if (dt == torch.float32 and w.shape[-2:] == (3, 3)
                    and self.stride == 1 and not wants_grad):
                return upconv(x.to(dt).contiguous(), self._folded(w, x), b,
                              w.shape[0])
            x = upsample2x(x)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), w.to(dt), b,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)

    def _folded(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """:func:`~renderloom_torch.ops.upconv_kernel.fold_weights` of
        ``w``, kept until ``w`` is another tensor or changes (its
        version or storage); folded afresh while ``torch.export``
        traces, and for an inference tensor, which keeps no version."""
        if _build.traced(x) or w.is_inference():
            return fold_weights(w.float())
        key = (w._version, w.data_ptr(), w.device)
        hit = self.__dict__.get("_fold")
        if hit is None or hit[0] is not w or hit[1] != key:
            hit = self._fold = (w, key, fold_weights(w.float()))
        return hit[2]


def same_pads(sizes, kernels, stride: int) -> list:
    """flax's ``padding="SAME"`` per spatial axis: the output is ⌈n / s⌉,
    the padding total = max((out − 1)·s + k − n, 0), ``total // 2``
    before and the rest after; a list of (before, after)."""
    pads = []
    for n, k in zip(sizes, kernels):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def conv_same(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None, stride: int = 1,
              groups: int = 1) -> torch.Tensor:
    """Convolution of a channels-last tensor (N, *spatial, C) with an
    (O, I, *kernel) weight, 2-D or 3-D, and flax's ``padding="SAME"``
    (:func:`same_pads`), on the channels-first view; channels-last out."""
    conv = F.conv2d if weight.dim() == 4 else F.conv3d
    xc = x.movedim(-1, 1)
    pads = same_pads(xc.shape[2:], weight.shape[2:], stride)
    if all(a == b for a, b in pads):
        y = conv(xc, weight, bias, stride, tuple(a for a, _ in pads), 1,
                 groups)
    else:               # F.pad takes the last axis first
        y = conv(F.pad(xc, [v for p in reversed(pads) for v in p]), weight,
                 bias, stride, 0, 1, groups)
    return y.movedim(1, -1)


class SameConv(Conv):
    """2-D convolution of NHWC tensors with flax's ``padding="SAME"`` at
    any stride and kernel (:func:`same_pads`).  At stride 2 on an even
    side that is asymmetric ((0, 1) for a 3×3 kernel, (2, 3) for a
    7×7), where :class:`Conv`'s symmetric ``(k − 1) // 2`` would shift
    the output by a pixel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return conv_same(x.to(dt), self.weight.to(dt), b, self.stride)


class SameConv3d(SameConv):
    """:class:`SameConv` over NDHWC volumes, a k×k×k kernel."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = True):
        super().__init__(in_ch, features, kernel, stride, use_bias)
        self.weight = nn.Parameter(
            torch.empty(features, in_ch, kernel, kernel, kernel))


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
                weight: Optional[torch.Tensor] = None,
                upsample: bool = False) -> torch.Tensor:
        """``weight``: a kernel :meth:`sn_weight` gave earlier (the
        checkpointed branch of :class:`SpadeResBlock` normalizes outside
        the region it recomputes).  ``upsample``: as :meth:`Conv.forward`."""
        if weight is None:
            weight = self.sn_weight(update_stats)
        return self.conv(x, weight, upsample=upsample)


def enable_spectral_norm(module: nn.Module) -> nn.Module:
    """Give every spectral :class:`SNConv` under ``module`` flax's
    power-iteration state: buffers ``sn_u`` (1, O) and ``sn_sigma``,
    zero here; :func:`renderloom_torch.convert.random_init_` or
    :func:`renderloom_torch.convert.load_flax_params` fills them.
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

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                upsample: bool = False) -> torch.Tensor:
        """``upsample``: upsample x first (:meth:`Conv.forward`)."""
        x = self.conv(x, update_stats, upsample=upsample)
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

    ``remat`` (the config's ``do_checkpoint``) recomputes the branch
    ``spade0 → conv0 → spade1 → conv1`` in the backward instead of
    keeping its activations, as the JAX block's ``nn.remat`` does.  The
    spectral-normalized kernels and the ``u`` update are computed before
    the checkpointed region, so the recompute neither updates ``u`` a
    second time nor convolves with other weights than the forward; K2
    sums in a fixed order, so its recompute gives the forward's bits in
    float32 and in bf16."""

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
        if self.remat and torch.is_grad_enabled():
            h = checkpoint(self._branch, x, cond, w0, w1,
                           use_reentrant=False, preserve_rng_state=False)
        else:
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


# ---------------------------------------------------------------------------
# layer variants the shipped configs do not use (the JAX package's
# layers.py:433-726, the reference's layer library)
# ---------------------------------------------------------------------------


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 max pool, stride 2, an odd edge dropped (flax's VALID)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class NonLocalBlock(nn.Module):
    """SAGAN self-attention: θ, φ, g 1×1 spectral convs without bias (C/8,
    C/8, C/2), a 2×2 max pool on φ and g, softmax attention over the
    pooled positions, a 1×1 out-projection back to C, and the residual
    ``x + γ·out`` with γ starting at 0."""

    def __init__(self, channels: int, spectral: bool = True):
        super().__init__()
        C = channels
        self.theta = SNConv(C, C // 8, 1, 1, spectral, use_bias=False)
        self.phi = SNConv(C, C // 8, 1, 1, spectral, use_bias=False)
        self.g = SNConv(C, C // 2, 1, 1, spectral, use_bias=False)
        self.out = SNConv(C // 2, C, 1, 1, spectral, use_bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        B, H, W, C = x.shape
        q = self.theta(x, update_stats).reshape(B, H * W, C // 8)
        k = _max_pool2(self.phi(x, update_stats)).reshape(B, -1, C // 8)
        v = _max_pool2(self.g(x, update_stats)).reshape(B, -1, C // 2)
        attn = torch.softmax(q @ k.transpose(1, 2), dim=-1)
        out = (attn @ v).reshape(B, H, W, C // 2)
        return x + self.gamma * self.out(out, update_stats)


class PartialConv(nn.Module):
    """Mask-normalized convolution (NVIDIA's partial conv), flax
    ``"SAME"`` padding.  ``forward(x, mask)`` → ``(out, new_mask)``
    with ``mask`` single-channel (B, H, W, 1): the conv sees ``x·mask``
    only, its output is scaled by k² / (valid pixels in the window),
    the bias is added only where a window saw a valid pixel and the
    output is 0 elsewhere, and the new mask is 1 where it did.  The
    valid count is a ones-kernel convolution of the mask with the same
    padding."""

    conv_type = SameConv

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = True):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.conv = self.conv_type(in_ch, features, kernel, stride,
                                   use_bias=False)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias \
            else None

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        raw = self.conv(x * mask)
        nd = raw.dim() - 2
        ones = raw.new_ones((1, 1) + (self.kernel,) * nd)
        valid = conv_same(mask.to(raw.dtype), ones, None, self.stride)
        seen = valid > 0
        out = raw * torch.where(
            seen, self.kernel ** nd / torch.clamp(valid, min=1e-8), 0.0)
        if self.bias is not None:
            out = torch.where(seen, out + self.bias, 0.0)
        return out, seen.to(mask.dtype)


class PartialConv3d(PartialConv):
    """:class:`PartialConv` over NDHWC volumes with a k×k×k kernel and
    the mask (B, D, H, W, 1); the scale is k³ / valid."""

    conv_type = SameConv3d


def noise_like(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Standard normal noise of shape (*x.shape[:-1], 1) from
    ``generator`` (on ``x``'s device), in ``x``'s dtype."""
    return torch.randn(x.shape[:-1] + (1,), generator=generator,
                       dtype=x.dtype, device=x.device)


class ApplyNoise(nn.Module):
    """Gaussian noise, one draw per pixel shared by the channels, times a
    learned scale that starts at 0 (the flax ``scale``, here ``weight``
    as every flax scale is).  Without a generator the input passes
    through."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None:
            return x
        return x + self.weight * noise_like(x, generator)


def hyper_conv2d(x: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 stride: int = 1) -> torch.Tensor:
    """Per-sample convolution with supplied weights: ``x`` (B, H, W, Cin),
    ``kernel`` (B, kh, kw, Cin, Cout) one HWIO filter bank per sample,
    ``bias`` (B, Cout) or None; flax ``"SAME"`` padding.  One grouped
    convolution (``groups=B``) over the samples stacked as channels."""
    B, H, W, ci = x.shape
    kh, kw, co = kernel.shape[1], kernel.shape[2], kernel.shape[4]
    xs = x.permute(1, 2, 0, 3).reshape(1, H, W, B * ci)
    w = kernel.permute(0, 4, 3, 1, 2).reshape(B * co, ci, kh, kw)
    y = conv_same(xs, w, None, stride, groups=B)
    y = y.reshape(y.shape[1], y.shape[2], B, co).permute(2, 0, 1, 3)
    return y if bias is None else y + bias[:, None, None, :]


def weight_demodulated_conv2d(x: torch.Tensor, kernel: torch.Tensor,
                              style: torch.Tensor, eps: float = 1e-8,
                              stride: int = 1) -> torch.Tensor:
    """StyleGAN2 weight demodulation: ``kernel`` (kh, kw, Cin, Cout)
    shared, ``style`` (B, Cin) per sample; w' = w·style, divided per
    output channel by √(Σw'² + eps), applied by :func:`hyper_conv2d`."""
    w = kernel[None] * style[:, None, None, :, None]
    denom = torch.sqrt((w * w).sum(dim=(1, 2, 3), keepdim=True) + eps)
    return hyper_conv2d(x, w / denom, stride=stride)


class LayerNorm2d(nn.Module):
    """Per-sample layer norm over all of (H, W, C) in float32, with the
    unbiased standard deviation: ``(x − mean) / (std + eps)``, then a
    per-channel affine whose γ starts ~ U[0, 1) and β at 0."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 affine: bool = True):
        super().__init__()
        self.eps = eps
        if affine:
            self.gamma = nn.Parameter(torch.rand(channels))
            self.beta = nn.Parameter(torch.zeros(channels))
        else:
            self.gamma = self.beta = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        flat = x.reshape(B, -1).float()
        shape = (B,) + (1,) * (x.dim() - 1)
        mean = flat.mean(dim=1).reshape(shape)
        std = flat.std(dim=1, correction=1).reshape(shape)
        out = (x - mean) / (std + self.eps)
        if self.gamma is not None:
            out = out * self.gamma + self.beta
        return out.to(x.dtype)


class HyperSpade(nn.Module):
    """SPADE over several conditions, the first of which may take
    per-sample affine weights: ``forward(x, cond_inputs, norm_weights)``
    normalizes x without affine (K2) and, for each condition i in turn,
    applies ``out·(1 + γ) + β`` with (γ, β) from a k×k conv of the
    condition (``affine_i``), resized to x's size by nearest pixels.  A
    condition may be a ``(condition, mask)`` pair: its (γ, β) are then
    gated by ``1 − mask``, the mask resized by JAX's antialiased linear
    resize.  ``norm_weights`` = (kernel (B, k, k, Cin, 2C), bias (B, 2C)
    or None) routes condition 0 through :func:`hyper_conv2d`.

    ``cond_channels[i]``: condition i's channel count, None for a
    condition that is always absent; ``hyper``: condition 0 always comes
    with ``norm_weights`` and has no conv of its own."""

    def __init__(self, features: int, cond_channels, kernel: int = 3,
                 hyper: bool = False):
        super().__init__()
        for i, c in enumerate(cond_channels):
            if c is not None and not (i == 0 and hyper):
                setattr(self, f"affine_{i}",
                        SameConv(c, 2 * features, kernel))

    def forward(self, x: torch.Tensor, cond_inputs,
                norm_weights=None) -> torch.Tensor:
        out = instance_norm(x.contiguous())
        H, W = x.shape[1:3]
        for i, ci in enumerate(cond_inputs):
            if ci is None:
                continue
            cond, mask = ci if isinstance(ci, (tuple, list)) else (ci, None)
            if cond.shape[1:3] != (H, W):
                cond = F.interpolate(cond.permute(0, 3, 1, 2), size=(H, W),
                                     mode="nearest-exact").permute(0, 2, 3, 1)
            if i == 0 and norm_weights is not None:
                affine = hyper_conv2d(cond, *norm_weights)
            else:
                affine = getattr(self, f"affine_{i}")(cond)
            gamma, beta = affine.chunk(2, dim=-1)
            if mask is not None:
                if mask.shape[1:3] != (H, W):
                    mask = resize_bilinear(mask, H, W)
                gamma, beta = gamma * (1.0 - mask), beta * (1.0 - mask)
            out = out * (1.0 + gamma) + beta
        return out


class PartialConvBlock(nn.Module):
    """'CNA' over a partial conv, threading the validity mask: partial
    conv → affine instance norm (or none) → leaky (or none)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, norm: str = "instance",
                 activation: str = "leaky"):
        super().__init__()
        if norm not in ("instance", "none"):
            raise ValueError(f"unknown norm {norm!r}")
        if activation not in ("leaky", "none"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.pconv = PartialConv(in_ch, features, kernel, stride)
        self.norm = InstanceNorm(features) if norm == "instance" else None

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        x, mask = self.pconv(x, mask)
        slope = LEAKY_SLOPE if self.activation == "leaky" else None
        if self.norm is not None:
            x = self.norm(x, slope)         # the leaky rides in the store
        elif slope is not None:
            x = leaky(x)
        return x, mask


class PartialResBlock(nn.Module):
    """Residual block 'CNACNA' of partial convs threading the mask through
    both; the shortcut is x, or a 1×1 partial conv of x under the input
    mask where the channel counts differ."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3):
        super().__init__()
        self.pconv0 = PartialConv(in_ch, features, kernel)
        self.norm0 = InstanceNorm(features)
        self.pconv1 = PartialConv(features, features, kernel)
        self.norm1 = InstanceNorm(features)
        self.shortcut = in_ch != features
        if self.shortcut:
            self.pconv_s = PartialConv(in_ch, features, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        h, m = self.pconv0(x, mask)
        h, m = self.pconv1(self.norm0(h, LEAKY_SLOPE), m)
        h = self.norm1(h, LEAKY_SLOPE)
        s = self.pconv_s(x, mask)[0] if self.shortcut else x
        return s + h, m
