"""Alternate perceptual-loss backbones: VGG16, AlexNet, ResNet-50,
Inception-v3, robust ResNet-50 and VGG-Face.

Port of the JAX package's ``renderloom/models/backbones.py``.  Each
module takes an NHWC input in ImageNet-normalized space and returns a
dict of the requested taps under the JAX module's names; it holds the
layers up to its deepest requested tap (the flax tree has exactly
those) and stops there.  The layers:

* convolutions with the JAX module's explicit padding (flax ``"SAME"``
  at stride 1 is the symmetric ``(k − 1) // 2``; Inception's 1×7 and
  7×1 kernels pad one axis only; its stride-2 convolutions and AlexNet's
  pools are VALID);
* batch norm frozen to its running statistics (:class:`FrozenBatchNorm`,
  flax's ``use_running_average=True``: ``(x − mean)·γ·rsqrt(var + eps)
  + β``, eps 1e-5 in ResNet and 1e-3 in Inception); nothing updates the
  statistics;
* ResNet's stem max-pool pads with −inf (torch's ``MaxPool2d(3, 2, 1)``);
  Inception's pool branches average without counting the padding
  (``count_include_pad=False``, as the JAX package does, where
  torchvision's Inception3 counts it); Inception's ``pool_3`` is a mean
  over the image that keeps its axes;
* VGG-Face pools adaptively to 7×7 (torch's window rule, which the JAX
  package copies) and flattens in NCHW order before ``fc6`` (25088 ×
  4096), as the torch weights expect.

The loaders (``load_*_state``) turn a torchvision-schema state dict of
numpy arrays into the flax-layout numpy tree the JAX loaders return
(``params``, plus ``batch_stats`` where there is batch norm), which
:func:`load_variables` carries into a module, so the tests load JAX's
initialised variables and torchvision files by one path.
:func:`build_backbone` reads a ``.pth`` with ``torch.load(weights_only=
True)`` (unwrapping a ``model`` envelope) or an ``.npz``, and without
weights draws seeded random ones (:func:`renderloom_torch.convert.
random_init_`).  The backbones compute in float32: in the JAX package
they take no compute dtype, and a bf16 input promotes to float32 at the
renormalization.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from renderloom_torch.convert import (random_init_, state_dict_from_flax,
                                      state_dict_from_flax_stats)
from renderloom_torch.models.layers import Conv

# (block index, convs in block, channels)
VGG16_PLAN = [(1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512),
              (5, 3, 512)]

VGG16_CONV_IDX = {
    "conv_1_1": 0, "conv_1_2": 2,
    "conv_2_1": 5, "conv_2_2": 7,
    "conv_3_1": 10, "conv_3_2": 12, "conv_3_3": 14,
    "conv_4_1": 17, "conv_4_2": 19, "conv_4_3": 21,
    "conv_5_1": 24, "conv_5_2": 26, "conv_5_3": 28,
}


class PadConv(Conv):
    """2-D convolution of NHWC tensors with a (kh, kw) kernel and explicit
    symmetric padding (ph, pw)."""

    def __init__(self, in_ch: int, features: int, kernel, stride: int = 1,
                 padding=(0, 0), use_bias: bool = True):
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        super().__init__(in_ch, features, 1, stride, use_bias)
        self.weight = nn.Parameter(torch.empty(features, in_ch, kh, kw))
        self.padding = tuple(padding)


class FrozenBatchNorm(nn.Module):
    """Batch norm at its running statistics, flax's
    ``BatchNorm(use_running_average=True)``: ``(x − mean)·(γ·rsqrt(var +
    eps)) + β`` over the last axis."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


def _nchw(fn, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """``fn`` (a pool) on the NCHW view of NHWC ``x``."""
    return fn(x.permute(0, 3, 1, 2), *args, **kwargs).permute(0, 2, 3, 1)


def _deepest(layers: Sequence[str]) -> int:
    return max(int(n.split("_")[1]) for n in layers)


class _Taps(nn.Module):
    """A trunk whose forward collects ``self.layers`` and stops after the
    last of them."""

    def __init__(self, layers: Sequence[str]):
        super().__init__()
        self.layers = tuple(layers)


class VGG16Features(_Taps):
    """vgg16.features trunk emitting ReLU taps ``relu_B_N``."""

    def __init__(self, layers: Sequence[str] = ("relu_4_1",)):
        super().__init__(layers)
        deepest = _deepest(self.layers)
        self.plan = [p for p in VGG16_PLAN if p[0] <= deepest]
        ch = 3
        for block, n_convs, out in self.plan:
            for i in range(1, n_convs + 1):
                setattr(self, f"conv_{block}_{i}", Conv(ch, out, 3))
                ch = out

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        taps = {}
        for block, n_convs, _ in self.plan:
            if block > 1:
                x = _nchw(F.max_pool2d, x, 2)
            for i in range(1, n_convs + 1):
                x = torch.relu(getattr(self, f"conv_{block}_{i}")(x))
                if f"relu_{block}_{i}" in self.layers:
                    taps[f"relu_{block}_{i}"] = x
                if len(taps) == len(self.layers):
                    return taps
        return taps


# alexnet.features: (features-index, out_ch, kernel, stride, pad,
# max-pool after)
_ALEXNET_SPECS = [
    (0, 64, 11, 4, 2, True),
    (3, 192, 5, 1, 2, True),
    (6, 384, 3, 1, 1, False),
    (8, 256, 3, 1, 1, False),
    (10, 256, 3, 1, 1, False),
]


class AlexNetFeatures(_Taps):
    """alexnet.features trunk with ``conv_N`` / ``relu_N`` taps; the
    3×3 stride-2 max pools follow convs 1, 2 (and 5, which no tap
    reads), each only when a deeper conv is wanted."""

    def __init__(self, layers: Sequence[str] = ("relu_5",)):
        super().__init__(layers)
        self.deepest = _deepest(self.layers)
        ch = 3
        for n, (_, out, k, s, p, _pool) in enumerate(
                _ALEXNET_SPECS[:self.deepest], 1):
            setattr(self, f"conv_{n}", PadConv(ch, out, k, s, (p, p)))
            ch = out

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        taps = {}
        for n, spec in enumerate(_ALEXNET_SPECS[:self.deepest], 1):
            x = getattr(self, f"conv_{n}")(x)
            if f"conv_{n}" in self.layers:
                taps[f"conv_{n}"] = x
            x = torch.relu(x)
            if f"relu_{n}" in self.layers:
                taps[f"relu_{n}"] = x
            if len(taps) == len(self.layers):
                return taps
            if spec[5] and n < self.deepest:
                x = _nchw(F.max_pool2d, x, 3, 2)
        return taps


class _Bottleneck(nn.Module):
    """torchvision's resnet Bottleneck (1×1 → 3×3 → 1×1, frozen batch
    norms), with a 1×1 projection of the shortcut in a stage's first
    block."""

    def __init__(self, in_ch: int, mid: int, stride: int = 1,
                 project: bool = False):
        super().__init__()
        bn = lambda c: FrozenBatchNorm(c, 1e-5)
        self.conv1 = PadConv(in_ch, mid, 1, use_bias=False)
        self.bn1 = bn(mid)
        self.conv2 = PadConv(mid, mid, 3, stride, (1, 1), use_bias=False)
        self.bn2 = bn(mid)
        self.conv3 = PadConv(mid, mid * 4, 1, use_bias=False)
        self.bn3 = bn(mid * 4)
        self.project = project
        if project:
            self.down_conv = PadConv(in_ch, mid * 4, 1, stride,
                                     use_bias=False)
            self.down_bn = bn(mid * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        s = self.down_bn(self.down_conv(x)) if self.project else x
        return torch.relu(s + h)


_RESNET50_STAGES = [(64, 3), (128, 4), (256, 6), (512, 3)]


class ResNet50Features(_Taps):
    """torchvision resnet50 trunk with ``layer_1`` … ``layer_4`` taps."""

    def __init__(self, layers: Sequence[str] = ("layer_4",)):
        super().__init__(layers)
        self.conv1 = PadConv(3, 64, 7, 2, (3, 3), use_bias=False)
        self.bn1 = FrozenBatchNorm(64, 1e-5)
        self.stages = []
        ch = 64
        for s, (mid, blocks) in enumerate(
                _RESNET50_STAGES[:_deepest(self.layers)], 1):
            names = []
            for b in range(blocks):
                setattr(self, f"layer{s}_{b}", _Bottleneck(
                    ch, mid, 2 if (b == 0 and s > 1) else 1, b == 0))
                names.append(f"layer{s}_{b}")
                ch = mid * 4
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        taps = {}
        x = torch.relu(self.bn1(self.conv1(x)))
        x = _nchw(F.max_pool2d, x, 3, 2, 1)      # −inf padding
        for s, names in enumerate(self.stages, 1):
            for name in names:
                x = getattr(self, name)(x)
            if f"layer_{s}" in self.layers:
                taps[f"layer_{s}"] = x
        return taps


# ---------------------------------------------------------------------------
# inception_v3: the torchvision Inception3 submodules chained, tapping the
# two stem max pools, Mixed_6e and the final average
# ---------------------------------------------------------------------------


class _BasicConv(nn.Module):
    """torchvision's BasicConv2d: conv (no bias) → batch norm (eps 1e-3)
    → ReLU."""

    def __init__(self, in_ch: int, features: int, kernel, stride: int = 1,
                 padding=(0, 0)):
        super().__init__()
        self.conv = PadConv(in_ch, features, kernel, stride, padding,
                            use_bias=False)
        self.bn = FrozenBatchNorm(features, 1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


def _maxpool3s2(x: torch.Tensor) -> torch.Tensor:
    return _nchw(F.max_pool2d, x, 3, 2)


def _avgpool3s1p1(x: torch.Tensor) -> torch.Tensor:
    """3×3 average, stride 1, padding 1, the padding not counted.  On a
    contiguous NCHW copy: torch's ``avg_pool2d`` backward for a
    channels_last input is wrong on the card (see
    :func:`renderloom_torch.models.layers.avg_pool_3x3s2`)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), 3, 1, 1,
                     count_include_pad=False)
    return y.permute(0, 2, 3, 1)


_P17, _P71 = (0, 3), (3, 0)


class _InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = _BasicConv(in_ch, 64, 1)
        self.branch5x5_1 = _BasicConv(in_ch, 48, 1)
        self.branch5x5_2 = _BasicConv(48, 64, 5, padding=(2, 2))
        self.branch3x3dbl_1 = _BasicConv(in_ch, 64, 1)
        self.branch3x3dbl_2 = _BasicConv(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = _BasicConv(96, 96, 3, padding=(1, 1))
        self.branch_pool = _BasicConv(in_ch, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avgpool3s1p1(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=-1)


class _InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = _BasicConv(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = _BasicConv(in_ch, 64, 1)
        self.branch3x3dbl_2 = _BasicConv(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = _BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool3s2(x)], dim=-1)


class _InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = _BasicConv(in_ch, 192, 1)
        self.branch7x7_1 = _BasicConv(in_ch, c7, 1)
        self.branch7x7_2 = _BasicConv(c7, c7, (1, 7), padding=_P17)
        self.branch7x7_3 = _BasicConv(c7, 192, (7, 1), padding=_P71)
        self.branch7x7dbl_1 = _BasicConv(in_ch, c7, 1)
        self.branch7x7dbl_2 = _BasicConv(c7, c7, (7, 1), padding=_P71)
        self.branch7x7dbl_3 = _BasicConv(c7, c7, (1, 7), padding=_P17)
        self.branch7x7dbl_4 = _BasicConv(c7, c7, (7, 1), padding=_P71)
        self.branch7x7dbl_5 = _BasicConv(c7, 192, (1, 7), padding=_P17)
        self.branch_pool = _BasicConv(in_ch, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avgpool3s1p1(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=-1)


class _InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = _BasicConv(in_ch, 192, 1)
        self.branch3x3_2 = _BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = _BasicConv(in_ch, 192, 1)
        self.branch7x7x3_2 = _BasicConv(192, 192, (1, 7), padding=_P17)
        self.branch7x7x3_3 = _BasicConv(192, 192, (7, 1), padding=_P71)
        self.branch7x7x3_4 = _BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _maxpool3s2(x)], dim=-1)


class _InceptionE(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch1x1 = _BasicConv(in_ch, 320, 1)
        self.branch3x3_1 = _BasicConv(in_ch, 384, 1)
        self.branch3x3_2a = _BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = _BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = _BasicConv(in_ch, 448, 1)
        self.branch3x3dbl_2 = _BasicConv(448, 384, 3, padding=(1, 1))
        self.branch3x3dbl_3a = _BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = _BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = _BasicConv(in_ch, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], -1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       -1)
        bp = self.branch_pool(_avgpool3s1p1(x))
        return torch.cat([self.branch1x1(x), b3, bd, bp], dim=-1)


INCEPTION_TAPS = ("pool_1", "pool_2", "mixed_6e", "pool_3")


class InceptionV3Features(_Taps):
    """Inception-v3 trunk with the taps ``pool_1 / pool_2 / mixed_6e /
    pool_3``, on an input in ImageNet-normalized space (Inception3's own
    ``transform_input`` is not applied)."""

    def __init__(self, layers: Sequence[str] = ("pool_3",)):
        super().__init__(layers)
        self.deepest = max(INCEPTION_TAPS.index(n) for n in self.layers)
        self.Conv2d_1a_3x3 = _BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = _BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = _BasicConv(32, 64, 3, padding=(1, 1))
        if self.deepest >= 1:
            self.Conv2d_3b_1x1 = _BasicConv(64, 80, 1)
            self.Conv2d_4a_3x3 = _BasicConv(80, 192, 3)
        if self.deepest >= 2:
            self.Mixed_5b = _InceptionA(192, 32)
            self.Mixed_5c = _InceptionA(256, 64)
            self.Mixed_5d = _InceptionA(288, 64)
            self.Mixed_6a = _InceptionB(288)
            self.Mixed_6b = _InceptionC(768, 128)
            self.Mixed_6c = _InceptionC(768, 160)
            self.Mixed_6d = _InceptionC(768, 160)
            self.Mixed_6e = _InceptionC(768, 192)
        if self.deepest >= 3:
            self.Mixed_7a = _InceptionD(768)
            self.Mixed_7b = _InceptionE(1280)
            self.Mixed_7c = _InceptionE(2048)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        taps = {}
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool3s2(x)
        if "pool_1" in self.layers:
            taps["pool_1"] = x
        if self.deepest == 0:
            return taps
        x = _maxpool3s2(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        if "pool_2" in self.layers:
            taps["pool_2"] = x
        if self.deepest == 1:
            return taps
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        if "mixed_6e" in self.layers:
            taps["mixed_6e"] = x
        if self.deepest == 2:
            return taps
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        taps["pool_3"] = x.mean(dim=(1, 2), keepdim=True)
        return taps


# ---------------------------------------------------------------------------
# vgg_face_dag: the vgg16 trunk, a 7×7 adaptive average pool and the
# classifier's fc / ReLU stages
# ---------------------------------------------------------------------------

VGG_FACE_FC = (("fc6", 25088, 4096), ("fc7", 4096, 4096),
               ("fc8", 4096, 2622))


class VGGFaceFeatures(_Taps):
    """VGG-Face: the vgg16 conv trunk → adaptive 7×7 average pool →
    fc6 / fc7 / fc8, with the taps ``avgpool / fc6 / relu_6 / fc7 /
    relu_7 / fc8``.  The flatten before fc6 is NCHW-ordered."""

    def __init__(self, layers: Sequence[str] = ("fc8",)):
        super().__init__(layers)
        ch = 3
        for block, n_convs, out in VGG16_PLAN:
            for i in range(1, n_convs + 1):
                setattr(self, f"conv_{block}_{i}", Conv(ch, out, 3))
                ch = out
        for name, n_in, n_out in VGG_FACE_FC:
            setattr(self, name, nn.Linear(n_in, n_out))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        taps = {}
        for block, n_convs, _ in VGG16_PLAN:
            for i in range(1, n_convs + 1):
                x = torch.relu(getattr(self, f"conv_{block}_{i}")(x))
            x = _nchw(F.max_pool2d, x, 2)
        x = _nchw(F.adaptive_avg_pool2d, x, 7)
        if "avgpool" in self.layers:
            taps["avgpool"] = x
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        for name, _, _ in VGG_FACE_FC:
            if len(taps) == len(self.layers):
                return taps
            x = getattr(self, name)(x)
            if name in self.layers:
                taps[name] = x
            if name != "fc8":
                x = torch.relu(x)
                if f"relu_{name[-1]}" in self.layers:
                    taps[f"relu_{name[-1]}"] = x
        return taps


# ---------------------------------------------------------------------------
# torchvision state dicts → flax-layout numpy trees (the JAX loaders')
# ---------------------------------------------------------------------------


def _conv(w) -> np.ndarray:   # OIHW → HWIO
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _copy(v) -> np.ndarray:
    return np.array(v, copy=True)


def _indexed_convs(state: Mapping, names: Mapping[str, int],
                   prefixes) -> dict:
    """{flax name: {kernel, bias}} for each conv of ``names`` (flax name
    → Sequential index) whose weight ``state`` holds under one of
    ``prefixes(idx)``."""
    params = {}
    for name, idx in names.items():
        for pre in prefixes(idx):
            if f"{pre}weight" in state:
                params[name] = {"kernel": _conv(state[f"{pre}weight"]),
                                "bias": _copy(state[f"{pre}bias"])}
                break
    return params


def load_vgg16_state(state: Mapping[str, np.ndarray]) -> Dict:
    params = _indexed_convs(state, VGG16_CONV_IDX,
                            lambda i: (f"features.{i}.", f"{i}."))
    if len(params) != len(VGG16_CONV_IDX):
        raise ValueError("not a torchvision vgg16 state dict")
    return {"params": params}


def load_alexnet_state(state: Mapping[str, np.ndarray]) -> Dict:
    names = {f"conv_{n}": spec[0]
             for n, spec in enumerate(_ALEXNET_SPECS, 1)}
    params = _indexed_convs(state, names,
                            lambda i: (f"features.{i}.", f"{i}."))
    if len(params) != len(_ALEXNET_SPECS):
        raise ValueError("not a torchvision alexnet state dict")
    return {"params": params}


def _node(tree: dict, path) -> dict:
    for k in path:
        tree = tree.setdefault(k, {})
    return tree


def load_resnet50_state(state: Mapping[str, np.ndarray]) -> Dict:
    params: Dict = {}
    stats: Dict = {}

    def put_conv(dst, src):
        _node(params, dst[:-1])[dst[-1]] = {
            "kernel": _conv(state[f"{src}.weight"])}

    def put_bn(dst, src):
        _node(params, dst[:-1])[dst[-1]] = {
            "scale": _copy(state[f"{src}.weight"]),
            "bias": _copy(state[f"{src}.bias"])}
        _node(stats, dst[:-1])[dst[-1]] = {
            "mean": _copy(state[f"{src}.running_mean"]),
            "var": _copy(state[f"{src}.running_var"])}

    put_conv(["conv1"], "conv1")
    put_bn(["bn1"], "bn1")
    for s, (_mid, blocks) in enumerate(_RESNET50_STAGES, 1):
        for b in range(blocks):
            src, dst = f"layer{s}.{b}", f"layer{s}_{b}"
            for i in (1, 2, 3):
                put_conv([dst, f"conv{i}"], f"{src}.conv{i}")
                put_bn([dst, f"bn{i}"], f"{src}.bn{i}")
            if f"{src}.downsample.0.weight" in state:
                put_conv([dst, "down_conv"], f"{src}.downsample.0")
                put_bn([dst, "down_bn"], f"{src}.downsample.1")
    return {"params": params, "batch_stats": stats}


def load_inception_state(state: Mapping[str, np.ndarray]) -> Dict:
    """torchvision ``inception_v3`` state dict (``<block>.conv.weight``,
    ``<block>.bn.{weight,bias,running_mean,running_var}``, dotted branch
    paths inside the Mixed blocks; ``fc`` and ``AuxLogits`` skipped)."""
    params: Dict = {}
    stats: Dict = {}
    n_convs = 0
    for k, v in state.items():
        parts = k.split(".")
        if len(parts) < 3 or parts[0].startswith(("fc", "AuxLogits")):
            continue
        *path, mod, leaf = parts
        if mod == "conv" and leaf == "weight":
            _node(params, path)["conv"] = {"kernel": _conv(v)}
            n_convs += 1
        elif mod == "bn" and leaf in ("weight", "bias"):
            _node(params, path).setdefault("bn", {})[
                "scale" if leaf == "weight" else "bias"] = _copy(v)
        elif mod == "bn" and leaf in ("running_mean", "running_var"):
            _node(stats, path).setdefault("bn", {})[
                "mean" if leaf == "running_mean" else "var"] = _copy(v)
    if n_convs < 94:   # inception_v3 has 94 convs outside AuxLogits / fc
        raise ValueError(
            f"not a torchvision inception_v3 state dict ({n_convs} convs)")
    return {"params": params, "batch_stats": stats}


def load_robust_resnet50_state(state: Mapping[str, np.ndarray]) -> Dict:
    """Robust-ResNet-50 checkpoints (``module.model.``,
    ``module.attacker.model.`` or ``model.`` prefixed resnet50 keys; the
    first key of a name wins) and plain resnet50 dicts."""
    stripped = {}
    for k, v in state.items():
        for pre in ("module.model.", "module.attacker.model.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
                break
        stripped.setdefault(k, v)
    return load_resnet50_state(stripped)


def load_vgg_face_state(state: Mapping[str, np.ndarray]) -> Dict:
    """VGG-Face weights in Oxford's naming (``conv1_1.weight`` …
    ``fc8.weight``, fc6 possibly a 4-D 7×7 conv) or the
    torchvision-remapped schema (``features.N.*`` +
    ``classifier.{0,3,6}.*``)."""
    params: Dict = {}
    for block, n_convs, _ in VGG16_PLAN:
        for i in range(1, n_convs + 1):
            mine = f"conv_{block}_{i}"
            params.update(_indexed_convs(
                state, {mine: VGG16_CONV_IDX[mine]},
                lambda idx: (f"conv{block}_{i}.", f"features.{idx}.")))
    for fc, idx in (("fc6", 0), ("fc7", 3), ("fc8", 6)):
        for pre in (f"{fc}.", f"classifier.{idx}."):
            if f"{pre}weight" in state:
                w = np.asarray(state[f"{pre}weight"])
                if w.ndim == 4:        # Oxford ships fc6 as a 7×7 conv
                    w = w.reshape(w.shape[0], -1)
                # (in, out), in torch's NCHW-flatten column order
                params[fc] = {"kernel": np.ascontiguousarray(w.T),
                              "bias": _copy(state[f"{pre}bias"])}
                break
    if len(params) != len(VGG16_CONV_IDX) + 3:
        raise ValueError(
            f"not a VGG-Face state dict ({len(params)} layers mapped)")
    return {"params": params}


BACKBONES = {
    "vgg16": (VGG16Features, load_vgg16_state,
              ("relu_1_1", "relu_2_1", "relu_3_1", "relu_4_1",
               "relu_5_1")),
    "alexnet": (AlexNetFeatures, load_alexnet_state,
                ("relu_1", "relu_2", "relu_3", "relu_4", "relu_5")),
    "resnet50": (ResNet50Features, load_resnet50_state,
                 ("layer_1", "layer_2", "layer_3", "layer_4")),
    "inception_v3": (InceptionV3Features, load_inception_state,
                     INCEPTION_TAPS),
    "robust_resnet50": (ResNet50Features, load_robust_resnet50_state,
                        ("layer_1", "layer_2", "layer_3", "layer_4")),
    "vgg_face_dag": (VGGFaceFeatures, load_vgg_face_state,
                     ("avgpool", "fc6", "relu_6", "fc7", "relu_7",
                      "fc8")),
}


def load_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load a flax-layout tree (``params`` and, with batch norm,
    ``batch_stats``) into ``model``: the leaves of the layers the model
    holds (a trunk cut at a shallower tap holds fewer than a full state
    dict), each of them required."""
    state = state_dict_from_flax(variables["params"])
    state.update(state_dict_from_flax_stats(variables.get("batch_stats",
                                                          {})))
    own = model.state_dict().keys()
    model.load_state_dict({k: v for k, v in state.items() if k in own},
                          strict=True)
    return model


def read_state(path: str) -> Dict[str, np.ndarray]:
    """A state dict of numpy arrays from an ``.npz``, or from a ``.pth``
    read with ``torch.load(weights_only=True)``, unwrapping a ``model``
    envelope (robust ResNet's ``ImageNet.pt``)."""
    if path.endswith(".npz"):
        with np.load(path) as raw:
            return {k: raw[k] for k in raw.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: not a state dict: {type(obj)}")
    return {k: v.numpy() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def build_backbone(network: str, layers: Optional[Sequence[str]] = None,
                   weights_path: Optional[str] = None, seed: int = 0
                   ) -> Tuple[nn.Module, Tuple[str, ...], bool]:
    """(module, taps, pretrained) of an alternate perceptual backbone on
    the CPU: the weights at ``weights_path`` (a torchvision-schema
    ``.pth`` or ``.npz``), else seeded random ones."""
    cls, loader, default_layers = BACKBONES[network]
    layers = tuple(layers or default_layers)
    model = cls(layers)
    if weights_path:
        load_variables(model, loader(read_state(weights_path)))
        return model, layers, True
    random_init_(model, seed)
    return model, layers, False
