"""Perceptual loss on VGG19 or an alternate backbone.

Port of the JAX package's
``renderloom/models/perceptual.py`` (``VGG19Features``,
``PerceptualLoss``): inputs in [-1, 1] are renormalized to ImageNet
statistics, run through the VGG19 trunk (3×3 convolutions with zero
padding 1, ReLU, 2×2 max pools that drop an odd edge, as flax's
``"SAME"`` and ``max_pool`` do), and compared with L1 at ``relu_1_1 …
relu_5_1`` with weights ``[1/32, 1/16, 1/8, 1/4, 1]``; the target's
features carry no gradient.

Pretrained weights load from a torchvision ``vgg19().features`` state
dict, as an ``.npz`` (:func:`load_torchvision_npz`) or a ``.pth``
(:func:`load_torchvision_pth`), found through the ``VGG19_NPZ``
environment variable or ``data/vgg19_features.npz``
(:func:`find_vgg_weights`), or passed as ``weights_path``.  Without them
the trunk runs with fixed random weights (seeded lecun-normal kernels,
zero biases, :func:`renderloom_torch.convert.random_init_`), the JAX
package's fallback, unless ``require_pretrained`` makes that an error;
or with a flax tree loaded through
:func:`renderloom_torch.convert.load_flax_params` (the tests load the
one the JAX package drew).

``PerceptualLoss(..., compute_dtype)`` runs the trunk in that dtype, as
the flax module's ``dtype``: the renormalized input and the float32
kernels are cast to it at each convolution, and each tap's L1 is
reduced in float32.  :meth:`PerceptualLoss.lpips` is the JAX package's
uncalibrated LPIPS-style distance.  Both iterate the taps, so they run
on any backbone; ``network=`` picks one of
:mod:`renderloom_torch.models.backbones` instead of VGG19, as the JAX
``PerceptualLoss(network=...)`` does.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from renderloom_torch.convert import load_flax_params
from renderloom_torch.models.backbones import build_backbone
from renderloom_torch.models.layers import Conv, set_compute_dtype

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# VGG19 conv plan: (block, convs in block, channels)
VGG19_PLAN = [(1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512),
              (5, 4, 512)]
DEFAULT_LAYERS = ("relu_1_1", "relu_2_1", "relu_3_1", "relu_4_1",
                  "relu_5_1")
DEFAULT_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)

# torchvision vgg19().features Sequential indices of each conv
TORCHVISION_CONV_IDX = {
    "conv_1_1": 0, "conv_1_2": 2,
    "conv_2_1": 5, "conv_2_2": 7,
    "conv_3_1": 10, "conv_3_2": 12, "conv_3_3": 14, "conv_3_4": 16,
    "conv_4_1": 19, "conv_4_2": 21, "conv_4_3": 23, "conv_4_4": 25,
    "conv_5_1": 28, "conv_5_2": 30, "conv_5_3": 32, "conv_5_4": 34,
}

NO_WEIGHTS_HELP = (
    "PerceptualLoss: no pretrained VGG19 weights found. The ×10-weighted "
    "perceptual term would train against RANDOM features — not the "
    "reference objective "
    "(Pose_Guided_Neural_Rendering/models/losses.py:222-277). Provide "
    "weights via VGG19_NPZ=<path to vgg19_features.npz or torchvision "
    "vgg19 .pth>, or pass --allow-random-vgg to proceed anyway.")


def _conv_tree(state: Dict[str, np.ndarray], names) -> Dict:
    """flax params {conv_b_i: {kernel (HWIO), bias}} from a torchvision
    state dict, for each conv whose weight the dict holds under one of
    ``names(idx)``'s key prefixes."""
    params = {}
    for name, idx in TORCHVISION_CONV_IDX.items():
        for pre in names(idx):
            if f"{pre}weight" in state:
                params[name] = {
                    "kernel": np.transpose(np.asarray(
                        state[f"{pre}weight"], np.float32), (2, 3, 1, 0)),
                    "bias": np.asarray(state[f"{pre}bias"], np.float32)}
                break
    return {"params": params}


def load_torchvision_npz(path: str) -> Dict:
    """npz of a torchvision ``vgg19().features`` state dict → flax params
    (OIHW → HWIO kernels)."""
    with np.load(path) as raw:
        return _conv_tree({k: raw[k] for k in raw.files},
                          lambda idx: (f"features.{idx}.",))


def load_torchvision_pth(path: str) -> Dict:
    """torchvision ``vgg19`` checkpoint (``.pth``, e.g. the official
    ``vgg19-dcbb9e9d.pth``) → flax params, read with
    ``torch.load(weights_only=True)``.  Accepts a full-model state dict
    (``features.N.*`` + ``classifier.*``), a bare ``.features`` one
    (``N.weight``), a ``state_dict`` envelope and ``module.`` prefixes;
    raises unless all 16 convs are found."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"checkpoint is not a state dict: {type(obj)}")
    state = {k[len("module."):] if k.startswith("module.") else k:
             v.numpy() for k, v in obj.items()
             if isinstance(v, torch.Tensor)}
    tree = _conv_tree(state, lambda idx: (f"features.{idx}.", f"{idx}."))
    if len(tree["params"]) != len(TORCHVISION_CONV_IDX):
        raise ValueError(
            f"{path}: found {len(tree['params'])}/16 VGG19 conv layers — "
            "not a torchvision vgg19 state dict")
    return tree


def find_vgg_weights() -> Optional[str]:
    """``$VGG19_NPZ``, else ``data/vgg19_features.npz`` under the working
    directory or the repository, whichever exists first."""
    cands = [os.environ.get("VGG19_NPZ", ""),
             "data/vgg19_features.npz",
             os.path.join(os.path.dirname(__file__), "..", "..", "data",
                          "vgg19_features.npz")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    return None


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
    """L1 perceptual criterion: ``loss(pred, target)`` over the taps.

    ``network="vgg19"`` (the default): the weights at ``weights_path``
    or :func:`find_vgg_weights` (``pretrained`` is then True); without
    any, ``require_pretrained`` raises, and otherwise the trunk keeps
    the initial weights of its modules for the caller to fill
    (``make_perceptual`` draws them from a seed).

    Another ``network`` (:data:`renderloom_torch.models.backbones.
    BACKBONES`: ``vgg16``, ``alexnet``, ``resnet50``, ``inception_v3``,
    ``robust_resnet50``, ``vgg_face_dag``) is the JAX package's
    alternate-backbone branch: its own taps unless ``layers`` names
    others, uniform tap weights unless ``weights`` are given, the
    torchvision-schema weights at ``weights_path`` or seeded random ones
    (:func:`~renderloom_torch.models.backbones.build_backbone`), which
    ``require_pretrained`` refuses, naming the network.  The alternate
    backbones compute in float32 whatever ``compute_dtype`` is."""

    def __init__(self, layers: Sequence[str] = DEFAULT_LAYERS,
                 weights: Sequence[float] = DEFAULT_WEIGHTS,
                 compute_dtype: torch.dtype = torch.float32,
                 weights_path: Optional[str] = None,
                 require_pretrained: bool = False,
                 network: str = "vgg19"):
        super().__init__()
        if network != "vgg19":
            if require_pretrained and not weights_path:
                raise RuntimeError(
                    f"PerceptualLoss[{network}]: no pretrained weights "
                    "provided (pass a torchvision .pth/.npz as "
                    "weights_path)")
            self.model, self.layers, self.pretrained = build_backbone(
                network, None if layers is DEFAULT_LAYERS else layers,
                weights_path)
            # the [1/32 … 1] schedule is VGG19's
            self.weights = (tuple(weights) if weights is not DEFAULT_WEIGHTS
                            else (1.0,) * len(self.layers))
        else:
            self.layers, self.weights = tuple(layers), tuple(weights)
            self.model = set_compute_dtype(VGG19Features(layers),
                                           compute_dtype)
            path = weights_path or find_vgg_weights()
            self.pretrained = bool(path)
            if path:
                tree = (load_torchvision_pth(path)
                        if path.endswith((".pth", ".pt"))
                        else load_torchvision_npz(path))["params"]
                # the trunk holds the convs up to its deepest tap
                own = {n.split(".")[0]
                       for n, _ in self.model.named_parameters()}
                load_flax_params(self.model, {k: v for k, v in tree.items()
                                              if k in own})
            elif require_pretrained:
                raise RuntimeError(NO_WEIGHTS_HELP)
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

    def lpips(self, pred: torch.Tensor,
              target: torch.Tensor) -> torch.Tensor:
        """LPIPS-style distance with uniform weights, one value per batch
        element: the squared difference of channel-unit-normalized
        features, averaged over H, W and C, summed over the taps and
        divided by their count."""
        f_pred = self.model(self.renormalize(pred))
        f_tgt = self.model(self.renormalize(target))
        dist = 0.0
        for name in self.layers:
            d = _unit_normalize(f_pred[name]) - _unit_normalize(f_tgt[name])
            dist = dist + (d * d).mean(dim=(1, 2, 3))
        return dist / len(self.layers)


def _unit_normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Each pixel's channel vector scaled to unit L2 norm (NHWC)."""
    norm = torch.sqrt((feat * feat).sum(dim=-1, keepdim=True))
    return feat / (norm + eps)
