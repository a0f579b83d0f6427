"""The plain reference, built by the configuration's build
(:mod:`rlbench.builds`) from the same configuration file and the same
weight trees as the program, in float32 (TF32 off), and the
controls: the reference computed one precision below the
configuration's (:func:`precision`).

The reference takes nothing the program made: it folds the spectral
norms from the trees itself, rasterizes its own labels and draws the
train-mode preparation's randomness from its own generator, seeded as
the program's is.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from rlbench import builds
from rlbench.reference.core import config as ref_config

FP8_MAX = 448.0         # largest finite float8_e4m3fn


def configs(config: dict):
    """(motion config, renderer config) of the reference, in float32."""
    mcfg = ref_config.motion_config_from_dict(config["motion"])
    rcfg = ref_config.renderer_config_from_dict(config["renderer"])
    return (dataclasses.replace(mcfg, compute_dtype="float32"),
            dataclasses.replace(rcfg, compute_dtype="float32"))


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per tensor (its
    largest magnitude to 448), as an fp8 matrix unit takes it."""
    if not x.is_floating_point() or x.numel() == 0:
        return x
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """A float32 ``x`` rounded to nearest even at TF32's 10 mantissa
    bits, as a TF32 matrix unit takes it (the gradient passes
    straight through)."""
    if x.dtype != torch.float32:
        return x
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return x + (i.view(torch.float32).view_as(x) - x).detach()


class RoundedOperands(TorchFunctionMode):
    """Every convolution and matrix product takes its operands through
    ``rnd`` and accumulates in float32 (TF32 off): the arithmetic of a
    lower-precision matrix unit, the same on any device."""

    _OPS = {F.conv2d, F.conv3d, F.linear, torch.matmul, torch.bmm,
            torch.Tensor.matmul, torch.Tensor.__matmul__}

    def __init__(self, rnd: Callable):
        super().__init__()
        self.rnd = rnd

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self._OPS:
            n = 3 if func is F.linear else 2
            args = tuple(self.rnd(a) if i < n and isinstance(
                a, torch.Tensor) else a for i, a in enumerate(args))
        return func(*args, **kwargs)


@contextlib.contextmanager
def precision(mode: str, device=None):
    """``float32``: the reference (TF32 off); ``tf32``: the control of a
    float32 configuration, the card's own TF32 convolutions and matrix
    products forward and backward (on the CPU, which has none, their
    operands rounded to TF32 in the forward); ``fp8``: the control of a
    bfloat16 one, every convolution's and matrix product's operands
    rounded to fp8 (TF32 off)."""
    card = device is not None and torch.device(device).type == "cuda"
    rnd = {"float32": None, "tf32": None if card else tf32_round,
           "fp8": fp8_round}[mode]
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = card and mode == "tf32"
    torch.backends.cudnn.allow_tf32 = card and mode == "tf32"
    try:
        if rnd is None:
            yield
        else:
            with RoundedOperands(rnd):
                yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def control_mode(config: dict) -> str:
    """The precision one step below the configuration's."""
    return {"float32": "tf32", "bfloat16": "fp8"}[
        config["renderer"]["compute_dtype"]]


def serving(config: dict, traffic: dict, trees: Dict, stats, device
            ) -> Callable:
    """The build's reference ``fn(motion, conf, keys) -> fused`` over N
    clips."""
    return builds.load(config).reference_serving(config, traffic, trees,
                                                 stats, device)


def training(config: dict, trees: Dict, seed: int, device):
    """The build's reference ``(state, step)`` on raw windows."""
    return builds.load(config).reference_training(config, trees, seed,
                                                  device)


def specs(config: dict, kind: str) -> Dict:
    """The weight trees' layouts a cell of ``kind`` needs, in the order
    ``rlbench.weights.make_trees`` draws them."""
    return builds.load(config).specs(config, kind)


def serving_control(mode: str) -> Callable:
    """A program factory (as :func:`rlbench.port.serving`) that puts the
    reference, computed in ``mode``, in the program's place."""
    def build(config, traffic, trees, stats, device):
        ref = serving(config, traffic, trees, stats, device)

        def fn(motion, conf, keys):
            with torch.inference_mode(), precision(mode, device):
                return ref(motion, conf, keys), None
        return fn
    return build


def training_control(mode: str) -> Callable:
    """A program factory (as :func:`rlbench.port.training`) that puts the
    reference's step, computed in ``mode``, in the program's place."""
    def build(config, trees, seed, device):
        state, step = training(config, trees, seed, device)

        def stepped(st, batch):
            with precision(mode, device):
                return step(st, batch)
        return state, stepped
    return build
