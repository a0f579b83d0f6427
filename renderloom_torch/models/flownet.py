"""Learned bidirectional flow for background interpolation.

Port of the JAX package's ``renderloom/models/flownet.py``: a compact
UNet that predicts both flow directions between two keyframes in one
forward pass (:class:`FlowUNet`), the Super-SloMo time warp that
synthesizes the frame at time t from them (:func:`time_warp`), and the
``interp_fn(img0, img1, t)`` of ``ops.flow.frame_double_pairs`` /
``upsample_background`` bound to a model (:func:`make_learned_interp`),
the learned drop-in for the LK backend.

Tensors are batched NHWC.  Where the JAX code ``vmap``\\ s a single pair
through the UNet, the port runs the whole batch of pairs as one UNet
batch.  The convolutions pad as flax's ``"SAME"`` does
(:class:`~renderloom_torch.models.layers.SameConv`), compute in the
model's dtype (float32 or bfloat16) on float32 parameters, and the
flows come out in float32.  Parameter names are the flax tree's
(``down{l}``, ``down{l}b``, ``up{l}``, ``flow_head``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from renderloom_torch.models.layers import SameConv, set_compute_dtype
from renderloom_torch.ops.flow import backward_warp, backward_warp_shift

LEAKY_SLOPE = 0.1


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


def upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    """×2 nearest upsample of (B, H, W, C) as a broadcast repeat, whose
    gradient is a plain sum over each 2×2 block."""
    B, H, W, C = x.shape
    return x[:, :, None, :, None].expand(B, H, 2, W, 2, C).reshape(
        B, 2 * H, 2 * W, C)


class FlowUNet(nn.Module):
    """(img0, img1), each (B, H, W, 3) → (flow0→1, flow1→0), each
    (B, H, W, 2) float32.

    Encoder: ``levels`` stride-2 3×3 convolutions, each followed by a
    3×3 one, with ``base·2^l`` channels capped at 8·base; decoder: ×2
    nearest upsample, concatenation with the skip, 3×3 conv.  The flow
    head starts at zero (:func:`~renderloom_torch.convert.flax_init_`),
    so the untrained network predicts zero flow.  H and W must be
    divisible by ``2**levels``."""

    def __init__(self, base: int = 24, levels: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.levels = levels
        chans, ch, in_ch = [], base, 6
        for lvl in range(levels):
            setattr(self, f"down{lvl}", SameConv(in_ch, ch, 3, 2))
            setattr(self, f"down{lvl}b", SameConv(ch, ch, 3))
            chans.append(ch)
            in_ch, ch = ch, min(ch * 2, base * 8)
        for lvl in reversed(range(levels)):
            skip = chans[lvl - 1] if lvl > 0 else 0
            setattr(self, f"up{lvl}", SameConv(in_ch + skip, chans[lvl], 3))
            in_ch = chans[lvl]
        self.flow_head = SameConv(in_ch, 4, 3)
        self.flow_head.zero_init = True
        self.dtype = dtype
        set_compute_dtype(self, dtype)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([img0, img1], dim=-1).to(self.dtype)
        skips = []
        for lvl in range(self.levels):
            x = _leaky(getattr(self, f"down{lvl}")(x))
            x = _leaky(getattr(self, f"down{lvl}b")(x))
            skips.append(x)
        for lvl in reversed(range(self.levels)):
            x = upsample_nearest2(x)
            if lvl > 0:
                x = torch.cat([x, skips[lvl - 1]], dim=-1)
            x = _leaky(getattr(self, f"up{lvl}")(x))
        flows = self.flow_head(x).float()
        return flows[..., :2], flows[..., 2:]


def time_warp(img0: torch.Tensor, img1: torch.Tensor, f01: torch.Tensor,
              f10: torch.Tensor, t, max_disp: int = 16,
              exact: bool = False) -> torch.Tensor:
    """Super-SloMo intermediate-time warp of (B, H, W, C) keyframes with
    their (B, H, W, 2) flows at time ``t`` (a float, or a tensor that
    broadcasts against (B, H, W, C)): the flows from the frame at t to
    each keyframe as combinations of the keyframe-to-keyframe flows, both
    keyframes backward-warped, blended by time weight × photometric
    agreement.

    The warp is the separable shift warp bounded by ``max_disp`` px per
    axis, or with ``exact=True`` the unbounded bilinear gather warp (the
    training loss uses it, so its photometric gradient is never clipped
    past the bound)."""
    f_t0 = -(1.0 - t) * t * f01 + t * t * f10
    f_t1 = (1.0 - t) * (1.0 - t) * f01 - t * (1.0 - t) * f10
    if exact:
        warp = backward_warp
    else:
        warp = lambda im, f: backward_warp_shift(im, f, max_disp)
    w0 = warp(img0, f_t0)
    w1 = warp(img1, f_t1)
    c1 = warp(img1, f01)                 # img1 pulled onto img0's grid
    c0 = warp(img0, f10)
    e0 = torch.abs(c1 - img0).mean(dim=-1, keepdim=True)
    e1 = torch.abs(c0 - img1).mean(dim=-1, keepdim=True)
    a0 = (1.0 - t) / (1.0 + e0)
    a1 = t / (1.0 + e1)
    return (a0 * w0 + a1 * w1) / (a0 + a1)


def make_learned_interp(model: FlowUNet, max_disp: int = 16) -> Callable:
    """``interp_fn(img0, img1, t)`` over batches of (B, H, W, 3) pairs,
    the learned backend of ``ops.flow.frame_double_pairs`` /
    ``upsample_background``: the UNet's flows, then :func:`time_warp`
    with the shift warp bounded by ``max_disp`` (``FlowConfig.
    max_disp``)."""

    @torch.no_grad()
    def interp_fn(img0: torch.Tensor, img1: torch.Tensor, t) -> torch.Tensor:
        f01, f10 = model(img0, img1)
        return time_warp(img0, img1, f01, f10, t, max_disp=max_disp)

    return interp_fn
