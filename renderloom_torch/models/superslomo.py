"""Super SloMo (Jiang et al., "Super SloMo: High Quality Estimation of
Multiple Intermediate Frames for Video Interpolation", CVPR 2018,
arXiv:1712.00080, §3 and Fig. 3) as the serving pipeline's learned
background interpolator.

Two U-Nets of six levels (:class:`UNet`): the flow network maps a
keyframe pair to both flows once per pair, and the arbitrary-time
network refines the time-t flows and predicts a visibility map once per
pair and in-between time.  :meth:`SuperSloMo.forward` takes N clips of
K keyframes and returns their ``(K−1)·rate + 1`` backgrounds with the
keyframes in their slots, for any ``rate ≥ 2``: the flow network runs
once over all N·(K−1) pairs, the time network once over all
N·(K−1)·(rate−1) pair-and-time inputs.  The batches are not chunked:
at one clip of 8 keyframes at rate 4 (21 time-net images at 480×320)
the whole time net fits the card many times over.

Where the paper is silent the public PyTorch implementation
(github.com/avinashpaliwal/Super-SloMo, ``model.py``) decides: a leaky
ReLU (slope 0.1) after every convolution, the output one included;
keyframes in [0, 1] less a per-channel mean (std 1) going in, the mean
added back to the frame coming out; and the warp ``g`` reads zero
outside the frame (its ``grid_sample``), unlike the port's edge-clamped
``ops.flow.backward_warp``.

Tensors are NHWC; the convolutions pad to "same" at stride 1
(:class:`~renderloom_torch.models.layers.Conv`) and compute in the
config's ``compute_dtype`` on float32 parameters.  Parameter names are
the public implementation's (``conv1``, ``conv2``, ``down{1..5}``,
``up{1..5}``, ``conv3`` under ``flow_net`` and ``time_net``), so a flax
tree loads by name through :mod:`renderloom_torch.convert`.

Under a profiler the stages of :meth:`SuperSloMo.forward` are the spans
``background.flow_net``, ``background.time_net`` and
``background.warp`` (the time-t flow combination, the four warps and
the blend; two spans a call), nested in the pipeline's
``pipeline.background``.  Each :class:`UNet` counts its calls and the
images they held (``calls``, ``images``; :meth:`SuperSloMo.
reset_counters`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from renderloom_torch.core.config import SloMoConfig, torch_dtype
from renderloom_torch.models.layers import Conv, set_compute_dtype
from renderloom_torch.ops.image import bilinear_sample
from renderloom_torch.utils.profiling import annotate

FLOW_IN, FLOW_OUT = 6, 4        # (I0 ‖ I1) → (F01 ‖ F10)
# (I0 ‖ I1 ‖ F01 ‖ F10 ‖ F̂t1 ‖ F̂t0 ‖ g(I1, F̂t1) ‖ g(I0, F̂t0))
# → (ΔFt0 ‖ ΔFt1 ‖ V0 before its sigmoid)
TIME_IN, TIME_OUT = 20, 5


class _Down(nn.Module):
    """2×2 average pool, then two k×k convolutions."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__()
        self.conv1 = Conv(in_ch, out_ch, kernel)
        self.conv2 = Conv(out_ch, out_ch, kernel)


class _Up(nn.Module):
    """Bilinear ×2, a 3×3 convolution, the skip concatenated, a 3×3
    convolution over both."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = Conv(in_ch, out_ch, 3)
        self.conv2 = Conv(2 * out_ch, out_ch, 3)


class UNet(nn.Module):
    """Super SloMo's U-Net: (B, H, W, in_ch) → (B, H, W, out_ch), six
    levels of ``widths`` channels with ``kernels`` (level 0: two
    convolutions at full resolution; levels 1–5: :class:`_Down`),
    a decoder of five :class:`_Up`, and a 3×3 output convolution.  H
    and W must be divisible by 32."""

    def __init__(self, in_ch: int, out_ch: int, widths: Sequence[int],
                 kernels: Sequence[int], slope: float):
        super().__init__()
        c, k = list(widths), list(kernels)
        self.slope = slope
        self.conv1 = Conv(in_ch, c[0], k[0])
        self.conv2 = Conv(c[0], c[0], k[0])
        for lvl in range(1, 6):
            setattr(self, f"down{lvl}", _Down(c[lvl - 1], c[lvl], k[lvl]))
        for i, lvl in enumerate(range(4, -1, -1), start=1):
            setattr(self, f"up{i}", _Up(c[lvl + 1], c[lvl]))
        self.conv3 = Conv(c[0], out_ch, 3)
        self.calls = self.images = 0

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, self.slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        if H % 32 or W % 32:
            raise ValueError(f"{H}×{W}: Super SloMo's U-Net needs H and W "
                             "divisible by 32")
        self.calls += 1
        self.images += B
        x = self._act(self.conv2(self._act(self.conv1(x))))
        skips = [x]
        for lvl in range(1, 6):
            down = getattr(self, f"down{lvl}")
            x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
            x = self._act(down.conv2(self._act(down.conv1(x))))
            skips.append(x)
        skips.pop()
        for i in range(1, 6):
            up = getattr(self, f"up{i}")
            x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                              mode="bilinear", align_corners=False
                              ).permute(0, 2, 3, 1)
            x = self._act(up.conv1(x))
            x = self._act(up.conv2(torch.cat([x, skips.pop()], dim=-1)))
        return self._act(self.conv3(x))


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``g(I, F)``: (B, H, W, C) ``img`` sampled bilinearly at ``x +
    flow`` (flow (B, H, W, 2), xy, float32), zero outside the frame."""
    B, H, W, _ = img.shape
    ys = torch.arange(H, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=img.device)[None, :]
    return bilinear_sample(img, xs + flow[..., 0], ys + flow[..., 1],
                           mode="constant")


def time_flows(f01: torch.Tensor, f10: torch.Tensor, t: torch.Tensor):
    """The flows from the frame at ``t`` to each keyframe, (F̂t0, F̂t1),
    as the paper's combination of the keyframe-to-keyframe flows
    (eq. 4)."""
    f_t0 = -(1.0 - t) * t * f01 + t * t * f10
    f_t1 = (1.0 - t) * (1.0 - t) * f01 - t * (1.0 - t) * f10
    return f_t0, f_t1


def blend(w0: torch.Tensor, w1: torch.Tensor, v0: torch.Tensor,
          t: torch.Tensor) -> torch.Tensor:
    """The frame at ``t`` from the warped keyframes and the visibility
    of keyframe 0 (keyframe 1's is 1 − V0), each weighted by its
    temporal distance (eq. 1)."""
    a0 = (1.0 - t) * v0
    a1 = t * (1.0 - v0)
    return (a0 * w0 + a1 * w1) / (a0 + a1)


class SuperSloMo(nn.Module):
    """The flow and arbitrary-time U-Nets of ``cfg`` (:class:`~renderloom_
    torch.core.config.SloMoConfig`) and the path between them;
    ``forward(keys, rate)`` is the pipeline's background backend."""

    def __init__(self, cfg: SloMoConfig = SloMoConfig()):
        super().__init__()
        args = (cfg.widths, cfg.kernels, cfg.leaky_slope)
        self.flow_net = UNet(FLOW_IN, FLOW_OUT, *args)
        self.time_net = UNet(TIME_IN, TIME_OUT, *args)
        self.register_buffer("mean", torch.tensor(cfg.mean,
                                                  dtype=torch.float32),
                             persistent=False)
        self.dtype = torch_dtype(cfg.compute_dtype)
        set_compute_dtype(self, self.dtype)

    def reset_counters(self):
        for net in (self.flow_net, self.time_net):
            net.calls = net.images = 0

    def _net(self, net: UNet, x: torch.Tensor) -> torch.Tensor:
        # cuDNN's heuristics give a float32 3×3 convolution of 256 → 128
        # channels at 80×120 (the decoder's third step) an FFT tiling
        # that takes ~100 ms a call at 0.4 TFLOP/s and whose time spreads
        # from run to run; its search, at the first call of each shape,
        # picks by measurement
        prev = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        try:
            return net(x.to(self.dtype)).float()
        finally:
            torch.backends.cudnn.benchmark = prev

    def forward(self, keys: torch.Tensor, rate: int) -> torch.Tensor:
        """(N, K, H, W, 3) keyframes in [0, 1] → (N, (K−1)·rate + 1, H,
        W, 3) backgrounds, the keyframes in their slots (every
        ``rate``-th frame) and the frames at t = j / rate, j = 1 …
        rate − 1, between them."""
        N, K, H, W, C = keys.shape
        if rate < 2 or K < 2:
            raise ValueError(f"rate {rate}, {K} keyframes: Super SloMo "
                             "needs rate ≥ 2 and two keyframes")
        T = rate - 1
        x = keys.float() - self.mean
        i0 = x[:, :-1].reshape(-1, H, W, C)             # (P, H, W, 3)
        i1 = x[:, 1:].reshape(-1, H, W, C)
        P = i0.shape[0]
        with annotate("background.flow_net"):
            flows = self._net(self.flow_net, torch.cat([i0, i1], dim=-1))
        # pair-major, time-minor: row p·T + j − 1 is pair p at t = j/rate
        rep = lambda v: v.repeat_interleave(T, dim=0)
        t = (torch.arange(1, rate, dtype=torch.float32, device=keys.device)
             / rate).repeat(P).reshape(-1, 1, 1, 1)
        i0, i1, flows = rep(i0), rep(i1), rep(flows)
        f01, f10 = flows[..., :2], flows[..., 2:]
        with annotate("background.warp"):
            f_t0, f_t1 = time_flows(f01, f10, t)
            g1, g0 = warp(torch.cat([i1, i0]),
                          torch.cat([f_t1, f_t0])).split(P * T)
        with annotate("background.time_net"):
            o = self._net(self.time_net, torch.cat(
                [i0, i1, f01, f10, f_t1, f_t0, g1, g0], dim=-1))
        with annotate("background.warp"):
            w0, w1 = warp(torch.cat([i0, i1]),
                          torch.cat([f_t0 + o[..., 0:2],
                                     f_t1 + o[..., 2:4]])).split(P * T)
            mids = blend(w0, w1, torch.sigmoid(o[..., 4:5]), t) + self.mean
        mids = mids.reshape(N, K - 1, T, H, W, C).to(keys.dtype)
        grp = torch.cat([keys[:, :-1, None], mids], dim=2)
        return torch.cat([grp.reshape(N, (K - 1) * rate, H, W, C),
                          keys[:, -1:]], dim=1)
