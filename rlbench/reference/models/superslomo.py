"""Super SloMo in plain float32 PyTorch, written from the paper's
equations (Jiang et al., CVPR 2018, arXiv:1712.00080 §3, Fig. 3) and,
where the paper is silent, the public implementation
(github.com/avinashpaliwal/Super-SloMo, ``model.py``).  NCHW
throughout: ``F.conv2d`` with zero padding k // 2, ``F.avg_pool2d``,
``F.interpolate`` and a bilinear gather of its own.  It imports nothing
of the program.

U-Net(in, out), channels c = ``widths``, kernels k = ``kernels``:

* level 0: conv k0 in→c0, conv k0 c0→c0;
* level l = 1…5: 2×2 average pool, conv kl c(l−1)→cl, conv kl cl→cl;
* decoder l = 4…0: bilinear ×2 (``align_corners=False``), conv 3×3
  c(l+1)→cl, level l's encoder output concatenated after it, conv 3×3
  2cl→cl;
* conv 3×3 c0→out;

every convolution followed by a leaky ReLU of ``leaky_slope``, the
output one included.  Flow: (F01, F10) = channels 0:2, 2:4 of
flow_net(I0 ‖ I1).  At t: F̂t0 = −(1−t)t·F01 + t²·F10, F̂t1 = (1−t)²·F01
− t(1−t)·F10; o = time_net(I0 ‖ I1 ‖ F01 ‖ F10 ‖ F̂t1 ‖ F̂t0 ‖ g(I1, F̂t1)
‖ g(I0, F̂t0)); Ft0 = F̂t0 + o0:2, Ft1 = F̂t1 + o2:4, V0 = σ(o4), V1 = 1 −
V0; It = ((1−t)·V0·g(I0, Ft0) + t·V1·g(I1, Ft1)) / ((1−t)·V0 + t·V1).
g(I, F) samples I bilinearly at x + F(x), zero outside the frame.  The
networks see the keyframes less ``mean`` (std 1), and It gets the mean
back.

Parameter names (``flow_net.conv1``, ``time_net.down3.conv2``,
``time_net.up5.conv1``, ``time_net.conv3``, …) are the flax tree's the
benchmark draws, loaded by :func:`rlbench.reference.convert.
load_flax_params`.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class Level(nn.Module):
    """Two convolutions of one encoder level, or the two of a decoder
    step (``conv1`` before the skip, ``conv2`` after it)."""

    def __init__(self, c1: tuple, c2: tuple):
        super().__init__()
        self.conv1 = _conv(*c1)
        self.conv2 = _conv(*c2)


class UNet(nn.Module):
    def __init__(self, cin: int, cout: int, widths: List[int],
                 kernels: List[int], slope: float):
        super().__init__()
        c, k = widths, kernels
        self.slope = slope
        self.conv1 = _conv(cin, c[0], k[0])
        self.conv2 = _conv(c[0], c[0], k[0])
        for lvl in range(1, 6):
            setattr(self, f"down{lvl}", Level((c[lvl - 1], c[lvl], k[lvl]),
                                              (c[lvl], c[lvl], k[lvl])))
        for step in range(1, 6):
            lvl = 5 - step
            setattr(self, f"up{step}", Level((c[lvl + 1], c[lvl], 3),
                                             (2 * c[lvl], c[lvl], 3)))
        self.conv3 = _conv(c[0], cout, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = lambda v: F.leaky_relu(v, self.slope)
        x = act(self.conv1(x))
        x = act(self.conv2(x))
        enc = [x]
        for lvl in range(1, 6):
            down = getattr(self, f"down{lvl}")
            x = F.avg_pool2d(x, kernel_size=2, stride=2)
            x = act(down.conv1(x))
            x = act(down.conv2(x))
            enc.append(x)
        for step in range(1, 6):
            up = getattr(self, f"up{step}")
            x = F.interpolate(x, scale_factor=2, mode="bilinear",
                              align_corners=False)
            x = act(up.conv1(x))
            x = act(up.conv2(torch.cat([x, enc[5 - step]], dim=1)))
        return act(self.conv3(x))


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """g(I, F): (B, C, H, W) ``img`` at x + flow (flow (B, 2, H, W), x
    then y), bilinear over the four neighbours, each neighbour outside
    the frame read as zero."""
    B, C, H, W = img.shape
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=img.device),
        torch.arange(W, dtype=torch.float32, device=img.device),
        indexing="ij")
    x = gx + flow[:, 0]
    y = gy + flow[:, 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    flat = img.reshape(B, C, H * W)
    out = torch.zeros_like(img)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            weight = (1 - (x - xi).abs()) * (1 - (y - yi).abs())
            inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
            vals = torch.gather(flat, 2, idx.reshape(B, 1, H * W)
                                .expand(B, C, H * W)).reshape(B, C, H, W)
            out = out + vals * (weight * inside)[:, None]
    return out


class SuperSloMo(nn.Module):
    """The two U-Nets of the configuration's ``slomo`` section."""

    def __init__(self, cfg: Dict):
        super().__init__()
        args = (list(cfg["widths"]), list(cfg["kernels"]),
                float(cfg["leaky_slope"]))
        self.flow_net = UNet(6, 4, *args)
        self.time_net = UNet(20, 5, *args)
        self.mean_rgb = tuple(float(m) for m in cfg["mean"])

    def frame_at(self, i0, i1, f01, f10, t: float) -> torch.Tensor:
        """It of the (B, 3, H, W) mean-less keyframes and their flows."""
        ft0 = -(1 - t) * t * f01 + t * t * f10
        ft1 = (1 - t) * (1 - t) * f01 - t * (1 - t) * f10
        o = self.time_net(torch.cat([i0, i1, f01, f10, ft1, ft0,
                                     warp(i1, ft1), warp(i0, ft0)], dim=1))
        ft0 = ft0 + o[:, 0:2]
        ft1 = ft1 + o[:, 2:4]
        v0 = torch.sigmoid(o[:, 4:5])
        v1 = 1 - v0
        num = (1 - t) * v0 * warp(i0, ft0) + t * v1 * warp(i1, ft1)
        return num / ((1 - t) * v0 + t * v1)

    def backgrounds(self, keys: torch.Tensor, rate: int) -> torch.Tensor:
        """One clip's (K, H, W, 3) keyframes in [0, 1] → its
        ((K−1)·rate + 1, H, W, 3) backgrounds: keyframe s at frame
        s·rate, and between keyframes s and s + 1 the frames at t = j /
        rate, j = 1 … rate − 1."""
        mean = torch.tensor(self.mean_rgb, device=keys.device
                            ).reshape(1, 3, 1, 1)
        x = keys.permute(0, 3, 1, 2).float() - mean
        i0, i1 = x[:-1], x[1:]
        flows = self.flow_net(torch.cat([i0, i1], dim=1))
        f01, f10 = flows[:, 0:2], flows[:, 2:4]
        mids = [self.frame_at(i0, i1, f01, f10, j / rate) + mean
                for j in range(1, rate)]
        frames = []
        for s in range(keys.shape[0] - 1):
            frames.append(keys[s])
            frames.extend(m[s].permute(1, 2, 0) for m in mids)
        frames.append(keys[-1])
        return torch.stack(frames)
