"""Flow-based background interpolation: pyramidal Lucas-Kanade flow and
the bidirectional blend that synthesizes every in-between background.

Port of the JAX package's ``renderloom/ops/flow.py``.  LK backend
(``upsample_background``): flow is estimated once per keyframe pair and
direction, at 1/flow_scale resolution for the serving pipeline, whose
full-resolution frames are then warped with the clipped separable
shift-and-blend warp, reproduced exactly (not ``grid_sample``), or at
full resolution with the bilinear warp (``flow_scale=1``, the serving
CLIs' backgrounds).  The reference's two usage patterns:
``interpolate_pair`` (a keyframe pair and a time) and
``train_background`` (frame i+1's background from frames i and i+2).
A midpoint-only ``interp_fn(img0, img1, t)`` (the learned UNet,
``models.flownet.make_learned_interp``) takes the place of LK in
``frame_double_pairs``, ``train_background`` and, by recursive
doubling, ``upsample_background``; an arbitrary-time model (Super
SloMo, ``models.superslomo.SuperSloMo``) takes it in
``upsample_background`` at any rate, every time in one batch.  Images are batched NHWC
(B, H, W, C); every function takes the batch the JAX code
``vmap``\\ s over, and an ``interp_fn`` gets all pairs as one batch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from renderloom_torch.ops.image import (bilinear_sample, gaussian_kernel1d,
                                        resize_bilinear)


def _blur(img: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Separable gaussian blur of (B, H, W, C), edge-padded."""
    B, H, W, C = img.shape
    r = max(int(2 * sigma), 1)
    k = gaussian_kernel1d(sigma, r, img.device)
    x = img.permute(0, 3, 1, 2).reshape(B * C, 1, H, W)
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"),
                 k.reshape(1, 1, -1, 1))
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="replicate"),
                 k.reshape(1, 1, 1, -1))
    return x.reshape(B, C, H, W).permute(0, 2, 3, 1)


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    return _blur(img, 1.0)[:, ::2, ::2]


def _box_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, H, W) mean filter via cumulative sums (the LK window)."""
    k = 2 * radius + 1
    pad = F.pad(x[:, None], (radius + 1, radius, radius + 1, radius),
                mode="replicate")[:, 0]
    c = torch.cumsum(torch.cumsum(pad, dim=1), dim=2)
    s = c[:, k:, k:] - c[:, :-k, k:] - c[:, k:, :-k] + c[:, :-k, :-k]
    return s / (k * k)


def _gradient(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.gradient`` along ``dim``: central differences inside,
    one-sided at the two edges."""
    n = x.shape[dim]
    inner = (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) / 2.0
    first = x.narrow(dim, 1, 1) - x.narrow(dim, 0, 1)
    last = x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1)
    return torch.cat([first, inner, last], dim=dim)


def backward_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) ``img`` at ``x + flow`` (flow (B, H, W, 2),
    xy), edge-clamped."""
    B, H, W, C = img.shape
    ys = torch.arange(H, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=img.device)[None, :]
    return bilinear_sample(img, xs + flow[..., 0], ys + flow[..., 1])


def _shift_resample1d(img: torch.Tensor, f: torch.Tensor, axis: int,
                      max_disp: int) -> torch.Tensor:
    """1-D bilinear resample of (B, H, W, C) along ``axis`` (1 = rows,
    2 = columns) by per-pixel offset ``f`` (B, H, W) clipped to
    ±max_disp: a weighted sum of 2·max_disp+2 integer shifts of an
    edge-padded copy."""
    R = int(max_disp)
    f = torch.clamp(f, -float(R), float(R))
    f0 = torch.floor(f)
    w = (f - f0)[..., None]
    n = img.shape[axis]
    idx = torch.clamp(torch.arange(-R - 1, n + R + 1, device=img.device),
                      0, n - 1)
    p = img.index_select(axis, idx)
    acc = torch.zeros_like(img)
    for d in range(-R, R + 2):
        sh = p.narrow(axis, d + R + 1, n)
        wgt = ((f0 == d).to(img.dtype)[..., None] * (1.0 - w)
               + (f0 == d - 1).to(img.dtype)[..., None] * w)
        acc = acc + wgt * sh
    return acc


def backward_warp_shift(img: torch.Tensor, flow: torch.Tensor,
                        max_disp: int = 16) -> torch.Tensor:
    """Separable shift-and-blend backward warp of (B, H, W, C) at
    ``x + flow``, |flow| clipped to ±max_disp per axis: horizontal pass,
    then vertical pass."""
    out = _shift_resample1d(img, flow[..., 0], 2, max_disp)
    return _shift_resample1d(out, flow[..., 1], 1, max_disp)


def _lk_refine(i0: torch.Tensor, i1: torch.Tensor, flow: torch.Tensor,
               radius: int = 7, iters: int = 3,
               damp: float = 1e-6) -> torch.Tensor:
    """Lucas-Kanade refinement at one pyramid level: i0, i1 (B, H, W)
    grayscale, flow (B, H, W, 2); window-averaged 2×2 normal equations
    with a Tikhonov ``damp`` and per-iteration updates clamped to ±2."""
    gx, gy = _gradient(i0, 2), _gradient(i0, 1)
    ixx = _box_filter(gx * gx, radius) + damp
    iyy = _box_filter(gy * gy, radius) + damp
    ixy = _box_filter(gx * gy, radius)
    det = ixx * iyy - ixy * ixy
    for _ in range(iters):
        warped = backward_warp(i1[..., None], flow)[..., 0]
        it = warped - i0
        bx = _box_filter(gx * it, radius)
        by = _box_filter(gy * it, radius)
        du = torch.clamp(-(iyy * bx - ixy * by) / det, -2.0, 2.0)
        dv = torch.clamp(-(ixx * by - ixy * bx) / det, -2.0, 2.0)
        flow = flow + torch.stack([du, dv], dim=-1)
    return flow


def estimate_flow(img0: torch.Tensor, img1: torch.Tensor, levels: int = 4,
                  iters: int = 3, radius: int = 7) -> torch.Tensor:
    """Dense flow img0 → img1, both (B, H, W, C): coarse-to-fine over a
    ``levels`` gaussian pyramid, ×2 upsampled with doubling between
    levels.  Returns (B, H, W, 2)."""
    pyr0 = [img0.mean(dim=-1)]
    pyr1 = [img1.mean(dim=-1)]
    for _ in range(levels - 1):
        pyr0.append(_downsample2(pyr0[-1][..., None])[..., 0])
        pyr1.append(_downsample2(pyr1[-1][..., None])[..., 0])
    flow = torch.zeros(pyr0[-1].shape + (2,), dtype=torch.float32,
                       device=img0.device)
    for lvl in reversed(range(levels)):
        if lvl != levels - 1:
            H, W = pyr0[lvl].shape[1:]
            flow = 2.0 * resize_bilinear(flow, H, W)
        flow = _lk_refine(pyr0[lvl], pyr1[lvl], flow, radius, iters)
    return flow


def interpolate_pair(img0: torch.Tensor, img1: torch.Tensor, t,
                     levels: int = 4, iters: int = 3,
                     radius: int = 7) -> torch.Tensor:
    """The frames at time ``t`` ∈ (0, 1) between (B, H, W, C) keyframe
    pairs: LK flow in both directions, img0 warped by t of flow1→0 and
    img1 by 1−t of flow0→1, blended by (1−t, t), each weighted down by
    its forward-backward consistency error."""
    B = img0.shape[0]
    flows = estimate_flow(torch.cat([img0, img1]), torch.cat([img1, img0]),
                          levels, iters, radius)
    f01, f10 = flows[:B], flows[B:]
    w0, w1, c1, c0 = backward_warp(
        torch.cat([img0, img1, img1, img0]),
        torch.cat([t * f10, (1.0 - t) * f01, f01, f10])).split(B)
    e0 = torch.abs(c1 - img0).mean(dim=-1, keepdim=True)
    e1 = torch.abs(c0 - img1).mean(dim=-1, keepdim=True)
    a0 = (1.0 - t) / (1.0 + e0)
    a1 = t / (1.0 + e1)
    return (a0 * w0 + a1 * w1) / (a0 + a1)


def _interp(levels: int, iters: int, interp_fn: Optional[Callable]
            ) -> Callable:
    return interp_fn or (lambda a, b, t: interpolate_pair(a, b, t, levels,
                                                          iters))


def frame_double_pairs(frames: torch.Tensor, levels: int = 4,
                       iters: int = 3,
                       interp_fn: Optional[Callable] = None) -> torch.Tensor:
    """(K, H, W, C) keyframes → (2K−1, H, W, C) with the midpoint of
    each pair (one pass of the reference's recursive doubling), from
    ``interp_fn(img0, img1, t)`` over all pairs as one batch (default:
    LK, :func:`interpolate_pair`)."""
    mids = _interp(levels, iters, interp_fn)(frames[:-1], frames[1:], 0.5)
    K, H, W, C = frames.shape
    out = torch.stack([frames[:-1], mids.to(frames.dtype)], dim=1)
    return torch.cat([out.reshape(2 * (K - 1), H, W, C), frames[-1:]])


def train_background(frames: torch.Tensor, levels: int = 4, iters: int = 3,
                     interp_fn: Optional[Callable] = None) -> torch.Tensor:
    """(F, H, W, C) real frames → (F, H, W, C) surrogate backgrounds:
    frame i+1's from frames i and i+2, skipping the true middle frame,
    so the renderer never sees a perfect background; the ends copy their
    neighbours'."""
    mids = _interp(levels, iters, interp_fn)(frames[:-2], frames[2:], 0.5)
    return torch.cat([mids[:1], mids, mids[-1:]])


def upsample_background(frames: torch.Tensor, rate: int, levels: int = 4,
                        iters: int = 3,
                        interp_fn: Optional[Callable] = None,
                        flow_scale: int = 1,
                        max_disp: int = 16,
                        slomo: Optional[Callable] = None) -> torch.Tensor:
    """(K, H, W, C) keyframes → ((K-1)·rate+1, H, W, C) backgrounds.

    Flow is estimated once per keyframe pair in both directions; every
    in-between time t = j/rate blends the two warped keyframes by
    (1−t, t), each weighted down by its forward-backward consistency
    error.  ``flow_scale > 1`` (the serving pipeline's setting) estimates
    the flow and the errors at 1/flow_scale resolution, upsamples them,
    and warps with the clipped shift warp (``max_disp``);
    ``flow_scale == 1`` (the JAX function's default, which the serving
    CLIs use) works at full resolution with the bilinear warp.

    A midpoint-only ``interp_fn`` (the learned UNet) takes recursive
    doubling instead, :func:`frame_double_pairs` log2(rate) times; the
    rate must then be a power of two.  An arbitrary-time ``slomo``
    (``slomo(keys, rate)`` over (N, K, H, W, C) clips: Super SloMo)
    estimates the flows once per pair and makes every in-between time
    in one batch, at any rate ≥ 2."""
    if slomo is not None:
        return slomo(frames[None], rate)[0]
    if interp_fn is not None:
        times = int(rate).bit_length() - 1
        if 2 ** times != rate:
            raise ValueError(f"rate {rate}: a learned interp_fn doubles, so "
                             "the rate must be a power of two")
        for _ in range(times):
            frames = frame_double_pairs(frames, levels, iters, interp_fn)
        return frames
    K, H, W, C = frames.shape
    if K < 2 or rate < 2:
        return frames
    p0, p1 = frames[:-1], frames[1:]
    a = torch.cat([p0, p1])
    b = torch.cat([p1, p0])
    if flow_scale > 1:
        hs, ws = H // flow_scale, W // flow_scale
        a_s = resize_bilinear(a, hs, ws)
        b_s = resize_bilinear(b, hs, ws)
        flows_s = estimate_flow(a_s, b_s, levels, iters)
        flows = flow_scale * resize_bilinear(flows_s, H, W)
        # low-res flow is in low-res pixels: the bound scales by
        # 1/flow_scale
        disp_s = max(1, -(-max_disp // flow_scale))
        c_s = backward_warp_shift(b_s, flows_s, disp_s)
        e_s = torch.abs(c_s - a_s).mean(dim=-1, keepdim=True)
        errs = resize_bilinear(e_s, H, W)
        warp = lambda x, f: backward_warp_shift(x, f, max_disp)
    else:
        flows = estimate_flow(a, b, levels, iters)
        errs = torch.abs(backward_warp(b, flows) - a).mean(dim=-1,
                                                           keepdim=True)
        warp = backward_warp
    e0, e1 = errs[:K - 1], errs[K - 1:]
    f01, f10 = flows[:K - 1], flows[K - 1:]

    T = rate - 1
    t = (torch.arange(1, rate, dtype=torch.float32, device=frames.device)
         / rate).reshape(T, 1, 1, 1, 1)
    rep = lambda x: x[None].expand(T, *x.shape).reshape(-1, *x.shape[1:])
    flat = lambda x: x.reshape(T * (K - 1), *x.shape[2:])
    w0 = warp(rep(p0), flat(t * f10))
    w1 = warp(rep(p1), flat((1.0 - t) * f01))
    a0 = (1.0 - t) / (1.0 + e0)
    a1 = t / (1.0 + e1)
    w0 = w0.reshape(T, K - 1, H, W, C)
    w1 = w1.reshape(T, K - 1, H, W, C)
    mids = (a0 * w0 + a1 * w1) / (a0 + a1)          # (T, K-1, H, W, C)

    grp = torch.cat([frames[:-1, None], mids.transpose(0, 1)], dim=1)
    return torch.cat([grp.reshape((K - 1) * rate, H, W, C), frames[-1:]])
