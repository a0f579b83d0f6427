"""Image ops of the serving and training paths in plain PyTorch: the
window affine (ShiftScaleRotate matrices, inverse-map bilinear warp,
keypoint transform), separable resize, bilinear sampling, gaussian
blur, the bilinear resize of ``jax.image.resize`` and SSIM.  Frozen copy
of the port's ``ops/image.py``.  Images are NHWC (or HWC) float32;
affine matrices are (..., 2, 3) with ``[x', y']ᵀ = M @ [x, y, 1]ᵀ``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def shift_scale_rotate_matrix(height: int, width: int,
                              shift_x: torch.Tensor, shift_y: torch.Tensor,
                              scale: torch.Tensor,
                              angle_deg: torch.Tensor) -> torch.Tensor:
    """Forward (..., 2, 3) affine, albumentations ShiftScaleRotate:
    rotate by ``angle_deg`` about the image center, scale by
    ``1 + scale``, then translate by ``(shift_x·W, shift_y·H)``."""
    theta = angle_deg * (math.pi / 180.0)
    s = 1.0 + scale
    cos, sin = torch.cos(theta) * s, torch.sin(theta) * s
    cx, cy = width / 2.0, height / 2.0
    tx = cx - cos * cx + sin * cy + shift_x * width
    ty = cy - sin * cx - cos * cy + shift_y * height
    return torch.stack([torch.stack([cos, -sin, tx], -1),
                        torch.stack([sin, cos, ty], -1)], -2)


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert (..., 2, 3) affine matrices."""
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return torch.stack([torch.stack([ia, ib, itx], -1),
                        torch.stack([ic, id_, ity], -1)], -2)


def resize_matrix(src_h: int, src_w: int, dst_h: int, dst_w: int,
                  device=None) -> torch.Tensor:
    """Affine of a plain resize (the A.Resize stage)."""
    return torch.tensor([[dst_w / src_w, 0.0, 0.0],
                         [0.0, dst_h / src_h, 0.0]], dtype=torch.float32,
                        device=device)


def compose_affine(m2: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """m2 ∘ m1 for (..., 2, 3) matrices."""
    row = torch.zeros(m1.shape[:-2] + (1, 3), dtype=m1.dtype,
                      device=m1.device)
    row[..., 2] = 1.0
    a = torch.cat([m1, row], dim=-2)
    b = torch.cat([m2, row.expand(m2.shape[:-2] + (1, 3))], dim=-2)
    return (b @ a)[..., :2, :]


def transform_keypoints(kps: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., J, 2) xy through the forward affine m (..., 2, 3)."""
    e = lambda i, j: m[..., i, j, None]
    x = e(0, 0) * kps[..., 0] + e(0, 1) * kps[..., 1] + e(0, 2)
    y = e(1, 0) * kps[..., 0] + e(1, 1) * kps[..., 1] + e(1, 2)
    return torch.stack([x, y], dim=-1)


def affine_warp(img: torch.Tensor, m: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
    """Warp (B, H, W, C) images by their forward affines m (B, 2, 3)
    through inverse-map bilinear sampling into (B, height, width, C);
    reads outside the source are zero (BORDER_CONSTANT 0)."""
    inv = invert_affine(m)
    ys = torch.arange(height, dtype=torch.float32, device=img.device)
    xs = torch.arange(width, dtype=torch.float32, device=img.device)
    ys, xs = ys[:, None], xs[None, :]
    e = lambda i, j: inv[:, i, j, None, None]
    src_x = e(0, 0) * xs + e(0, 1) * ys + e(0, 2)
    src_y = e(1, 0) * xs + e(1, 1) * ys + e(1, 2)
    return bilinear_sample(img, src_x, src_y, mode="constant")


def bilinear_sample(img: torch.Tensor, sx: torch.Tensor,
                    sy: torch.Tensor, mode: str = "nearest") -> torch.Tensor:
    """Bilinear sample of (B, H, W, C) images at float coordinates
    ``sx``/``sy`` (B, Ho, Wo).  ``mode="nearest"`` clamps the
    coordinates to the image (out-of-range positions read edge values);
    ``"constant"`` zeroes each corner that falls outside."""
    if mode not in ("nearest", "constant"):
        raise ValueError(f"unknown mode {mode!r}")
    B, H, W, C = img.shape
    if mode == "nearest":
        sx = torch.clamp(sx, 0.0, W - 1.0)
        sy = torch.clamp(sy, 0.0, H - 1.0)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[..., None]
    wy = (sy - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    flat = img.reshape(B, H * W, C)

    def corner(yi, xi):
        idx = (torch.clamp(yi, 0, H - 1) * W
               + torch.clamp(xi, 0, W - 1)).reshape(B, -1, 1)
        vals = torch.gather(flat, 1, idx.expand(-1, -1, C))
        vals = vals.reshape(*yi.shape, C)
        if mode == "constant":
            inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            vals = vals * inside[..., None]
        return vals

    return ((1 - wx) * (1 - wy) * corner(y0i, x0i)
            + wx * (1 - wy) * corner(y0i, x0i + 1)
            + (1 - wx) * wy * corner(y0i + 1, x0i)
            + wx * wy * corner(y0i + 1, x0i + 1))


def _axis_resample_weights(src: int, out: int,
                           inv_scale: np.float32) -> np.ndarray:
    """(out, src) bilinear resample weights for ``src_x = x'·inv_scale``;
    out-of-range taps contribute zero (BORDER_CONSTANT)."""
    xs = np.arange(out, dtype=np.float32) * np.float32(inv_scale)
    x0 = np.floor(xs)
    w = (xs - x0).astype(np.float32)
    x0i = x0.astype(np.int64)
    mat = np.zeros((out, src), np.float32)
    rows = np.arange(out)
    lo_in = (x0i >= 0) & (x0i < src)
    hi_in = (x0i + 1 >= 0) & (x0i + 1 < src)
    mat[rows[lo_in], x0i[lo_in]] += (1.0 - w)[lo_in]
    mat[rows[hi_in], np.clip(x0i + 1, 0, src - 1)[hi_in]] += w[hi_in]
    return mat


def separable_resize(img: torch.Tensor, dst_h: int, dst_w: int,
                     out_h: Optional[int] = None,
                     out_w: Optional[int] = None) -> torch.Tensor:
    """Pure-scale bilinear resize of (..., H, W, C) as two matmuls with
    (out, src) weight matrices; ``out_h``/``out_w`` (default
    ``dst_h``/``dst_w``) crop the top-left window of the resized image.
    The scale is computed as the JAX function's inverse affine does
    (``d/(a·d)``, not ``1/a``) so floor crossings land identically."""
    H, W = img.shape[-3], img.shape[-2]
    out_h = dst_h if out_h is None else out_h
    out_w = dst_w if out_w is None else out_w
    a = np.float32(dst_w / W)
    d = np.float32(dst_h / H)
    det = np.float32(a * d)
    ah = torch.as_tensor(
        _axis_resample_weights(H, out_h, np.float32(a / det)),
        dtype=img.dtype, device=img.device)
    aw = torch.as_tensor(
        _axis_resample_weights(W, out_w, np.float32(d / det)),
        dtype=img.dtype, device=img.device)
    out = torch.einsum("oh,...hwc->...owc", ah, img)
    return torch.einsum("pw,...owc->...opc", aw, out)


def gaussian_kernel1d(sigma: float, radius: int,
                      device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, radius: float = 10.0) -> torch.Tensor:
    """Separable gaussian blur of (..., H, W, C) images, σ = ``radius``
    and ``2σ`` taps each side (PIL's ``GaussianBlur(radius)``), edge
    values repeated past the border."""
    sigma = float(radius)
    r = int(2 * sigma)
    k = gaussian_kernel1d(sigma, r, device=img.device).to(img.dtype)
    *lead, H, W, C = img.shape
    x = img.reshape(-1, H, W, C).permute(0, 3, 1, 2).reshape(-1, 1, H, W)
    x = F.pad(x, (0, 0, r, r), mode="replicate")
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    x = F.pad(x, (r, r, 0, 0), mode="replicate")
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    return x.reshape(-1, C, H, W).permute(0, 2, 3, 1).reshape(*lead, H, W,
                                                             C)


def resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """(B, in, out) triangle-kernel resampling weights of
    ``jax/_src/image/scale.py:compute_weight_mat`` (antialiased: the
    kernel widened by 1/scale when it downsamples) for per-sample
    ``scale`` and ``translation`` (B,) float32."""
    dev = scale.device
    inv_scale = (1.0 / scale)[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)[:, :, None]
    out_idx = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample_f = ((out_idx + 0.5) * inv_scale - translation[:, None] * inv_scale
                - 0.5)                                      # (B, out)
    in_idx = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (sample_f[:, None, :] - in_idx[None, :, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def resize_bilinear(img: torch.Tensor, height: int,
                    width: int) -> torch.Tensor:
    """(B, H, W, C) → (B, height, width, C) with the semantics of
    ``jax.image.resize(..., "bilinear")``: half-pixel centers, and a
    triangle filter widened by the scale when downsampling (antialiased;
    plain ``F.interpolate`` is not, and differs by up to 1.17 on a 4×
    downsample).  It is torch's antialiased ``F.interpolate`` on every
    device.  A bf16 image is resized in float32 and rounded back (torch has
    no antialiased bf16 resize on the CPU; JAX's rounds its weights and a
    partial product to bf16, a rounding-level difference)."""
    x = img.permute(0, 3, 1, 2)
    y = F.interpolate(x.float(), size=(height, width), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.to(img.dtype).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# PSNR / SSIM (piq-compatible)
# ---------------------------------------------------------------------------


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM (gaussian 11×11 window, σ 1.5, k1 = .01, k2 = .03, VALID
    depthwise filtering).  NHWC or HWC."""
    if pred.dim() == 3:
        pred, target = pred[None], target[None]
    k = gaussian_kernel1d(sigma, kernel_size // 2, device=pred.device)
    C = pred.shape[-1]
    win = torch.outer(k, k).to(pred.dtype).expand(C, 1, -1, -1)

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), win, groups=C)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x, mu_y = filt(pred), filt(target)
    mu_x2, mu_y2, mu_xy = mu_x ** 2, mu_y ** 2, mu_x * mu_y
    sigma_x = filt(pred * pred) - mu_x2
    sigma_y = filt(target * target) - mu_y2
    sigma_xy = filt(pred * target) - mu_xy
    ssim_map = (((2 * mu_xy + c1) * (2 * sigma_xy + c2))
                / ((mu_x2 + mu_y2 + c1) * (sigma_x + sigma_y + c2)))
    return ssim_map.mean()


def denorm_to_unit(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] → clamped [0, 1]."""
    return torch.clamp(x * 0.5 + 0.5, 0.0, 1.0)


