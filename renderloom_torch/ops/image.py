"""Image ops used by the serving path: separable resize, edge-clamped
bilinear sampling, gaussian taps and the bilinear resize of
``jax.image.resize``.

Port of the parts of the JAX package's ``renderloom/ops/image.py`` that
the clip pipeline runs.  Images are NHWC (or HWC) float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def bilinear_sample(img: torch.Tensor, sx: torch.Tensor,
                    sy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (B, H, W, C) images at float coordinates
    ``sx``/``sy`` (B, Ho, Wo), clamped to the image (``mode="nearest"``
    of the JAX function: out-of-range positions read edge values)."""
    B, H, W, C = img.shape
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
        return vals.reshape(*yi.shape, C)

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


def resize_bilinear(img: torch.Tensor, height: int,
                    width: int) -> torch.Tensor:
    """(B, H, W, C) → (B, height, width, C) with the semantics of
    ``jax.image.resize(..., "bilinear")``: half-pixel centers, and a
    triangle filter widened by the scale when downsampling (antialiased;
    plain ``F.interpolate`` is not, and differs by up to 1.17 on a 4×
    downsample)."""
    x = img.permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(height, width), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)
