"""Face and hand crops driven by the pose heatmaps of the label, at
static shapes.

Port of the JAX package's ``renderloom/ops/crops.py``:

* face: bbox of the nose heatmap (label channel 3), a square side 2.5×
  the bbox width clamped to [32, W], or a fixed box when the nose has no
  support; the crop and its bilinear resize to the static ``H//32·8``
  square are ``jax.image.scale_and_translate`` with a per-sample scale
  and translation.  That call antialiases when it downsamples (a
  triangle kernel widened by 1/scale), which no single torch call
  reproduces, so the two separable weight matrices of each sample
  (``ops.image.resample_weights``) are applied with ``einsum``; the
  gradient reaches the image;
* hands: static ``H//64·8`` squares around each hand heatmap's bbox
  center (channels 20, 21), sliced at a start clamped into the image as
  ``jax.lax.dynamic_slice`` clamps it; a hand without support gives a
  zero validity flag.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rlbench.reference.ops.image import resample_weights

HEAT_THRES = 3.35e-4          # exp(-8): the 4-sigma support boundary
FACE_CHANNEL = 3              # label = 3ch skeleton + 19 heatmaps → ch 3
HAND_CHANNELS = (-2, -1)      # joints 17 (right hand), 18 (left hand)
_BIG = 2 ** 31 - 1


def _masked_bbox(active: torch.Tensor):
    """(B, H, W) bool → per sample (ys, ye, xs, xe) int64 and found."""
    B, H, W = active.shape
    row_any = active.any(dim=2)
    col_any = active.any(dim=1)
    ys_idx = torch.arange(H, device=active.device)
    xs_idx = torch.arange(W, device=active.device)
    big = torch.full((), _BIG, dtype=torch.long, device=active.device)
    neg = torch.full((), -1, dtype=torch.long, device=active.device)
    ys = torch.where(row_any, ys_idx, big).min(dim=1).values
    ye = torch.where(row_any, ys_idx, neg).max(dim=1).values
    xs = torch.where(col_any, xs_idx, big).min(dim=1).values
    xe = torch.where(col_any, xs_idx, neg).max(dim=1).values
    return ys, ye, xs, xe, row_any.any(dim=1)


def face_crop(image: torch.Tensor, label: torch.Tensor,
              thres: float = HEAT_THRES) -> torch.Tensor:
    """(B, H, W, C≥3) image + (B, H, W, 22) label → (B, S, S, 3) face
    crops, S = H//32·8, from the image's last 3 channels."""
    B, H, W, _ = image.shape
    S = H // 32 * 8
    ys, ye, xs, xe, found = _masked_bbox(label[..., FACE_CHANNEL] > thres)
    xc = (xs + xe) // 2
    yc = (ys * 3 + ye * 2) // 5
    side = torch.clamp(((xe - xs) * 5) // 2, 32, W)
    # fallback center and size when the nose has no support
    side = torch.where(found, side, torch.full_like(side, S))
    yc = torch.where(found, yc, torch.full_like(yc, H // 4))
    xc = torch.where(found, xc, torch.full_like(xc, W // 2))
    half = side // 2
    yc = torch.minimum(torch.maximum(yc, half), H - 1 - half)
    xc = torch.minimum(torch.maximum(xc, half), W - 1 - half)
    y0 = (yc - half).float()
    x0 = (xc - half).float()
    scale = S / side.float()
    wy = resample_weights(H, S, scale, -y0 * scale).to(image.dtype)
    wx = resample_weights(W, S, scale, -x0 * scale).to(image.dtype)
    return torch.einsum("bhwc,bhs,bwt->bstc", image[..., -3:], wy, wx)


def hand_crops(image: torch.Tensor, label: torch.Tensor,
               thres: float = HEAT_THRES
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, C) image + label → ((B, 2, S, S, 3) crops, (B, 2)
    valid), S = H//64·8: both hands always cut, ``valid`` flags which
    heatmaps had support."""
    B, H, W, _ = image.shape
    S = H // 64 * 8
    dev = image.device
    rows_b = torch.arange(B, device=dev)[:, None, None]
    offs = torch.arange(S, device=dev)
    crops, valids = [], []
    for ch in HAND_CHANNELS:
        ys, ye, xs, xe, found = _masked_bbox(label[..., ch] > thres)
        yc = torch.clamp((ys + ye) // 2, S // 2, H - 1 - S // 2)
        xc = torch.clamp((xs + xe) // 2, S // 2, W - 1 - S // 2)
        zero = torch.zeros_like(yc)
        # dynamic_slice clamps its start so the window stays inside
        y0 = torch.clamp(torch.where(found, yc - S // 2, zero), 0, H - S)
        x0 = torch.clamp(torch.where(found, xc - S // 2, zero), 0, W - S)
        rows = (y0[:, None] + offs)[:, :, None]
        cols = (x0[:, None] + offs)[:, None, :]
        crops.append(image[rows_b, rows, cols, -3:])
        valids.append(found)
    return torch.stack(crops, dim=1), torch.stack(valids, dim=1)
