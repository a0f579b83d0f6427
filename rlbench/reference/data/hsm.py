"""Frame preparation for serving and training in plain PyTorch:
[-1, 1] images and backgrounds, the 22-channel pose label, the human
mask, and the zero frame-0 background.  Frozen copy of the preparation
half of the port's ``data/hsm.py`` (no h5 reader), rasterizing with
:mod:`rlbench.reference.ops.raster`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from rlbench.reference.core.config import RendererDataConfig
from rlbench.reference.ops.image import (affine_warp, compose_affine,
                                        gaussian_blur, resize_matrix,
                                        separable_resize,
                                        shift_scale_rotate_matrix,
                                        transform_keypoints)
from rlbench.reference.ops.raster import (draw_train_tables,
                                          rasterize_frames_fused)


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    return x.float() / 127.5 - 1.0


def draw_train_randomness(generator: torch.Generator, B: int, F: int,
                          cfg: RendererDataConfig) -> Dict[str, torch.Tensor]:
    """Every random value of one train-mode preparation of B windows of
    F frames: per window a shift in [−0.0625, 0.0625), a rotation in
    [−10°, 10°) and a scale in [−0.1, 0.1) (the reference's
    ShiftScaleRotate ranges, ``_window_affine``), and the rasterizer's
    per-frame draws (:func:`draw_train_tables`, B·F frames)."""
    dev = generator.device
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(B, generator=generator,
                                                   device=dev)
    draws = {"shift": u(-0.0625, 0.0625), "angle": u(-10.0, 10.0),
             "scale": u(-0.1, 0.1)}
    draws.update(draw_train_tables(generator, B * F, cfg.gauss_sigma,
                                   cfg.random_drop_prob,
                                   cfg.random_blur_rate))
    return draws


def window_affine(draws: Dict[str, torch.Tensor], src_h: int, src_w: int,
                  cfg: RendererDataConfig) -> torch.Tensor:
    """(B, 2, 3) per-window transform: resize to load size, then the
    drawn shift (the same along x and y), scale and rotation."""
    resize = resize_matrix(src_h, src_w, cfg.load_height, cfg.load_width,
                           device=draws["shift"].device)
    ssr = shift_scale_rotate_matrix(cfg.load_height, cfg.load_width,
                                    draws["shift"], draws["shift"],
                                    draws["scale"], draws["angle"])
    return compose_affine(ssr, resize.expand(ssr.shape))


def _label_layout(ras, B, F, H, W, packed_label):
    if packed_label:
        return ras["label"].reshape(B, F, H // 2, W // 2, 88)
    return ras["label"].reshape(B, F, H, W, 22)


def prepare_batch(batch: Dict[str, torch.Tensor], cfg: RendererDataConfig,
                  draws: Optional[Dict[str, torch.Tensor]] = None,
                  label_dtype: Optional[torch.dtype] = None,
                  packed_label: bool = False,
                  want_masks: bool = True) -> Dict[str, torch.Tensor]:
    """``batch``: images/dain (B, F, H0, W0, 3) in [0, 255] (dain already
    shifted to t−1 per frame), poses (B, F, 19, 3) xy + conf in source
    pixels.  Returns label (B, F, H, W, 22) float32, image/back
    (B, F, H, W, 3) in [-1, 1] and the human mask ``fg_mask``
    (B, F, H, W, 1) float32 0/1.

    ``draws`` (:func:`draw_train_randomness`, on the batch's device)
    selects the train branch.  ``want_masks=False`` (serving, the
    deterministic branch only) drops ``fg_mask``, and the kernel then
    skips the mask capsules (the JAX ``want_masks``).  ``label_dtype`` (default float32) is the label
    stream's type, which the kernel casts to at the store (bf16 halves
    the label's bytes); ``packed_label`` emits it parity-packed,
    (B, F, H/2, W/2, 88) = space_to_depth of each frame's label, which
    the parity-layout generator (``models/fastpath.py``) takes as it is
    (the JAX ``prepare_batch``'s ``label_dtype``/``packed_label``)."""
    layout = dict(out_dtype=label_dtype or torch.float32,
                  layout="packed" if packed_label else "nhwc")
    if draws is not None:
        return _prepare_train(batch, cfg, draws, layout, packed_label)
    images, dain, poses = batch["images"], batch["dain"], batch["poses"]
    B, F = images.shape[:2]
    H, W = cfg.model_height, cfg.model_width
    if (images.shape[2:4] == (H, W) and cfg.load_height == H
            and cfg.load_width == W):
        # the window affine is the identity: no resample at all
        images_t, dain_t = _to_unit(images), _to_unit(dain)
        coords = poses[..., :2].float()
    else:
        # a pure resize to load size, cropped to model size
        src_h, src_w = images.shape[2:4]
        res = lambda x: separable_resize(_to_unit(x), cfg.load_height,
                                         cfg.load_width, H, W)
        images_t, dain_t = res(images), res(dain)
        scale = torch.tensor([np.float32(cfg.load_width / src_w),
                              np.float32(cfg.load_height / src_h)],
                             device=poses.device)
        coords = poses[..., :2].float() * scale
    conf = poses[..., 2]

    ras = rasterize_frames_fused(
        coords.reshape(B * F, -1, 2), conf.reshape(B * F, -1), H, W,
        gauss_sigma=cfg.gauss_sigma, thres=cfg.skeleton_thres,
        foot_thres=cfg.foot_thres, emit_masks=want_masks, **layout)
    out = {"label": _label_layout(ras, B, F, H, W, packed_label),
           "image": images_t, "back": _zero_first_back(dain_t, dain)}
    if want_masks:
        out["fg_mask"] = ras["mask"].reshape(B, F, H, W, 1)
    return out


def _zero_first_back(back: torch.Tensor, dain: torch.Tensor) -> torch.Tensor:
    """Zero the frame-0 background of a window whose host shipped a zero
    dain frame."""
    zero0 = (dain[:, 0] == 0).flatten(1).all(dim=1)
    first = torch.where(zero0[:, None, None, None], 0.0, back[:, 0])
    return torch.cat([first[:, None], back[:, 1:]], dim=1)


def _prepare_train(batch, cfg: RendererDataConfig, draws, layout,
                   packed_label):
    images, dain, poses = batch["images"], batch["dain"], batch["poses"]
    B, F, src_h, src_w = images.shape[:4]
    H, W = cfg.model_height, cfg.model_width
    m = window_affine(draws, src_h, src_w, cfg)                 # (B, 2, 3)
    m_frames = m[:, None].expand(B, F, 2, 3).reshape(B * F, 2, 3)
    warp = lambda x: affine_warp(
        _to_unit(x).reshape(B * F, src_h, src_w, -1), m_frames, H,
        W).reshape(B, F, H, W, -1)
    images_t, dain_t = warp(images), warp(dain)
    coords = transform_keypoints(poses[..., :2].float(), m[:, None])
    conf = poses[..., 2]
    tables = {k: draws[k] for k in ("sigma", "keep_j", "keep_e", "part")}
    ras = rasterize_frames_fused(
        coords.reshape(B * F, -1, 2), conf.reshape(B * F, -1), H, W,
        gauss_sigma=cfg.gauss_sigma, thres=cfg.skeleton_thres,
        foot_thres=cfg.foot_thres, emit_masks=True, draws=tables, **layout)
    part = ras["part_mask"].reshape(B, F, H, W, 1)
    back = gaussian_blur(dain_t, 10.0) * part + dain_t * (1.0 - part)
    return {"label": _label_layout(ras, B, F, H, W, packed_label),
            "image": images_t, "back": _zero_first_back(back, dain),
            "fg_mask": ras["mask"].reshape(B, F, H, W, 1)}
