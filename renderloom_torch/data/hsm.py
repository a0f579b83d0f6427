"""Frame preparation for serving: [-1, 1] images and backgrounds, the
22-channel pose label, and the zero frame-0 background.

Port of the deterministic (inference) branch of the JAX package's
``renderloom/data/hsm.py:prepare_batch`` on its fused-raster route: all
B·F frames are rasterized in one call of the label kernel
(:mod:`renderloom_torch.ops.rasterize_kernel`), which writes the NHWC
label directly.  The train branch (random window affine, part-mask
blur) and the HumanSloMo reader are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from renderloom_torch.core.config import RendererDataConfig
from renderloom_torch.ops.image import separable_resize
from renderloom_torch.ops.rasterize_kernel import rasterize_frames_fused


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    return x.float() / 127.5 - 1.0


def prepare_batch(batch: Dict[str, torch.Tensor], cfg: RendererDataConfig
                  ) -> Dict[str, torch.Tensor]:
    """``batch``: images/dain (B, F, H0, W0, 3) in [0, 255] (dain already
    shifted to t−1 per frame), poses (B, F, 19, 3) xy + conf in source
    pixels.  Returns label (B, F, H, W, 22) float32 and image/back
    (B, F, H, W, 3) in [-1, 1]."""
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
        foot_thres=cfg.foot_thres)
    label = ras["label"].reshape(B, F, H, W, 22)

    # zero the frame-0 background of a clip whose host shipped zeros
    zero0 = (dain[:, 0] == 0).flatten(1).all(dim=1)
    dain_t[:, 0] = torch.where(zero0[:, None, None, None], 0.0,
                               dain_t[:, 0])
    return {"label": label, "image": images_t, "back": dain_t}
