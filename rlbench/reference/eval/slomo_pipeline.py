"""The serving pipeline with Super SloMo's backgrounds in place of
Lucas-Kanade's: the reference's motion interpolator, preparation and
segment rollout (:mod:`rlbench.reference.eval.pipeline`'s stages, which
this module composes and does not change) around
:class:`rlbench.reference.models.superslomo.SuperSloMo`, one clip at a
time.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from rlbench.reference.data.hsm import prepare_batch
from rlbench.reference.eval.motion_infer import (MotionInterpolator,
                                                bucket_length)
from rlbench.reference.eval.pipeline import assemble_keyframe_stream
from rlbench.reference.models.superslomo import SuperSloMo


def make_pipeline_fn(interp: MotionInterpolator, rollout: Callable,
                     slomo: SuperSloMo, data_cfg, rate: int,
                     keyframes: int) -> Callable:
    """``fn(motion, conf, keys) -> fused`` of one clip (N = 1): motion
    (1, 19, 2, K), conf (1, 19, 1, K), keys (1, K, H, W, 3) in [0, 1];
    fused (1, L, H, W, 3), L = (K−1)·rate + 1."""
    L = (keyframes - 1) * rate + 1
    times = int(np.log2(rate))
    interp_pad = bucket_length(L, rate)

    @torch.inference_mode()
    def fn(motion: torch.Tensor, conf: torch.Tensor, keys: torch.Tensor):
        pred, _, dconf = interp._run(motion, conf, rate, times, interp_pad)
        backs = slomo.backgrounds(keys[0], rate)[None]
        poses = torch.cat([pred[..., :L] * 256 + 256, dconf], dim=2)
        poses = poses.permute(0, 3, 1, 2).float()
        images = assemble_keyframe_stream(keys * 255.0, rate)
        prep = prepare_batch({"images": images, "dain": backs * 255.0,
                              "poses": poses}, data_cfg, want_masks=False)
        fused, _ = rollout({"label": prep["label"], "back": prep["back"],
                            "key_img": prep["image"]})
        return fused

    return fn
