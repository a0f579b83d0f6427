"""Serving pipeline: motion upsample → flow backgrounds → label
rasterization → segment rollout + compositing, over N clips.  Frozen
copy of the port's ``eval/pipeline.py`` (``assemble_keyframe_stream``,
``make_pipeline_fn``); the reference's models are built by
:mod:`rlbench.reference.build`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from rlbench.reference.data.hsm import prepare_batch
from rlbench.reference.eval.motion_infer import (MotionInterpolator,
                                                bucket_length,
                                                make_interpolator)
from rlbench.reference.ops.flow import upsample_background
from rlbench.reference.ops.image import separable_resize


def assemble_keyframe_stream(keys: torch.Tensor, rate: int) -> torch.Tensor:
    """Spread K keyframes (..., K, H, W, C) into an L = (K−1)·rate + 1
    frame stream with zeros at the in-between slots."""
    *lead, K, H, W, C = keys.shape
    z = keys.new_zeros((*lead, K - 1, rate - 1, H, W, C))
    grp = torch.cat([keys[..., :-1, None, :, :, :], z], dim=-4)
    flat = grp.reshape(*lead, (K - 1) * rate, H, W, C)
    return torch.cat([flat, keys[..., -1:, :, :, :]], dim=-4)


# the background flow the pipeline runs: quarter-resolution pyramidal LK,
# three levels, one iteration (the JAX pipeline's quality-validated
# serving setting)
FLOW = dict(levels=3, iters=1, flow_scale=4)


def make_pipeline_fn(interp: MotionInterpolator, rollout: Callable,
                     data_cfg, rate: int, keyframes: int, *,
                     packed_label: bool = False, label_bf16: bool = False,
                     src_size: Optional[Tuple[int, int]] = None
                     ) -> Callable:
    """The clip-interpolation pipeline as one callable.

    Returns ``fn(motion, conf, keys) -> (fused, sync)`` over clips::

        motion (N, 19, 2, K)   keyframe joints, normalized units
        conf   (N, 19, 1, K)   per-joint confidences
        keys   (N, K, H, W, 3) keyframe RGB in [0, 1]

    ``fused`` is (N, L, H, W, 3) with L = (K−1)·rate + 1 and ``sync`` a
    scalar checksum of it.  ``src_size`` set: keyframes come at another
    (e.g. on-disk) resolution and are resized once at ingest.
    ``packed_label`` / ``label_bf16``: the label stream parity-packed
    (B, L, H/2, W/2, 88) / stored in bf16, for a rollout over the
    parity-layout generator (:func:`build_pipeline` ``fastpath``).
    """
    H, W = data_cfg.model_height, data_cfg.model_width
    L = (keyframes - 1) * rate + 1
    times = int(np.log2(rate))
    interp_pad = bucket_length(L, rate)

    def body(motion: torch.Tensor, conf: torch.Tensor, keys: torch.Tensor):
        if src_size is not None:
            keys = separable_resize(keys, H, W)
        pred, _, dconf = interp._run(motion, conf, rate, times, interp_pad)
        # one clip at a time, as the JAX pipeline's lax.map: the flow
        # temporaries of one clip are live at once, not all clips'
        backs = torch.stack([upsample_background(k, rate, **FLOW)
                             for k in keys])
        poses = torch.cat([pred[..., :L] * 256 + 256, dconf], dim=2)
        poses = poses.permute(0, 3, 1, 2).float()
        images = assemble_keyframe_stream(keys * 255.0, rate)
        prep = prepare_batch({"images": images, "dain": backs * 255.0,
                              "poses": poses}, data_cfg,
                             label_dtype=torch.bfloat16 if label_bf16
                             else None, packed_label=packed_label,
                             want_masks=False)
        fused, _ = rollout({"label": prep["label"], "back": prep["back"],
                            "key_img": prep["image"]})
        return fused, fused.sum() * 1e-20

    return torch.inference_mode()(body)
