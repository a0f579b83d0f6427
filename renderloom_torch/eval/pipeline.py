"""Serving pipeline: motion upsample → flow backgrounds → label
rasterization → segment rollout + compositing, over N clips.

Port of the JAX package's ``renderloom/eval/pipeline.py``
(``assemble_keyframe_stream``, ``make_pipeline_fn``, ``build_pipeline``).
The stages run eagerly on one device; on the card the label raster and
every instance norm are the port's CUDA kernels.  :class:`PipelineModule`
is the unit ``renderloom_torch.eval.export`` freezes.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from renderloom_torch.data.hsm import prepare_batch
from renderloom_torch.eval.motion_infer import (MotionInterpolator,
                                                bucket_length,
                                                make_interpolator)
from renderloom_torch.ops.flow import upsample_background
from renderloom_torch.ops.image import separable_resize
from renderloom_torch.train.gan import (make_inference_pair,
                                        make_segment_rollout,
                                        set_float32_precision)
from renderloom_torch.utils.profiling import annotate


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
    Under a profiler the stages are the spans ``pipeline.motion``,
    ``pipeline.background``, ``pipeline.label`` and ``pipeline.rollout``
    (:func:`renderloom_torch.utils.profiling.annotate`).
    """
    H, W = data_cfg.model_height, data_cfg.model_width
    L = (keyframes - 1) * rate + 1
    times = int(np.log2(rate))
    interp_pad = bucket_length(L, rate)

    def body(motion: torch.Tensor, conf: torch.Tensor, keys: torch.Tensor):
        with annotate("pipeline.motion"):
            if src_size is not None:
                keys = separable_resize(keys, H, W)
            pred, _, dconf = interp._run(motion, conf, rate, times,
                                         interp_pad)
        with annotate("pipeline.background"):
            # one clip at a time, as the JAX pipeline's lax.map: the flow
            # temporaries of one clip are live at once, not all clips'
            backs = torch.stack([upsample_background(k, rate, **FLOW)
                                 for k in keys])
        with annotate("pipeline.label"):
            poses = torch.cat([pred[..., :L] * 256 + 256, dconf], dim=2)
            poses = poses.permute(0, 3, 1, 2).float()
            images = assemble_keyframe_stream(keys * 255.0, rate)
            prep = prepare_batch({"images": images, "dain": backs * 255.0,
                                  "poses": poses}, data_cfg,
                                 label_dtype=torch.bfloat16 if label_bf16
                                 else None, packed_label=packed_label,
                                 want_masks=False)
        with annotate("pipeline.rollout"):
            fused, _ = rollout({"label": prep["label"],
                                "back": prep["back"],
                                "key_img": prep["image"]})
            return fused, fused.sum() * 1e-20

    pipeline = torch.inference_mode()(body)
    pipeline.body = body        # what PipelineModule traces
    return pipeline


class PipelineModule(nn.Module):
    """:func:`make_pipeline_fn`'s callable as a module that holds the
    motion transformer and the generator, so that ``torch.export``
    lifts their weights into the program.  ``forward(motion, conf,
    keys) -> (fused, sync)`` runs the callable's body without the live
    callable's ``torch.inference_mode`` (``torch.export`` cannot trace
    inference tensors; it traces under ``torch.no_grad``); the per-clip
    loop unrolls at the traced N."""

    def __init__(self, fn: Callable, motion_model: nn.Module,
                 gen: nn.Module):
        super().__init__()
        self.motion_model = motion_model
        self.gen = gen
        self._body = fn.body

    def forward(self, motion: torch.Tensor, conf: torch.Tensor,
                keys: torch.Tensor):
        return self._body(motion, conf, keys)


def build_pipeline(mcfg, rcfg, rate: int, keyframes: int, *,
                   m_params=None, g_params=None, g_stats=None,
                   mean: Optional[np.ndarray] = None,
                   std: Optional[np.ndarray] = None,
                   src_size: Optional[Tuple[int, int]] = None,
                   device="cuda", fastpath: bool = False):
    """Models and the pipeline callable from the two configs, on
    ``device`` (the card unless the caller asks for the CPU; without a
    CUDA device a CUDA request raises).

    ``fastpath``: the parity-layout generator
    (:class:`renderloom_torch.models.fastpath.FastInferenceGen`) over
    the same folded weights, and the label stream parity-packed and
    stored in bf16.  The default is the standard generator on an NHWC
    float32 label.  Each model computes in its config's
    ``compute_dtype``: ``mcfg`` and ``rcfg`` in bfloat16 with
    ``fastpath=True`` is the JAX ``build_pipeline(platform="tpu")``
    configuration that ``bench.py`` serves; without the fastpath it is
    the standard generator in bf16.

    ``m_params`` / ``g_params`` + ``g_stats``: numpy flax trees of trained
    weights (spectral norm is folded here); seeded random weights when
    omitted (motion seed 0, generator seed 1).  Returns ``(fn, motion
    model, generator)``; ``fn`` is :func:`make_pipeline_fn`'s callable.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_pipeline: no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    set_float32_precision()

    interp = make_interpolator(mcfg, m_params, mean, std, device)
    gen = make_inference_pair(rcfg, g_params, g_stats, device, fastpath)
    fn = make_pipeline_fn(interp, make_segment_rollout(gen, rate),
                          rcfg.data, rate, keyframes, packed_label=fastpath,
                          label_bf16=fastpath, src_size=src_size)
    return fn, interp.model, gen
