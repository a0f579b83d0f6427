"""Motion interpolation for serving: keyframe poses → full-rate poses.
Frozen copy of the port's ``eval/motion_infer.py`` (``bucket_length``,
``MotionInterpolator._run``, ``make_interpolator``) without the
openpose file I/O.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from rlbench.reference.convert import load_flax_params
from rlbench.reference.core.config import MotionConfig
from rlbench.reference.models.layers import cast_weights_
from rlbench.reference.models.motion_transformer import (Dense,
                                                        build_motion_model)
from rlbench.reference.ops import pose as pose_ops


def bucket_length(L: int, rate: int, granule: int = 8) -> int:
    """Smallest padded length ≥ L of the form k·rate·granule + 1."""
    segs = math.ceil((L - 1) / (rate * granule))
    return max(segs, 1) * rate * granule + 1


class MotionInterpolator:
    """A motion transformer, its normalization statistics, and the
    motion config whose ``dataset`` section gives the openpose scale and
    offset (default ``MotionConfig()``)."""

    def __init__(self, model, mean: np.ndarray, std: np.ndarray, device,
                 cfg: Optional[MotionConfig] = None):
        self.model = model
        self.cfg = cfg or MotionConfig()
        self.device = torch.device(device)
        self.mean = torch.as_tensor(np.asarray(mean, np.float32),
                                    device=device)
        self.std = torch.as_tensor(np.asarray(std, np.float32),
                                   device=device)

    def _run(self, motion: torch.Tensor, conf: torch.Tensor, rate: int,
             times: int, pad_to: int):
        """Keyframes (N, 19, 2, K), conf (N, 19, 1, K) → (pred, linear)
        global (N, 19, 2, pad_to) and the dense confidence
        (N, 19, 1, L)."""
        N, K = motion.shape[0], motion.shape[-1]
        dense, _, dense_conf = pose_ops.interpolate_frames(
            motion, torch.zeros(K, dtype=torch.bool, device=motion.device),
            conf, times)
        L = dense.shape[-1]
        padded = motion.new_zeros(dense.shape[:-1] + (pad_to,))
        padded[..., :L] = dense
        pad_mask = torch.arange(pad_to, device=motion.device) >= L

        normed = pose_ops.normalize(
            pose_ops.localize(padded, pose_ops.ROOT_2D), self.mean,
            self.std)
        enc_mask = pose_ops.encoder_mask_from_pad(pad_mask, rate)
        inputs = normed * (~enc_mask)

        seq = lambda x: x.reshape(N, -1, pad_to).transpose(1, 2)
        pred, _ = self.model(seq(inputs), enc_mask.expand(N, pad_to),
                             seq(normed), pad_mask.expand(N, pad_to), rate,
                             lengths=torch.full((N,), L,
                                                device=motion.device))

        def post(flat):
            data = flat.reshape(N, 19, 2, -1)
            data = pose_ops.denormalize(data, self.mean, self.std)
            return pose_ops.globalize(data, pose_ops.ROOT_2D)

        return (post(pred.transpose(1, 2)),
                post(normed.reshape(N, -1, pad_to)), dense_conf)


def make_interpolator(cfg: MotionConfig, params: Optional[dict],
                      mean: Optional[np.ndarray], std: Optional[np.ndarray],
                      device) -> MotionInterpolator:
    """The motion transformer of ``cfg`` on ``device`` in its compute
    dtype, with the flax tree ``params`` (seeded random weights, seed 0,
    when None), and the statistics ``mean``/``std`` (zeros/ones when
    None)."""
    model = build_motion_model(cfg)
    load_flax_params(model, params)
    model = cast_weights_(model.to(device).eval(), (Dense,))
    return MotionInterpolator(
        model, np.zeros((19, 2), np.float32) if mean is None else mean,
        np.ones((19, 2), np.float32) if std is None else std, device, cfg)
