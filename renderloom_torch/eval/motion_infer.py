"""Motion interpolation for serving: keyframe poses → full-rate poses.

Port of the JAX package's ``renderloom/eval/motion_infer.py``:
``bucket_length`` and ``MotionInterpolator`` with ``_run``,
``interpolate_motion`` (one clip's arrays) and ``interpolate_openpose``
(an openpose JSON folder in, the prediction's and the linear baseline's
folders out, the contract of the reference's ``evaluator.py:169-198``).
The JAX ``_run`` runs one clip and is ``vmap``-ed over clips; the
port's takes the clips as a leading batch dimension.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from renderloom_torch.convert import load_flax_params, random_init_
from renderloom_torch.core.config import MotionConfig
from renderloom_torch.data import openpose as op_io
from renderloom_torch.models.layers import cast_weights_
from renderloom_torch.models.motion_transformer import (Dense,
                                                        build_motion_model)
from renderloom_torch.ops import pose as pose_ops


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

    @torch.inference_mode()
    def interpolate_motion(self, motion: np.ndarray, conf: np.ndarray,
                           rate: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(19, 2, K) keyframe motion and (19, 1, K) confidence →
        (pred, linear, conf) at full rate: float64 (19, 2, L) joints with
        L = (K − 1)·rate + 1, and the dense (19, 1, L) confidence.

        Mirrors ``get_openpose_data`` (AMASS_dataset.py:240-264): repeated
        frame doubling builds the dense linear sequence, the encoder sees
        every ``rate``-th frame, the decoder refines the rest."""
        times = int(np.log2(rate))
        L = (motion.shape[-1] - 1) * (2 ** times) + 1
        as_t = lambda a: torch.tensor(np.asarray(a)[None],
                                      dtype=torch.float32,
                                      device=self.device)
        pred, linear, dense_conf = self._run(
            as_t(motion), as_t(conf), rate, times, bucket_length(L, rate))
        out = lambda x: x[0, :, :, :L].cpu().numpy().astype(np.float64)
        return out(pred), out(linear), dense_conf[0].float().cpu().numpy()

    def interpolate_openpose(self, json_dir: str, rate: int,
                             pred_dir: str, linear_dir: str,
                             scale: Optional[float] = None,
                             offset: Optional[float] = None):
        """JSON dir in → two JSON dirs out (prediction + linear baseline),
        the contract of evaluator.py:169-198.  ``scale``/``offset`` default
        to the config's ``openpose_scale``/``openpose_offset``."""
        d = self.cfg.dataset
        motion, conf, (scale, offset) = op_io.read_openpose_dir(
            json_dir, scale or d.openpose_scale,
            offset or d.openpose_offset)
        pred, linear, dense_conf = self.interpolate_motion(motion, conf,
                                                           rate)
        op_io.write_openpose_dir(pred, dense_conf, pred_dir, scale, offset)
        op_io.write_openpose_dir(linear, dense_conf, linear_dir, scale,
                                 offset)
        return pred, linear


def make_interpolator(cfg: MotionConfig, params: Optional[dict],
                      mean: Optional[np.ndarray], std: Optional[np.ndarray],
                      device) -> MotionInterpolator:
    """The motion transformer of ``cfg`` on ``device`` in its compute
    dtype, with the flax tree ``params`` (seeded random weights, seed 0,
    when None), and the statistics ``mean``/``std`` (zeros/ones when
    None)."""
    model = build_motion_model(cfg)
    if params is None:
        random_init_(model, 0)
    else:
        load_flax_params(model, params)
    model = cast_weights_(model.to(device).eval(), (Dense,))
    return MotionInterpolator(
        model, np.zeros((19, 2), np.float32) if mean is None else mean,
        np.ones((19, 2), np.float32) if std is None else std, device, cfg)
