"""Motion interpolation for serving: keyframe poses → full-rate poses.

Port of ``MotionInterpolator._run`` and ``bucket_length`` of the JAX
package's ``renderloom/eval/motion_infer.py``.  The JAX function runs
one clip and is ``vmap``-ed over clips; :meth:`MotionInterpolator._run`
takes the clips as a leading batch dimension.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from renderloom_torch.ops import pose as pose_ops


def bucket_length(L: int, rate: int, granule: int = 8) -> int:
    """Smallest padded length ≥ L of the form k·rate·granule + 1."""
    segs = math.ceil((L - 1) / (rate * granule))
    return max(segs, 1) * rate * granule + 1


class MotionInterpolator:
    """A motion transformer and its normalization statistics."""

    def __init__(self, model, mean: np.ndarray, std: np.ndarray, device):
        self.model = model
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
