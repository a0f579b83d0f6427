"""Pose geometry of motion inference: frame doubling of keyframe poses,
root-relative coordinates and normalization.  Frozen copy of the
inference half of the port's ``ops/pose.py``.  A motion clip is
(..., J, D, L): joints × coordinate dim × time.
"""

from __future__ import annotations

from typing import Optional

import torch

ROOT_2D = 8   # openpose mid-hip row


def localize(motion: torch.Tensor, root_idx: int) -> torch.Tensor:
    """Root-relative joints with the root row removed and the absolute
    root trajectory appended as the last row."""
    centers = motion[..., root_idx:root_idx + 1, :, :]
    rel = motion - centers
    return torch.cat([rel[..., :root_idx, :, :], rel[..., root_idx + 1:, :, :],
                      centers], dim=-3)


def globalize(motion: torch.Tensor, root_idx: int) -> torch.Tensor:
    """Inverse of :func:`localize`."""
    centers = motion[..., -1:, :, :]
    rel = motion[..., :-1, :, :]
    zero = torch.zeros_like(rel[..., :1, :, :])
    full = torch.cat([rel[..., :root_idx, :, :], zero,
                      rel[..., root_idx:, :, :]], dim=-3)
    return full + centers


def normalize(motion: torch.Tensor, mean: torch.Tensor,
              std: torch.Tensor) -> torch.Tensor:
    """(motion − mean) / std with (J, D) statistics."""
    return (motion - mean[..., None]) / std[..., None]


def denormalize(motion: torch.Tensor, mean: torch.Tensor,
                std: torch.Tensor) -> torch.Tensor:
    return motion * std[..., None] + mean[..., None]


def _interleave(data: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
    """[d0, m0, d1, m1, ..., d_{L-1}] along the last axis."""
    pairs = torch.stack([data[..., :-1], mid], dim=-1)
    return torch.cat([pairs.flatten(-2), data[..., -1:]], dim=-1)


def frame_double(data: torch.Tensor, mask: torch.Tensor,
                 conf: Optional[torch.Tensor] = None):
    """One linear frame-doubling pass, L → 2L − 1.  ``mask`` is (L,);
    midpoints take the mask of the next frame."""
    out = _interleave(data, (data[..., 1:] + data[..., :-1]) / 2)
    new_mask = _interleave(mask, mask[1:])
    new_conf = None
    if conf is not None:
        new_conf = _interleave(conf, (conf[..., 1:] + conf[..., :-1]) / 2)
    return out, new_mask, new_conf


def interpolate_frames(data: torch.Tensor, mask: torch.Tensor,
                       conf: Optional[torch.Tensor] = None, times: int = 1):
    """Repeated frame doubling, L → 2^times·(L − 1) + 1."""
    for _ in range(times):
        data, mask, conf = frame_double(data, mask, conf)
    return data, mask, conf


def encoder_mask_from_pad(pad_mask: torch.Tensor, rate: int) -> torch.Tensor:
    """Keyframe visibility, True = hidden from the encoder: every
    ``rate``-th frame is visible unless padded."""
    idx = torch.arange(pad_mask.shape[-1], device=pad_mask.device)
    return ((idx % rate) != 0) | pad_mask.bool()
