"""GAN training losses of the renderer.

Port of the JAX package's ``renderloom/train/gan_losses.py``:

* hinge / least-square / non-saturated / wasserstein GAN loss, averaged
  per scale then across scales;
* feature matching: L1 over every D feature against the detached real
  feature, weighted 1/num_scales;
* masked L1: ``(9·fg_masked + global) / 10``;
* mask regularizer: L1 of the mask and its x/y differences, over 4HW,
  times the 3 channels the reference repeats the mask to.

Every function optionally takes a per-sample ``weight`` (the hand-crop
validity gate).  Reductions run in float32.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F


def _weighted_mean(x: torch.Tensor,
                   weight: Optional[torch.Tensor]) -> torch.Tensor:
    if weight is None:
        return x.float().mean()
    w = weight.reshape((-1,) + (1,) * (x.dim() - 1)).expand(x.shape)
    return ((x * w).float().sum()
            / torch.clamp(w.float().sum(), min=1.0))


def gan_loss_single(logits: torch.Tensor, t_real: bool, dis_update: bool,
                    mode: str = "hinge",
                    weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One scale's GAN loss."""
    logits = logits.float()
    if mode == "hinge":
        if dis_update:
            if t_real:
                return _weighted_mean(F.relu(1.0 - logits), weight)
            return _weighted_mean(F.relu(1.0 + logits), weight)
        return -_weighted_mean(logits, weight)
    if mode == "least_square":
        target = 1.0 if t_real else 0.0
        return 0.5 * _weighted_mean((logits - target) ** 2, weight)
    if mode == "non_saturated":
        target = 1.0 if t_real else 0.0
        loss = (torch.clamp(logits, min=0) - logits * target
                + torch.log1p(torch.exp(-logits.abs())))
        return _weighted_mean(loss, weight)
    if mode == "wasserstein":
        return (-1.0 if t_real else 1.0) * _weighted_mean(logits, weight)
    raise ValueError(f"unknown gan mode {mode!r}")


def gan_loss(outputs: List[torch.Tensor], t_real: bool, dis_update: bool,
             mode: str = "hinge",
             weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale-averaged GAN loss."""
    losses = [gan_loss_single(o, t_real, dis_update, mode, weight)
              for o in outputs]
    return sum(losses) / len(losses)


def feature_matching_loss(fake_feats: List[List[torch.Tensor]],
                          real_feats: List[List[torch.Tensor]],
                          weight: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Σ_scales Σ_layers L1(fake, detached real) / num_scales."""
    num_d = len(fake_feats)
    total = 0.0
    for f_list, r_list in zip(fake_feats, real_feats):
        for f, r in zip(f_list, r_list):
            total = total + _weighted_mean((f - r.detach()).abs(),
                                           weight) / num_d
    return total


def masked_l1_image(pred: torch.Tensor, fg_mask: torch.Tensor,
                    target: torch.Tensor, alpha: float = 9.0) -> torch.Tensor:
    """(α·fg-masked + global) / (1 + α) L1; fg_mask (B, H, W, 1)."""
    global_loss = (pred - target).abs().float().mean()
    mask3 = fg_mask.expand(pred.shape)
    n = mask3.float().sum()
    masked = ((pred * mask3 - target * mask3).abs().float().sum()
              / torch.clamp(n, min=1.0))
    masked = torch.where(n < 1, torch.zeros_like(masked), masked)
    return (masked * alpha + global_loss) / (1.0 + alpha)


def mask_regulation_loss(mask: torch.Tensor,
                         repeat_channels: int = 3) -> torch.Tensor:
    """(‖∂x m‖₁ + ‖∂y m‖₁ + ‖m‖₁) · repeat_channels / 4HW for a
    (B, H, W, 1) mask."""
    H, W = mask.shape[1], mask.shape[2]
    dx = mask[:, :, 1:, :] - mask[:, :, :-1, :]
    dy = mask[:, 1:, :, :] - mask[:, :-1, :, :]
    total = (dx.abs().float().sum() + dy.abs().float().sum()
             + mask.abs().float().sum())
    return total * repeat_channels / (H * W * 4.0)
