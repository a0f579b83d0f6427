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
validity gate).  Reductions run in float32.  A loss that divides by a
count over the batch takes that count (``weight_sum``, ``count``) where
the caller gives it.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F


def _weighted_mean(x: torch.Tensor, weight: Optional[torch.Tensor],
                   weight_sum: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Σ x·w over Σ w, w the per-sample ``weight`` broadcast over each
    sample; ``weight_sum``, where given, replaces Σ weight (at least 1)."""
    if weight is None:
        return x.float().mean()
    w = weight.reshape((-1,) + (1,) * (x.dim() - 1)).expand(x.shape)
    n = (torch.clamp(w.float().sum(), min=1.0) if weight_sum is None
         else weight_sum * (x.numel() // x.shape[0]))
    return (x * w).float().sum() / n


def gan_loss_single(logits: torch.Tensor, t_real: bool, dis_update: bool,
                    mode: str = "hinge",
                    weight: Optional[torch.Tensor] = None,
                    weight_sum: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """One scale's GAN loss."""
    logits = logits.float()
    mean = lambda x: _weighted_mean(x, weight, weight_sum)
    if mode == "hinge":
        if dis_update:
            if t_real:
                return mean(F.relu(1.0 - logits))
            return mean(F.relu(1.0 + logits))
        return -mean(logits)
    if mode == "least_square":
        target = 1.0 if t_real else 0.0
        return 0.5 * mean((logits - target) ** 2)
    if mode == "non_saturated":
        target = 1.0 if t_real else 0.0
        loss = (torch.clamp(logits, min=0) - logits * target
                + torch.log1p(torch.exp(-logits.abs())))
        return mean(loss)
    if mode == "wasserstein":
        return (-1.0 if t_real else 1.0) * mean(logits)
    raise ValueError(f"unknown gan mode {mode!r}")


def gan_loss(outputs: List[torch.Tensor], t_real: bool, dis_update: bool,
             mode: str = "hinge",
             weight: Optional[torch.Tensor] = None,
             weight_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale-averaged GAN loss."""
    losses = [gan_loss_single(o, t_real, dis_update, mode, weight,
                              weight_sum)
              for o in outputs]
    return sum(losses) / len(losses)


def feature_matching_loss(fake_feats: List[List[torch.Tensor]],
                          real_feats: List[List[torch.Tensor]],
                          weight: Optional[torch.Tensor] = None,
                          weight_sum: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Σ_scales Σ_layers L1(fake, detached real) / num_scales."""
    num_d = len(fake_feats)
    total = 0.0
    for f_list, r_list in zip(fake_feats, real_feats):
        for f, r in zip(f_list, r_list):
            total = total + _weighted_mean((f - r.detach()).abs(),
                                           weight, weight_sum) / num_d
    return total


def masked_l1_image(pred: torch.Tensor, fg_mask: torch.Tensor,
                    target: torch.Tensor, alpha: float = 9.0,
                    count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(α·fg-masked + global) / (1 + α) L1; fg_mask (B, H, W, 1).  The
    masked term divides by ``count`` where given, else by the masked
    elements' count (at least 1)."""
    global_loss = (pred - target).abs().float().mean()
    mask3 = fg_mask.expand(pred.shape)
    n = mask3.float().sum()
    masked = ((pred * mask3 - target * mask3).abs().float().sum()
              / (torch.clamp(n, min=1.0) if count is None else count))
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
