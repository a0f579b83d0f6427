"""Multi-scale patch discriminators with face and hand heads.

Port of the JAX package's ``renderloom/models/discriminator.py``:

* ``PatchDiscriminator`` — stride-2 'CNA' conv layers, then a 1-channel
  logit head; returns the logits and every layer's activation for
  feature matching;
* ``MultiPatchDiscriminator`` — the same net over progressively ×½
  bilinear-resized inputs (antialiased, as ``jax.image.resize`` is);
* ``DiscriminatorSet`` — 'fuse' (label‖image), 'raw' (foreground-masked
  generated human), 'face' and 'hand' on heatmap-driven crops.

NHWC.  Channel counts are fixed at construction from the config, as
flax infers them at init.  ``DiscriminatorSet(cfg, dtype)`` computes in
``dtype`` as the flax module's ``dtype`` (its convolutions cast their
inputs and float32 kernels to it; the affine norms return float32); the
hand crops' ``weight`` stays float32.  Spectral norm takes its training
form from :func:`rlbench.reference.models.layers.enable_spectral_norm`;
with ``update_stats`` every call of a net advances its ``u`` from the
value the previous call left, so the calls run in the JAX module's
order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from rlbench.reference.core.config import DiscriminatorConfig, PatchDiscConfig
from rlbench.reference.models.layers import (ConvBlock, SNConv,
                                            set_compute_dtype)
from rlbench.reference.ops.crops import face_crop, hand_crops
from rlbench.reference.ops.image import resize_bilinear


class PatchDiscriminator(nn.Module):
    """N-layer patch discriminator."""

    def __init__(self, cfg: PatchDiscConfig, in_ch: int):
        super().__init__()
        spectral = cfg.weight_norm_type == "spectral"
        self.num_layers = cfg.num_layers
        ch = cfg.num_filters
        self.layer0 = ConvBlock(in_ch, ch, cfg.kernel_size, 2, spectral,
                                cfg.activation_norm_type)
        for n in range(cfg.num_layers):
            out = min(ch * 2, cfg.max_num_filters)
            stride = 2 if n < cfg.num_layers - 1 else 1
            setattr(self, f"layer{n + 1}",
                    ConvBlock(ch, out, cfg.kernel_size, stride, spectral,
                              cfg.activation_norm_type))
            ch = out
        self.head = SNConv(ch, 1, 3, 1, spectral)

    def forward(self, x: torch.Tensor, update_stats: bool = False
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        feats = []
        h = x
        for n in range(self.num_layers + 1):
            h = getattr(self, f"layer{n}")(h, update_stats)
            feats.append(h)
        return self.head(h, update_stats), feats


class MultiPatchDiscriminator(nn.Module):
    """``num_discriminators`` patch nets at successive ×½ resolutions."""

    def __init__(self, cfg: PatchDiscConfig, in_ch: int):
        super().__init__()
        self.num_discriminators = cfg.num_discriminators
        for i in range(cfg.num_discriminators):
            setattr(self, f"scale{i}", PatchDiscriminator(cfg, in_ch))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> Dict:
        outputs, features = [], []
        for i in range(self.num_discriminators):
            logits, feats = getattr(self, f"scale{i}")(x, update_stats)
            outputs.append(logits)
            features.append(feats)
            if i != self.num_discriminators - 1:
                x = resize_bilinear(x, x.shape[1] // 2, x.shape[2] // 2)
        return {"output": outputs, "features": features}


class DiscriminatorSet(nn.Module):
    """Full D stack: ``forward(label, real, fake, raw, fg_mask)`` →
    ``{key: {"pred_real", "pred_fake", "weight"?}}`` with each pred a
    MultiPatch output dict.  ``raw`` is the un-composited generated
    image; ``fg_mask`` (B, H, W, 1) gates the raw pass."""

    def __init__(self, cfg: DiscriminatorConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_face, self.use_hand = cfg.use_face, cfg.use_hand
        self.net_d = MultiPatchDiscriminator(
            cfg.image, cfg.input_label_nc + cfg.input_image_nc)
        if cfg.use_face:
            self.net_d_face = MultiPatchDiscriminator(cfg.face,
                                                      cfg.input_image_nc)
        if cfg.use_hand:
            self.net_d_hand = MultiPatchDiscriminator(cfg.hand,
                                                      cfg.input_image_nc)
        set_compute_dtype(self, dtype)

    def forward(self, label, real, fake, raw, fg_mask,
                update_stats: bool = False) -> Dict:
        out = {}
        cat = lambda img: torch.cat([label, img], dim=-1)
        out["fuse"] = {"pred_real": self.net_d(cat(real), update_stats),
                       "pred_fake": self.net_d(cat(fake), update_stats)}
        out["raw"] = {
            "pred_real": self.net_d(cat(real * fg_mask), update_stats),
            "pred_fake": self.net_d(cat(raw * fg_mask), update_stats)}
        if self.use_face:
            out["face"] = {
                "pred_real": self.net_d_face(face_crop(real, label),
                                             update_stats),
                "pred_fake": self.net_d_face(face_crop(raw, label),
                                             update_stats)}
        if self.use_hand:
            real_h, valid = hand_crops(real, label)      # (B, 2, S, S, 3)
            raw_h, _ = hand_crops(raw, label)
            flat = lambda v: v.reshape((-1,) + v.shape[2:])
            out["hand"] = {
                "pred_real": self.net_d_hand(flat(real_h), update_stats),
                "pred_fake": self.net_d_hand(flat(raw_h), update_stats),
                "weight": flat(valid[..., None]).float()}
        return out
