"""Renderer inference: the spectral-norm-free generator and the
segment-parallel autoregressive rollout.

Port of the inference part of the JAX package's ``renderloom/train/gan.py``
(``make_inference_generator``, ``make_inference_pair``,
``make_segment_rollout``).  Training, the parity-layout fast path and
``segment_rollout_chunked`` are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from renderloom_torch.convert import (fold_spectral_norm, load_flax_params,
                                      random_init_)
from renderloom_torch.core.config import RendererConfig
from renderloom_torch.models.renderer import Generator, composite


def make_inference_generator(cfg: RendererConfig) -> Generator:
    """The generator the rollout runs: spectral norm folded into the
    weights, float32 compute.  The config's weight-norm types are kept so
    the random initializer knows which weights to normalize."""
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype {cfg.compute_dtype!r}: the port runs the "
            "generator in float32 only")
    return Generator(cfg.gen)


def make_inference_pair(cfg: RendererConfig, params_g: Optional[dict],
                        stats_g: Optional[dict], device) -> Generator:
    """The inference generator on ``device`` with its weights: the numpy
    flax trees ``params_g``/``stats_g`` folded and converted, or, when
    ``params_g`` is None, random weights from seed 1."""
    gen = make_inference_generator(cfg)
    if params_g is None:
        random_init_(gen, 1)
    else:
        load_flax_params(gen, fold_spectral_norm(params_g, stats_g or {}))
    return gen.to(device).eval()


def make_segment_rollout(gen: Generator, rate: int) -> Callable:
    """Segment-parallel rollout for the keyframe pattern ``t % rate ==
    0``: every keyframe resets the autoregressive chain, so the (K−1)
    segments run as one batch through ``rate − 1`` sequential generator
    steps (the JAX ``lax.scan`` becomes a Python loop).

    ``batch``: label (B, L, H, W, 22), back (B, L, H, W, 3),
    key_img (B, L, H, W, 3) with L = S·rate + 1.  Returns fused
    (B, L, H, W, 3) and masks (B, L, H, W, 1); keyframes pass through
    with a zero mask.
    """
    def rollout(batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        label, back, key_img = batch["label"], batch["back"], \
            batch["key_img"]
        B, L = label.shape[:2]
        if (L - 1) % rate:
            raise ValueError(f"clip length {L} is not S·{rate} + 1")
        S = (L - 1) // rate

        def seg(x):
            # (B, L, ...) → (rate, B·S, ...): segment s covers frames
            # [s·rate, (s+1)·rate), in-segment index first
            body = x[:, :S * rate].reshape((B, S, rate) + x.shape[2:])
            return body.movedim(2, 0).reshape((rate, B * S) + x.shape[2:])

        def unseg(x):
            body = x.reshape((rate, B, S) + x.shape[2:]).movedim(0, 2)
            return body.reshape((B, S * rate) + x.shape[2:])

        label_s, back_s, key_s = seg(label), seg(back), seg(key_img)
        prev_fuse, prev_label = key_s[0], label_s[0]
        fused_seg = [key_s[0]]
        masks_seg = [torch.zeros(key_s.shape[1:-1] + (1,),
                                 dtype=key_s.dtype, device=key_s.device)]
        for t in range(1, rate):
            img, mask = gen(label_s[t], prev_label, back_s[t], prev_fuse)
            prev_fuse = composite(img, mask, back_s[t])
            prev_label = label_s[t]
            fused_seg.append(prev_fuse)
            masks_seg.append(mask)
        fused = torch.cat([unseg(torch.stack(fused_seg)), key_img[:, -1:]],
                          dim=1)
        last = torch.zeros(key_img[:, -1:].shape[:-1] + (1,),
                           dtype=masks_seg[0].dtype, device=key_img.device)
        masks = torch.cat([unseg(torch.stack(masks_seg)), last], dim=1)
        return fused, masks

    return rollout
