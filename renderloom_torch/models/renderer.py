"""Pose-conditioned SPADE generator with its blend-mask net.

Port of the JAX package's ``renderloom/models/renderer.py``:

* ``LabelEmbedder`` — encoder pyramid over ``concat(img_warped,
  img_prev)``, one conditioning map per scale;
* ``Generator`` — first conv → SPADE down blocks with 3×3/s2 average
  pools → bottleneck SPADE blocks → SPADE up blocks with nearest ×2 →
  leaky → conv → tanh image head, then the mask net;
* ``MaskGenerator`` — label and image encoders concatenated at the
  bottleneck, 'CNACN' residual blocks, conv decoder, sigmoid mask.

Inputs and outputs are NHWC.  Channel counts are fixed at construction
from the config, as flax infers them at init.  Forwards take
``update_stats`` like the flax modules: with the spectral-norm state of
:func:`renderloom_torch.models.layers.enable_spectral_norm` it stores
each power step's ``u`` (training); serving modules have folded weights
and ignore it.  ``Generator(cfg, dtype)`` computes in ``dtype``
(float32 or bfloat16), as the flax module's ``dtype``: its
convolutions cast their inputs to it (:func:`renderloom_torch.models.
layers.set_compute_dtype`) and its outputs are in it.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from renderloom_torch.core.config import GeneratorConfig
from renderloom_torch.models.layers import (Conv, ConvBlock, ResBlockCNACN,
                                            SNConv, SpadeResBlock,
                                            avg_pool_3x3s2, leaky,
                                            set_compute_dtype, upsample2x)


def _filters(base: int, cap: int, level: int) -> int:
    return min(cap, base * (2 ** level))


class LabelEmbedder(nn.Module):
    """``num_downsamples + 1`` feature maps: level 0 at input resolution,
    level i at 1/2^i with ``min(max_filters, num_filters·2^i)`` channels."""

    def __init__(self, cfg: GeneratorConfig, in_ch: int):
        super().__init__()
        e = cfg.embed
        spectral = e.weight_norm_type == "spectral"
        self.num_downsamples = e.num_downsamples
        self.conv_first = SNConv(in_ch, e.num_filters, e.kernel_size, 1,
                                 spectral)
        ch = e.num_filters
        for i in range(e.num_downsamples):
            out = _filters(e.num_filters, e.max_num_filters, i + 1)
            setattr(self, f"down_{i}",
                    SNConv(ch, out, e.kernel_size, 2, spectral))
            ch = out

    def forward(self, x: torch.Tensor,
                update_stats: bool = False) -> List[torch.Tensor]:
        h = leaky(self.conv_first(x, update_stats))
        levels = [h]
        for i in range(self.num_downsamples):
            h = leaky(getattr(self, f"down_{i}")(h, update_stats))
            levels.append(h)
        return levels


class MaskGenerator(nn.Module):
    """Soft blend mask from ``label`` (B,H,W,22) and ``imgs`` =
    concat(img_prev, img_warped, img_gen) (B,H,W,9).  Each up block
    convolves the nearest ×2 upsample of its input (``upsample=True``:
    one fused kernel in float32 inference, :class:`~renderloom_torch.
    models.layers.Conv`)."""

    def __init__(self, cfg: GeneratorConfig, label_ch: int, img_ch: int):
        super().__init__()
        m = cfg.mask
        spectral = m.weight_norm_type == "spectral"
        k = m.kernel_size
        self.num_downsamples = m.num_downsamples
        self.num_res_blocks = m.num_res_blocks
        f = lambda i: _filters(m.num_filters, m.max_num_filters, i)
        for prefix, in_ch in (("lbl", label_ch), ("img", img_ch)):
            setattr(self, f"{prefix}_in",
                    ConvBlock(in_ch, m.num_filters, k, 1, spectral))
            for i in range(m.num_downsamples):
                setattr(self, f"{prefix}_down{i}",
                        ConvBlock(f(i), f(i + 1), k, 2, spectral))
        ch = f(m.num_downsamples)
        in_ch = 2 * ch
        for i in range(m.num_res_blocks):
            setattr(self, f"res{i}", ResBlockCNACN(in_ch, ch, k, spectral))
            in_ch = ch
        for i in reversed(range(m.num_downsamples)):
            setattr(self, f"up{i}", ConvBlock(in_ch, f(i), k, 1, spectral))
            in_ch = f(i)
        self.conv_mask = ConvBlock(in_ch, 1, k, 1, spectral=False,
                                   norm="none", activation="sigmoid")

    def _encode(self, x: torch.Tensor, prefix: str,
                update_stats: bool) -> torch.Tensor:
        h = getattr(self, f"{prefix}_in")(x, update_stats)
        for i in range(self.num_downsamples):
            h = getattr(self, f"{prefix}_down{i}")(h, update_stats)
        return h

    def forward(self, label: torch.Tensor, imgs: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        h = torch.cat([self._encode(label, "lbl", update_stats),
                       self._encode(imgs, "img", update_stats)], dim=-1)
        for i in range(self.num_res_blocks):
            h = getattr(self, f"res{i}")(h, update_stats)
        for i in reversed(range(self.num_downsamples)):
            h = getattr(self, f"up{i}")(h, update_stats, upsample=True)
        return self.conv_mask(h)


class Generator(nn.Module):
    """SPADE generator: ``forward(label, label_prev, img_warped,
    img_prev) → (img, mask)``, both in ``dtype``.  ``label_prev`` is
    accepted for interface parity and unused, as in the reference
    forward."""

    def __init__(self, cfg: GeneratorConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        g = cfg
        self.dtype = dtype
        spectral = g.weight_norm_type == "spectral"
        self.n_down = g.num_downsamples
        self.n_res = int(-(-(g.num_layers - g.num_downsamples) // 2) * 2)
        self.n_embed = g.embed.num_downsamples
        f = lambda i: _filters(g.num_filters, g.max_num_filters, i)
        e = lambda i: _filters(g.embed.num_filters,
                               g.embed.max_num_filters, i)
        block = lambda i_ch, o_ch, level: SpadeResBlock(
            i_ch, o_ch, e(min(self.n_embed, level)), g.kernel_size,
            g.spade_kernel_size, spectral, remat=g.do_checkpoint)

        self.ref_embed = LabelEmbedder(g, 2 * g.input_image_nc)
        self.down_first = Conv(g.input_label_nc, g.num_filters,
                               g.kernel_size)
        for i in range(self.n_down + 1):
            setattr(self, f"down_{i}", block(f(i), f(i + 1), i))
        for i in range(self.n_res):
            setattr(self, f"res_{i}", block(f(self.n_down + 1),
                                            f(self.n_down + 1),
                                            self.n_down + 1))
        for i in range(self.n_down, -1, -1):
            setattr(self, f"up_{i}", block(f(i + 1), f(i), i))
        self.conv_img = SNConv(f(0), g.input_image_nc, g.kernel_size, 1,
                               spectral=False)
        self.mask_net = MaskGenerator(g, g.input_label_nc,
                                      3 * g.input_image_nc)
        set_compute_dtype(self, dtype)

    def forward(self, label: torch.Tensor, label_prev: torch.Tensor,
                img_warped: torch.Tensor, img_prev: torch.Tensor,
                update_stats: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cond = self.ref_embed(torch.cat([img_warped, img_prev], dim=-1),
                              update_stats)
        img = self.trunk(label, cond, update_stats)
        # the mask net's images in the compute dtype, as the flax module
        # casts their concatenation
        imgs = torch.cat([img_prev, img_warped, img.to(img_prev.dtype)],
                         dim=-1).to(self.dtype)
        mask = self.mask_net(label, imgs, update_stats)
        return img, mask.to(img.dtype)

    def trunk(self, label: torch.Tensor, cond: List[torch.Tensor],
              update_stats: bool = False) -> torch.Tensor:
        """The SPADE trunk: the tanh image from ``label`` and the
        embedder's level maps ``cond``."""
        level = lambda i: cond[min(self.n_embed, i)]
        x = self.down_first(label)
        for i in range(self.n_down + 1):
            x = getattr(self, f"down_{i}")(x, level(i), update_stats)
            if i != self.n_down:
                x = avg_pool_3x3s2(x)
        for i in range(self.n_res):
            x = getattr(self, f"res_{i}")(x, level(self.n_down + 1),
                                          update_stats)
        for i in range(self.n_down, -1, -1):
            x = getattr(self, f"up_{i}")(x, level(i), update_stats)
            if i != 0:
                x = upsample2x(x)
        return torch.tanh(self.conv_img(leaky(x)))


def composite(img_gen: torch.Tensor, mask: torch.Tensor,
              img_back: torch.Tensor) -> torch.Tensor:
    """fuse = gen·mask + background·(1−mask)."""
    return img_gen * mask + img_back * (1.0 - mask)
