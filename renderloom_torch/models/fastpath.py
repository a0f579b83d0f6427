"""Parity-layout (space-to-depth) inference path of the full generator:
label embedder, SPADE trunk and blend-mask net.

Port of the JAX package's ``renderloom/models/fastpath.py``.  It computes
the same function as :class:`renderloom_torch.models.renderer.Generator`
on the same folded weights, with the full-resolution stages on
space-to-depth tensors (spatial/2 on each side, channels ×4, channel
``(p·2+q)·C + c``) and exactly transformed kernels:

* a stride-1 3×3 conv becomes a 3×3 conv over the packed tensor with a
  (4·Cout, 4·Cin, 3, 3) kernel, 4/9 of it zero (:func:`w_s1_s2d`);
* a stride-2 3×3 conv becomes a 2×2 conv over the packed tensor with a
  top/left pad of one (:func:`w_s2_s2d`);
* nearest-upsample ×2 then a 3×3 conv becomes a 3×3 conv at the low
  resolution emitting 4·Cout packed channels, then depth_to_space
  (:func:`w_up_d2s`);
* an instance norm over a packed tensor is the parity norm (K2 with
  ``parity=True``): full-resolution statistics averaged over the four
  parity groups;
* a 1×1 conv (SPADE affines, shortcuts) over a packed tensor is a
  grouped conv (groups 4) with the kernel tiled four times.

Tensors are NHWC as in the rest of the port; kernels are OIHW.  Every
norm goes through :func:`renderloom_torch.ops.norm_kernel.instance_norm`
(K2 and K2 parity on the card, their twins on the CPU).

Compute dtype, as the JAX module's ``cdt``: the inputs are cast to it
once, and a convolution casts its kernel and bias to the dtype of its
input (``k.astype(x.dtype)``), so the transformed kernels stay in
float32 (built from the float32 weights, cast at use, never cast and
then summed).  Under bfloat16 the parity norms keep x's dtype and the
standard-layout norms take the r3centered contract, whose affine form
returns float32: the mask net's residual blocks and up path then run in
float32, as the JAX fast path does on the TPU.  The JAX
module's dispatch policy (the ``RENDERLOOM_FASTPATH``,
``RENDERLOOM_PACKED_LEVELS`` and ``RENDERLOOM_PALLAS_NORM*`` switches,
the batch gate and the compile probe with its fallback) is not carried
over: the caller asks for this path explicitly, and ``packed_levels`` is
an argument.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from renderloom_torch.core.config import GeneratorConfig
from renderloom_torch.models.layers import (LEAKY_SLOPE, avg_pool_3x3s2,
                                            leaky, upsample2x)
from renderloom_torch.ops.norm_kernel import instance_norm

Params = Dict[str, torch.Tensor]


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, 2h, 2w, C) → (B, h, w, 4C), channel index (p·2+q)·C + c."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // 2, W // 2, 4 * C)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    B, h, w, C4 = x.shape
    x = x.reshape(B, h, w, 2, 2, C4 // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, 2 * h, 2 * w, C4 // 4)


def _tile4(v: torch.Tensor) -> torch.Tensor:
    """Per-channel vector → parity-packed (4C,): channel-major tile."""
    return v.repeat(4)


def _tile_k1(k: torch.Tensor) -> torch.Tensor:
    """1×1 kernel (Cout, Cin, 1, 1) → the grouped (groups 4) kernel for a
    parity-packed input: output group-major (= parity-major)."""
    return k.repeat(4, 1, 1, 1)


def w_s1_s2d(k: torch.Tensor) -> torch.Tensor:
    """Stride-1 3×3 kernel (Cout, Cin, 3, 3) → (4Cout, 4Cin, 3, 3) acting
    on the packed input and emitting the packed output."""
    co, ci = k.shape[:2]
    out = k.new_zeros((4 * co, 4 * ci, 3, 3))
    for a in (0, 1):
        for b in (0, 1):
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    kr, kc = 1 + (a + dr) // 2, 1 + (b + dc) // 2
                    p, q = (a + dr) % 2, (b + dc) % 2
                    o, i = (a * 2 + b) * co, (p * 2 + q) * ci
                    out[o:o + co, i:i + ci, kr, kc] += k[:, :, 1 + dr, 1 + dc]
    return out


def w_s2_s2d(k: torch.Tensor) -> torch.Tensor:
    """Stride-2 3×3 kernel (Cout, Cin, 3, 3) → (Cout, 4Cin, 2, 2) acting on
    the packed input with a top/left pad of one; the output is the
    standard stride-2 grid."""
    co, ci = k.shape[:2]
    out = k.new_zeros((co, 4 * ci, 2, 2))
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            kr, kc = 1 + dr // 2, 1 + dc // 2
            i = (dr % 2 * 2 + dc % 2) * ci
            out[:, i:i + ci, kr, kc] += k[:, :, 1 + dr, 1 + dc]
    return out


def w_up_d2s(k: torch.Tensor) -> torch.Tensor:
    """nearest-up×2 → 3×3 conv kernel (Cout, Cin, 3, 3) → (4Cout, Cin, 3, 3)
    applied at the LOW resolution; depth_to_space of its output equals
    the upsample-then-conv."""
    co = k.shape[0]
    out = k.new_zeros((4 * co,) + tuple(k.shape[1:]))
    for a in (0, 1):
        for b in (0, 1):
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    kr, kc = 1 + (a + dr) // 2, 1 + (b + dc) // 2
                    o = (a * 2 + b) * co
                    out[o:o + co, :, kr, kc] += k[:, :, 1 + dr, 1 + dc]
    return out


def _conv(x: torch.Tensor, k: torch.Tensor, b: Optional[torch.Tensor] = None,
          top_left: bool = False, groups: int = 1) -> torch.Tensor:
    """NHWC conv with OIHW ``k``: symmetric "SAME" padding for the odd
    kernels, or (``top_left``) one row and column of zeros above and to
    the left only, the JAX ``((1, 0), (1, 0))`` of the 2×2 s2d kernels."""
    xn = x.permute(0, 3, 1, 2)
    if top_left:
        xn, pad = F.pad(xn, (1, 0, 1, 0)), 0
    else:
        pad = (k.shape[-1] - 1) // 2
    return F.conv2d(xn, k.to(x.dtype), None if b is None else b.to(x.dtype),
                    1, pad, 1, groups).permute(0, 2, 3, 1)


def _norm(h: torch.Tensor, ns: Optional[torch.Tensor] = None,
          nb: Optional[torch.Tensor] = None, parity: bool = False,
          act: bool = False) -> torch.Tensor:
    """Instance norm (+ affine, + the fused leaky): the parity norm for a
    packed tensor, the standard one otherwise."""
    return instance_norm(h.contiguous(), ns, nb, LEAKY_SLOPE if act else None,
                         parity=parity)


# ---------------------------------------------------------------------------
# blend-mask net
# ---------------------------------------------------------------------------


def _cb(block) -> Params:
    """Kernel, bias and norm affine of a ConvBlock."""
    out = {"k": block.conv.conv.weight, "b": block.conv.conv.bias}
    if block.norm is not None:
        out["ns"], out["nb"] = block.norm.weight, block.norm.bias
    return out


def transform_mask_params(mask_net) -> Dict[str, Params]:
    """The folded :class:`MaskGenerator`'s weights as parity-layout
    kernels (``fastpath.py:transform_mask_params``)."""
    n_down = mask_net.num_downsamples
    tp = {}
    with torch.no_grad():
        for pre in ("lbl", "img"):
            cb = _cb(getattr(mask_net, f"{pre}_in"))
            tp[f"{pre}_in"] = {"k": w_s1_s2d(cb["k"]), "b": _tile4(cb["b"]),
                               "ns": _tile4(cb["ns"]), "nb": _tile4(cb["nb"])}
            for i in range(n_down):
                cb = _cb(getattr(mask_net, f"{pre}_down{i}"))
                # all but the last down norm run after re-packing
                # (mask_apply_fast), so their affines are parity-tiled
                tile = _tile4 if i + 1 < n_down else (lambda v: v)
                tp[f"{pre}_down{i}"] = {"k": w_s2_s2d(cb["k"]), "b": cb["b"],
                                        "ns": tile(cb["ns"]),
                                        "nb": tile(cb["nb"])}
        for i in range(mask_net.num_res_blocks):
            rb = getattr(mask_net, f"res{i}")
            r = {}
            for j in (0, 1):
                conv, norm = getattr(rb, f"conv{j}"), getattr(rb, f"norm{j}")
                r.update({f"k{j}": conv.conv.weight, f"b{j}": conv.conv.bias,
                          f"ns{j}": norm.weight, f"nb{j}": norm.bias})
            if rb.shortcut:
                r.update({"ks": rb.conv_s.conv.weight,
                          "bs": rb.conv_s.conv.bias,
                          "nss": rb.norm_s.weight, "nbs": rb.norm_s.bias})
            tp[f"res{i}"] = r
        for i in reversed(range(n_down)):
            cb = _cb(getattr(mask_net, f"up{i}"))
            tp[f"up{i}"] = {"k": w_up_d2s(cb["k"]), "b": _tile4(cb["b"]),
                            "ns": _tile4(cb["ns"]), "nb": _tile4(cb["nb"])}
        cb = _cb(mask_net.conv_mask)
        tp["head"] = {"k": w_s1_s2d(cb["k"]), "b": _tile4(cb["b"])}
    return {k: {n: t.detach().clone() for n, t in v.items()}
            for k, v in tp.items()}


def mask_apply_fast(tp: Dict[str, Params], label_p: torch.Tensor,
                    imgs: torch.Tensor, num_downsamples: int = 3,
                    num_res_blocks: int = 4) -> torch.Tensor:
    """Parity-layout mask net: the same function as ``MaskGenerator`` on
    the untransformed weights.  ``label_p`` is the packed label
    (B, H/2, W/2, 88); ``imgs`` (B, H, W, 9); H, W divisible by
    2^num_downsamples.  Returns the sigmoid mask (B, H, W, 1)."""
    if num_downsamples < 1:
        raise ValueError("the packed head needs at least one downsample")

    def enc(xp, pre):
        p = tp[f"{pre}_in"]
        h = _conv(xp, p["k"], p["b"])
        h = _norm(h, p["ns"], p["nb"], parity=True, act=True)
        for i in range(num_downsamples):
            p = tp[f"{pre}_down{i}"]
            # the in-conv's packed output is s2d of its full-res tensor,
            # so down0 takes it directly; each later down takes the
            # previous one's re-packed output
            h = _conv(h, p["k"], p["b"], top_left=True)
            if i + 1 < num_downsamples:
                h = _norm(space_to_depth(h), p["ns"], p["nb"], parity=True,
                          act=True)
            else:
                h = _norm(h, p["ns"], p["nb"], act=True)
        return h

    h = torch.cat([enc(label_p, "lbl"), enc(space_to_depth(imgs), "img")],
                  dim=-1)
    for i in range(num_res_blocks):
        r = tp[f"res{i}"]
        y = _norm(_conv(h, r["k0"], r["b0"]), r["ns0"], r["nb0"], act=True)
        y = _norm(_conv(y, r["k1"], r["b1"]), r["ns1"], r["nb1"])
        s = (_norm(_conv(h, r["ks"], r["bs"]), r["nss"], r["nbs"])
             if "ks" in r else h)
        h = s + y
    for i in reversed(range(1, num_downsamples)):
        p = tp[f"up{i}"]
        h = depth_to_space(_norm(_conv(h, p["k"], p["b"]), p["ns"], p["nb"],
                                 parity=True, act=True))
    p = tp["up0"]                       # stays packed for the head
    h = _norm(_conv(h, p["k"], p["b"]), p["ns"], p["nb"], parity=True,
              act=True)
    m = _conv(h, tp["head"]["k"], tp["head"]["b"])
    return torch.sigmoid(depth_to_space(m))


# ---------------------------------------------------------------------------
# label embedder
# ---------------------------------------------------------------------------


def transform_embed_params(embed) -> Dict[str, Params]:
    """The folded :class:`LabelEmbedder`'s weights: ``conv_first`` by the
    stride-1 embedding, each stride-2 down by the 2×2 s2d form."""
    with torch.no_grad():
        c = embed.conv_first.conv
        tp = {"first": {"k": w_s1_s2d(c.weight), "b": _tile4(c.bias)}}
        for i in range(embed.num_downsamples):
            c = getattr(embed, f"down_{i}").conv
            tp[f"down_{i}"] = {"k": w_s2_s2d(c.weight),
                               "b": c.bias.detach().clone()}
    return tp


def embed_apply_fast(tp: Dict[str, Params], x: torch.Tensor,
                     num_downsamples: int = 4
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Parity-layout embedder: the ``num_downsamples + 1`` standard-layout
    level maps of ``LabelEmbedder``, and the packed forms of levels
    0..num_downsamples−1 (each stride-2 conv takes its input level packed
    anyway; the packed trunk reuses them as its SPADE conditions)."""
    hp = leaky(_conv(space_to_depth(x), tp["first"]["k"], tp["first"]["b"]))
    levels, packed = [depth_to_space(hp)], [hp]
    h = hp
    for i in range(num_downsamples):
        if i > 0:
            h = space_to_depth(h)
            packed.append(h)
        p = tp[f"down_{i}"]
        h = leaky(_conv(h, p["k"], p["b"], top_left=True))
        levels.append(h)
    return levels, packed


# ---------------------------------------------------------------------------
# SPADE trunk
# ---------------------------------------------------------------------------


def avg_pool_s2d(xp: torch.Tensor) -> torch.Tensor:
    """3×3/s2 average pool with padding 1 and count_include_pad on a
    packed tensor, as nine shifted parity slices: the window around
    full-res (2i, 2j) covers packed blocks {i−1, i} at fixed parities.
    Returns the standard-layout pooled tensor (B, h, w, C)."""
    B, h, w, C4 = xp.shape
    par = F.pad(xp.reshape(B, h, w, 4, C4 // 4), (0, 0, 0, 0, 1, 0, 1, 0))
    taps = ((0, 1), (1, 0), (1, 1))     # (row offset into the pad, parity)
    acc = None
    for orr, p in taps:
        for occ, q in taps:
            s = par[:, orr:orr + h, occ:occ + w, p * 2 + q, :]
            acc = s if acc is None else acc + s
    return acc / 9.0


def _spade_std(x, cond, ak, ab):
    """Standard-layout SPADE (``layers.Spade``, 1×1 affine)."""
    out = _norm(x)
    H, W = x.shape[1:3]
    if cond.shape[1:3] != (H, W):
        cond = F.interpolate(cond.permute(0, 3, 1, 2), size=(H, W),
                             mode="nearest-exact").permute(0, 2, 3, 1)
    gamma, beta = _conv(cond, ak, ab).chunk(2, dim=-1)
    return out * (1.0 + gamma) + beta


def _spade_p4(xp, cond_p, ak4, ab4):
    """Parity-packed SPADE: the parameter-free parity norm and the grouped
    1×1 affine over the packed condition (the same resolution by
    construction).  ``ak4`` (4·2C, C_e, 1, 1) is the tiled affine kernel."""
    C = ak4.shape[0] // 8
    out = _norm(xp, parity=True)
    affine = _conv(cond_p, ak4, ab4, groups=4)          # (B, h, w, 4·2C)
    B, h, w, _ = affine.shape
    a = affine.reshape(B, h, w, 4, 2 * C)
    gamma = a[..., :C].reshape(B, h, w, 4 * C)
    beta = a[..., C:].reshape(B, h, w, 4 * C)
    return out * (1.0 + gamma) + beta


def _spade_block_p4(xp, cond_p, bp):
    """Parity-packed ``SpadeResBlock``."""
    h = _conv(leaky(_spade_p4(xp, cond_p, bp["a0k"], bp["a0b"])), bp["k0"],
              bp["b0"])
    h = _conv(leaky(_spade_p4(h, cond_p, bp["a1k"], bp["a1b"])), bp["k1"],
              bp["b1"])
    if "ks" in bp:
        s = _conv(_spade_p4(xp, cond_p, bp["ask"], bp["asb"]), bp["ks"],
                  bp["bs"], groups=4)
    else:
        s = xp
    return s + h


def _spade_block_std(x, cond, bp):
    h = _conv(leaky(_spade_std(x, cond, bp["a0k"], bp["a0b"])), bp["k0"],
              bp["b0"])
    h = _conv(leaky(_spade_std(h, cond, bp["a1k"], bp["a1b"])), bp["k1"],
              bp["b1"])
    if "ks" in bp:
        s = _conv(_spade_std(x, cond, bp["ask"], bp["asb"]), bp["ks"],
                  bp["bs"])
    else:
        s = x
    return s + h


def _sp(block) -> Params:
    """A ``SpadeResBlock``'s kernels, flat."""
    out = {"a0k": block.spade0.affine.weight, "a0b": block.spade0.affine.bias,
           "k0": block.conv0.conv.weight, "b0": block.conv0.conv.bias,
           "a1k": block.spade1.affine.weight, "a1b": block.spade1.affine.bias,
           "k1": block.conv1.conv.weight, "b1": block.conv1.conv.bias}
    if block.shortcut:
        out.update({"ask": block.spade_s.affine.weight,
                    "asb": block.spade_s.affine.bias,
                    "ks": block.conv_s.conv.weight,
                    "bs": block.conv_s.conv.bias})
    return out


def _sp_p4(block) -> Params:
    """Parity-packed ``SpadeResBlock`` kernels: 3×3 convs by the s2d
    embedding, 1×1 affines and shortcut by grouped tiling."""
    f = _sp(block)
    out = {"a0k": _tile_k1(f["a0k"]), "a0b": _tile4(f["a0b"]),
           "k0": w_s1_s2d(f["k0"]), "b0": _tile4(f["b0"]),
           "a1k": _tile_k1(f["a1k"]), "a1b": _tile4(f["a1b"]),
           "k1": w_s1_s2d(f["k1"]), "b1": _tile4(f["b1"])}
    if "ks" in f:
        out.update({"ask": _tile_k1(f["ask"]), "asb": _tile4(f["asb"]),
                    "ks": _tile_k1(f["ks"]), "bs": _tile4(f["bs"])})
    return out


def _levels(cfg: GeneratorConfig, packed_levels: int) -> Tuple[int, int, int]:
    """(num_downsamples, bottleneck blocks, packed levels kL)."""
    n_down = cfg.num_downsamples
    n_res = int(-(-(cfg.num_layers - n_down) // 2) * 2)
    return n_down, n_res, max(1, min(packed_levels, n_down))


def transform_trunk_params(gen, cfg: GeneratorConfig,
                           packed_levels: int = 2) -> Dict[str, Params]:
    """The folded :class:`Generator` trunk's weights: pyramid levels below
    ``packed_levels`` (``down_first``, ``down_i``/``up_i``, ``conv_img``)
    in the parity layout, the rest standard.  Needs
    ``spade_kernel_size == 1`` (the shipped config)."""
    if cfg.spade_kernel_size != 1:
        raise ValueError("the packed SPADE needs a 1×1 affine")
    n_down, n_res, kL = _levels(cfg, packed_levels)
    with torch.no_grad():
        tp = {"down_first": {"k": w_s1_s2d(gen.down_first.weight),
                             "b": _tile4(gen.down_first.bias)}}
        for i in range(n_down + 1):
            f = _sp_p4 if i < kL else _sp
            tp[f"down_{i}"] = f(getattr(gen, f"down_{i}"))
            tp[f"up_{i}"] = f(getattr(gen, f"up_{i}"))
        for i in range(n_res):
            tp[f"res_{i}"] = _sp(getattr(gen, f"res_{i}"))
        c = gen.conv_img.conv
        tp["conv_img"] = {"k": w_s1_s2d(c.weight), "b": _tile4(c.bias)}
    return {k: {n: t.detach().clone() for n, t in v.items()}
            for k, v in tp.items()}


def trunk_apply_fast(tp: Dict[str, Params], label_p: torch.Tensor,
                     cond_maps: List[torch.Tensor],
                     cond_packed: List[torch.Tensor], cfg: GeneratorConfig,
                     packed_levels: int = 2) -> torch.Tensor:
    """The generator trunk with pyramid levels below ``packed_levels`` in
    the parity layout (the value :func:`transform_trunk_params` was built
    with).  ``cond_maps``/``cond_packed``: :func:`embed_apply_fast`'s
    outputs.  ``label_p`` is the packed label (B, H/2, W/2, 88).
    Returns the tanh image (B, H, W, 3)."""
    n_down, n_res, kL = _levels(cfg, packed_levels)
    n_embed = cfg.embed.num_downsamples
    x = _conv(label_p, tp["down_first"]["k"], tp["down_first"]["b"])
    for i in range(n_down + 1):
        j = min(n_embed, i)
        if i < kL:
            x = _spade_block_p4(x, cond_packed[j], tp[f"down_{i}"])
            if i != n_down:
                pooled = avg_pool_s2d(x)
                x = space_to_depth(pooled) if i + 1 < kL else pooled
        else:
            x = _spade_block_std(x, cond_maps[j], tp[f"down_{i}"])
            if i != n_down:
                x = avg_pool_3x3s2(x)
    j = min(n_embed, n_down + 1)
    for i in range(n_res):
        x = _spade_block_std(x, cond_maps[j], tp[f"res_{i}"])
    for i in range(n_down, -1, -1):
        j = min(n_embed, i)
        if i < kL:
            x = _spade_block_p4(x, cond_packed[j], tp[f"up_{i}"])
            if i != 0:
                # s2d(up2x(y)) is y tiled over the four parities
                x = depth_to_space(x).repeat(1, 1, 1, 4)
        else:
            x = _spade_block_std(x, cond_maps[j], tp[f"up_{i}"])
            if i != 0:
                x = x.repeat(1, 1, 1, 4) if i - 1 < kL else upsample2x(x)
    img = _conv(leaky(x), tp["conv_img"]["k"], tp["conv_img"]["b"])
    return torch.tanh(depth_to_space(img))


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


class FastInferenceGen(nn.Module):
    """The inference generator in the parity layout: ``forward(label,
    label_prev, img_warped, img_prev) → (img, mask)`` as
    :class:`renderloom_torch.models.renderer.Generator`'s, on the
    transformed weights of a folded float32 ``Generator`` (held as
    float32 buffers, so ``.to()`` moves them), computing in the
    generator's ``dtype``.  ``label`` may be NHWC (B, H, W, 22) or
    pre-packed (B, H/2, W/2, 88), as the rasterizer's packed layout gives
    it, in any float type.  Inference only: the weights are buffers and
    the parity and r3centered norms have no backward."""

    def __init__(self, gen, cfg: GeneratorConfig, packed_levels: int = 2):
        super().__init__()
        if gen.conv_img.conv.weight.dtype != torch.float32:
            raise ValueError("the parity-layout kernels are built from "
                             "the float32 weights")
        self.cfg = cfg
        self.packed_levels = packed_levels
        self.dtype = gen.dtype
        tree = {"mask": transform_mask_params(gen.mask_net),
                "embed": transform_embed_params(gen.ref_embed),
                "trunk": transform_trunk_params(gen, cfg, packed_levels)}
        self._names = {}
        for part, blocks in tree.items():
            for block, leaves in blocks.items():
                for leaf, t in leaves.items():
                    name = f"{part}__{block}__{leaf}"
                    self.register_buffer(name, t)
                    self._names[name] = (part, block, leaf)

    def weights(self) -> Dict[str, Dict[str, Params]]:
        """The transformed weights as {part: {block: {leaf: tensor}}}."""
        tree: Dict[str, Dict[str, Params]] = {}
        for name, (part, block, leaf) in self._names.items():
            tree.setdefault(part, {}).setdefault(block, {})[leaf] = \
                getattr(self, name)
        return tree

    def forward(self, label: torch.Tensor, label_prev: torch.Tensor,
                img_warped: torch.Tensor, img_prev: torch.Tensor,
                update_stats: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        tp, cfg, dt = self.weights(), self.cfg, self.dtype
        # a label wider than input_label_nc is the rasterizer's packed layout
        label_p = label.to(dt)
        if label.shape[-1] == cfg.input_label_nc:
            label_p = space_to_depth(label_p)
        cond, cond_packed = embed_apply_fast(
            tp["embed"], torch.cat([img_warped, img_prev], dim=-1).to(dt),
            cfg.embed.num_downsamples)
        img = trunk_apply_fast(tp["trunk"], label_p, cond, cond_packed, cfg,
                               self.packed_levels)
        imgs = torch.cat([img_prev.to(dt), img_warped.to(dt), img], dim=-1)
        mask = mask_apply_fast(tp["mask"], label_p, imgs,
                               cfg.mask.num_downsamples,
                               cfg.mask.num_res_blocks)
        return img, mask.to(img.dtype)

