"""DETR-style two-stage motion transformer, inference only.

Port of the JAX package's ``renderloom/models/motion_transformer.py``,
batch-first (B, L, C), with the reference's quirks kept:

* the encoder's self-attention blocks each step from attending to itself
  (eye mask), and the decoder is bidirectional (key-padding masks only);
* positional encodings are added to queries and keys, never to values;
* masks are one finite additive bias (``NEG_INF = -1e9``): ``-inf`` would
  give NaN on the rows that the eye mask and the padding hide entirely;
* LayerNorm epsilon is flax's 1e-6 (torch's default is 1e-5), and the
  feed-forward's leaky slope is 0.01;
* attention is written as the JAX code writes it, explicit matmuls and
  a softmax.

Compute dtype (the config's ``compute_dtype``), as flax's ``dtype=``:
parameters are float32; a dense layer (:class:`Dense`) casts its input
and weights to the compute dtype and returns it; a layer norm
(:class:`LayerNorm`) takes its statistics in float32 and returns the
compute dtype; the attention logits and the softmax are float32 (the
JAX einsum's ``preferred_element_type``), the weights cast back; the
positional encodings and the sequences run in the compute dtype, and the
outputs are float32.  ``layers.cast_weights_(model, (Dense,))`` casts the
dense weights once for inference (the same numbers, half the bytes).

Module and parameter names follow the flax tree, so
:mod:`renderloom_torch.convert` loads a JAX tree by name.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from renderloom_torch.core.config import (PosEncodeConfig, TransformerConfig,
                                           torch_dtype)
from renderloom_torch.models.layers import set_compute_dtype

NEG_INF = -1e9
LN_EPS = 1e-6


class Dense(nn.Linear):
    """``nn.Dense(dtype=...)``: input, weight and bias cast to
    ``compute_dtype``, the product accumulated in float32."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=...)``: statistics and the affine in
    float32, the output in ``compute_dtype``."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


def sine_position_encoding(batch: int, length: int, dim: int,
                           temperature: float = 10000.0,
                           lengths: Optional[torch.Tensor] = None,
                           device=None) -> torch.Tensor:
    """(B, L, dim) 1-D sine PE; position i is scaled by 2π/(len − 1 + ε)
    with ``lengths`` (B,) the true lengths of padded sequences."""
    half = dim // 2
    position = torch.arange(length, dtype=torch.float32, device=device)
    if lengths is None:
        norm = torch.full((batch, 1), length - 1.0, device=device)
    else:
        norm = (lengths.float() - 1.0)[:, None]
    position = position[None, :] / (norm + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(half, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / half)
    angles = position[:, :, None] / dim_t
    pe = torch.zeros((batch, length, dim), dtype=torch.float32,
                     device=device)
    pe[:, :, 0::2] = torch.sin(angles)
    pe[:, :, 1::2] = torch.cos(angles)
    return pe


def _activation(name: str):
    if name == "relu":
        return F.relu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")   # flax's default
    if name == "leaky_relu":
        return lambda x: F.leaky_relu(x, 0.01)
    raise ValueError(f"unsupported activation {name!r}")


class MultiHeadAttention(nn.Module):
    """Attention with positional terms added to queries/keys before their
    projections; ``bias`` broadcasts to (B, heads, Lq, Lk)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = Dense(dim, dim)
        self.k_proj = Dense(dim, dim)
        self.v_proj = Dense(dim, dim)
        self.out_proj = Dense(dim, dim)

    def forward(self, q_in, k_in, v_in, q_pos=None, k_pos=None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = self.q_proj(q_in if q_pos is None else q_in + q_pos)
        k = self.k_proj(k_in if k_pos is None else k_in + k_pos)
        v = self.v_proj(v_in)
        B, Lq, D = q.shape
        Lk = k.shape[1]
        hd = D // self.heads
        q = q.reshape(B, Lq, self.heads, hd)
        k = k.reshape(B, Lk, self.heads, hd)
        v = v.reshape(B, Lk, self.heads, hd)
        # float32 logits of the compute-dtype q and k (a bf16 matmul
        # would round them to bf16)
        logits = torch.einsum("bqhd,bkhd->bhqk",
                              (q * (1.0 / math.sqrt(hd))).float(), k.float())
        if bias is not None:
            logits = logits + bias
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out_proj(out.reshape(B, Lq, D))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, activation: str):
        super().__init__()
        self.act = _activation(activation)
        self.linear1 = Dense(dim, hidden)
        self.linear2 = Dense(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self.act(self.linear1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, c: TransformerConfig):
        super().__init__()
        self.pre_norm = c.pre_norm
        self.self_attn = MultiHeadAttention(c.hidden_dim, c.nheads)
        self.ffn = FeedForward(c.hidden_dim, c.dim_feedforward,
                               c.activation)
        self.norm1 = LayerNorm(c.hidden_dim, eps=LN_EPS)
        self.norm2 = LayerNorm(c.hidden_dim, eps=LN_EPS)

    def forward(self, x, pos, bias):
        if self.pre_norm:
            h = self.norm1(x)
            x = x + self.self_attn(h, h, h, pos, pos, bias)
            return x + self.ffn(self.norm2(x))
        x = self.norm1(x + self.self_attn(x, x, x, pos, pos, bias))
        return self.norm2(x + self.ffn(x))


class DecoderLayer(nn.Module):
    def __init__(self, c: TransformerConfig):
        super().__init__()
        self.pre_norm = c.pre_norm
        self.self_attn = MultiHeadAttention(c.hidden_dim, c.nheads)
        self.cross_attn = MultiHeadAttention(c.hidden_dim, c.nheads)
        self.ffn = FeedForward(c.hidden_dim, c.dim_feedforward,
                               c.activation)
        self.norm1 = LayerNorm(c.hidden_dim, eps=LN_EPS)
        self.norm2 = LayerNorm(c.hidden_dim, eps=LN_EPS)
        self.norm3 = LayerNorm(c.hidden_dim, eps=LN_EPS)

    def forward(self, x, memory, q_pos, mem_pos, self_bias, cross_bias):
        if self.pre_norm:
            h = self.norm1(x)
            x = x + self.self_attn(h, h, h, q_pos, q_pos, self_bias)
            h = self.norm2(x)
            x = x + self.cross_attn(h, memory, memory, q_pos, mem_pos,
                                    cross_bias)
            return x + self.ffn(self.norm3(x))
        x = self.norm1(x + self.self_attn(x, x, x, q_pos, q_pos, self_bias))
        x = self.norm2(x + self.cross_attn(x, memory, memory, q_pos,
                                           mem_pos, cross_bias))
        return self.norm3(x + self.ffn(x))


def padding_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """(B, Lk) bool, True = hidden → additive (B, 1, 1, Lk) bias."""
    zero = torch.zeros((), dtype=torch.float32, device=key_mask.device)
    return torch.where(key_mask[:, None, None, :], NEG_INF, zero)


def interpolate_embedding(x: torch.Tensor, rate: int) -> torch.Tensor:
    """Linear interpolation of (B, L, C) from its every-``rate``-th
    frames; the last partial segment interpolates toward the final
    frame."""
    L = x.shape[1]
    idx = torch.arange(L, device=x.device)
    chunk = torch.div(idx, rate, rounding_mode="floor")
    remain = (idx % rate).to(x.dtype)
    prev = x[:, chunk * rate]
    nxt_idx = torch.cat([(chunk[:-1] + 1) * rate,
                         torch.tensor([L - 1], device=x.device)])
    nxt = x[:, torch.clamp(nxt_idx, max=L - 1)]
    w = remain[None, :, None]
    return prev / rate * (rate - w) + nxt / rate * w


class MotionTransformer(nn.Module):
    """Two-stage pose-sequence upsampler.  ``src``/``tgt`` (B, L, C),
    masks (B, L) bool with True = hidden.  Returns ``(joints, reco)``:
    the refined sequence and the denoised keyframes, both (B, L, C)."""

    def __init__(self, cfg: TransformerConfig, pos_cfg: PosEncodeConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pos_cfg.position_embedding != "v2":
            raise NotImplementedError(
                f"position_embedding {pos_cfg.position_embedding!r}: the "
                "port has the sine encoding ('v2') only")
        self.cfg = cfg
        self.dtype = dtype
        self.pe_dim = pos_cfg.hidden_dim
        self.input_embed = Dense(cfg.input_joints, cfg.hidden_dim)
        self.joints_embed = Dense(cfg.hidden_dim, cfg.input_joints)
        for i in range(cfg.enc_layers):
            setattr(self, f"enc_{i}", EncoderLayer(cfg))
        for i in range(cfg.dec_layers):
            setattr(self, f"dec_{i}", DecoderLayer(cfg))
        if cfg.pre_norm:
            self.encoder_norm = LayerNorm(cfg.hidden_dim, eps=LN_EPS)
        self.decoder_norm = LayerNorm(cfg.hidden_dim, eps=LN_EPS)
        set_compute_dtype(self, dtype, (Dense, LayerNorm))

    def encode(self, src_embed, src_mask, pos):
        L = src_embed.shape[1]
        eye = torch.eye(L, dtype=torch.bool, device=src_embed.device)
        zero = torch.zeros((), device=src_embed.device)
        bias = torch.where(eye, NEG_INF, zero)[None, None] \
            + padding_bias(src_mask)
        x = src_embed
        for i in range(self.cfg.enc_layers):
            x = getattr(self, f"enc_{i}")(x, pos, bias)
        return self.encoder_norm(x) if self.cfg.pre_norm else x

    def decode(self, memory, src_mask, mem_pos, tgt_embed, tgt_mask,
               tgt_pos):
        self_bias = padding_bias(tgt_mask)
        cross_bias = padding_bias(src_mask)
        x = tgt_embed
        for i in range(self.cfg.dec_layers):
            x = getattr(self, f"dec_{i}")(x, memory, tgt_pos, mem_pos,
                                          self_bias, cross_bias)
        return self.decoder_norm(x)

    def forward(self, src, src_mask, tgt, tgt_mask, rate: int,
                lengths: Optional[torch.Tensor] = None):
        B, L, _ = src.shape
        src = src.to(self.dtype)
        pos = sine_position_encoding(B, L, self.pe_dim, lengths=lengths,
                                     device=src.device).to(self.dtype)
        mem = self.encode(self.input_embed(src), src_mask, pos)
        reco = self.joints_embed(mem) + src
        center = interpolate_embedding(reco, rate) if self.cfg.two_stage \
            else tgt.to(self.dtype)
        out = self.decode(mem, src_mask, pos, self.input_embed(center),
                          tgt_mask, pos)
        return (self.joints_embed(out) + center).float(), reco.float()


def build_motion_model(cfg) -> MotionTransformer:
    """The motion transformer of a :class:`MotionConfig`, computing in
    its ``compute_dtype`` (float32 or bfloat16) on float32 parameters."""
    return MotionTransformer(cfg.transformer, cfg.pos_encode,
                             torch_dtype(cfg.compute_dtype))
