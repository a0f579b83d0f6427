"""DETR-style two-stage motion transformer.

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

Training mode: given a ``dropout_rng`` (a ``torch.Generator`` on the
input's device) the forward drops at flax's sites with the config's
rate, each mask drawn from that generator: the attention weights, the
feed-forward's hidden layer, and every residual branch of the encoder
and decoder layers (:class:`Dropout`, kept values scaled by 1/(1 − p) as
flax does).  Without it the forward is deterministic.

Position encodings: the sine encoding (``v2``) or the learned table
(``v3``/``learned``, :class:`LearnedPositionEncoding`, 160 rows).
:func:`init_motion_params` draws flax's initial weights from a seed.

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


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: with a generator, each element is kept
    with probability 1 − rate (a uniform draw below it) and divided by
    it, else zeroed; without one, or at rate 0, the identity."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


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
    projections; ``bias`` broadcasts to (B, heads, Lq, Lk); dropout on
    the attention weights."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.q_proj = Dense(dim, dim)
        self.k_proj = Dense(dim, dim)
        self.v_proj = Dense(dim, dim)
        self.out_proj = Dense(dim, dim)
        self.dropout = Dropout(dropout)

    def forward(self, q_in, k_in, v_in, q_pos=None, k_pos=None,
                bias: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
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
        weights = self.dropout(torch.softmax(logits, dim=-1).to(v.dtype), rng)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out_proj(out.reshape(B, Lq, D))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, activation: str,
                 dropout: float = 0.0):
        super().__init__()
        self.act = _activation(activation)
        self.linear1 = Dense(dim, hidden)
        self.linear2 = Dense(hidden, dim)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.linear2(self.dropout(self.act(self.linear1(x)), rng))


class EncoderLayer(nn.Module):
    def __init__(self, c: TransformerConfig):
        super().__init__()
        self.pre_norm = c.pre_norm
        self.self_attn = MultiHeadAttention(c.hidden_dim, c.nheads,
                                            c.dropout)
        self.ffn = FeedForward(c.hidden_dim, c.dim_feedforward,
                               c.activation, c.dropout)
        self.norm1 = LayerNorm(c.hidden_dim, eps=LN_EPS)
        self.norm2 = LayerNorm(c.hidden_dim, eps=LN_EPS)
        self.drop = Dropout(c.dropout)

    def forward(self, x, pos, bias, rng=None):
        d = lambda h: self.drop(h, rng)
        if self.pre_norm:
            h = self.norm1(x)
            x = x + d(self.self_attn(h, h, h, pos, pos, bias, rng))
            return x + d(self.ffn(self.norm2(x), rng))
        x = self.norm1(x + d(self.self_attn(x, x, x, pos, pos, bias, rng)))
        return self.norm2(x + d(self.ffn(x, rng)))


class DecoderLayer(nn.Module):
    def __init__(self, c: TransformerConfig):
        super().__init__()
        self.pre_norm = c.pre_norm
        self.self_attn = MultiHeadAttention(c.hidden_dim, c.nheads,
                                            c.dropout)
        self.cross_attn = MultiHeadAttention(c.hidden_dim, c.nheads,
                                             c.dropout)
        self.ffn = FeedForward(c.hidden_dim, c.dim_feedforward,
                               c.activation, c.dropout)
        self.norm1 = LayerNorm(c.hidden_dim, eps=LN_EPS)
        self.norm2 = LayerNorm(c.hidden_dim, eps=LN_EPS)
        self.norm3 = LayerNorm(c.hidden_dim, eps=LN_EPS)
        self.drop = Dropout(c.dropout)

    def forward(self, x, memory, q_pos, mem_pos, self_bias, cross_bias,
                rng=None):
        d = lambda h: self.drop(h, rng)
        if self.pre_norm:
            h = self.norm1(x)
            x = x + d(self.self_attn(h, h, h, q_pos, q_pos, self_bias, rng))
            h = self.norm2(x)
            x = x + d(self.cross_attn(h, memory, memory, q_pos, mem_pos,
                                      cross_bias, rng))
            return x + d(self.ffn(self.norm3(x), rng))
        x = self.norm1(x + d(self.self_attn(x, x, x, q_pos, q_pos,
                                            self_bias, rng)))
        x = self.norm2(x + d(self.cross_attn(x, memory, memory, q_pos,
                                             mem_pos, cross_bias, rng)))
        return self.norm3(x + d(self.ffn(x, rng)))


class LearnedPositionEncoding(nn.Module):
    """Learned absolute position table (``max_positions``, dim); a
    sequence of L positions takes its first L rows.  Longer sequences
    raise: the JAX package's ``table[:length]`` cannot broadcast them."""

    def __init__(self, dim: int, max_positions: int = 160):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(max_positions, dim))

    def forward(self, batch: int, length: int,
                dtype: torch.dtype) -> torch.Tensor:
        rows, dim = self.embedding.shape
        if length > rows:
            raise ValueError(
                f"learned position encoding: {length} positions, but the "
                f"table has {rows} rows (pos_encode.max_learned_positions)")
        return self.embedding[:length][None].expand(batch, length,
                                                   dim).to(dtype)


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
        self.learned = pos_cfg.position_embedding in ("v3", "learned")
        if self.learned:
            self.learned_pe = LearnedPositionEncoding(
                pos_cfg.hidden_dim, pos_cfg.max_learned_positions)
        set_compute_dtype(self, dtype, (Dense, LayerNorm))

    def position_encoding(self, batch: int, length: int,
                          lengths: Optional[torch.Tensor], device):
        if self.learned:
            return self.learned_pe(batch, length, self.dtype)
        return sine_position_encoding(batch, length, self.pe_dim,
                                      lengths=lengths,
                                      device=device).to(self.dtype)

    def encode(self, src_embed, src_mask, pos, rng=None):
        L = src_embed.shape[1]
        eye = torch.eye(L, dtype=torch.bool, device=src_embed.device)
        zero = torch.zeros((), device=src_embed.device)
        bias = torch.where(eye, NEG_INF, zero)[None, None] \
            + padding_bias(src_mask)
        x = src_embed
        for i in range(self.cfg.enc_layers):
            x = getattr(self, f"enc_{i}")(x, pos, bias, rng)
        return self.encoder_norm(x) if self.cfg.pre_norm else x

    def decode(self, memory, src_mask, mem_pos, tgt_embed, tgt_mask,
               tgt_pos, rng=None):
        self_bias = padding_bias(tgt_mask)
        cross_bias = padding_bias(src_mask)
        x = tgt_embed
        for i in range(self.cfg.dec_layers):
            x = getattr(self, f"dec_{i}")(x, memory, tgt_pos, mem_pos,
                                          self_bias, cross_bias, rng)
        return self.decoder_norm(x)

    def forward(self, src, src_mask, tgt, tgt_mask, rate: int,
                lengths: Optional[torch.Tensor] = None,
                dropout_rng: Optional[torch.Generator] = None):
        """``dropout_rng`` set: training mode, dropout drawn from it."""
        B, L, _ = src.shape
        src = src.to(self.dtype)
        pos = self.position_encoding(B, L, lengths, src.device)
        mem = self.encode(self.input_embed(src), src_mask, pos, dropout_rng)
        reco = self.joints_embed(mem) + src
        center = interpolate_embedding(reco, rate) if self.cfg.two_stage \
            else tgt.to(self.dtype)
        out = self.decode(mem, src_mask, pos, self.input_embed(center),
                          tgt_mask, pos, dropout_rng)
        return (self.joints_embed(out) + center).float(), reco.float()


def build_motion_model(cfg) -> MotionTransformer:
    """The motion transformer of a :class:`MotionConfig`, computing in
    its ``compute_dtype`` (float32 or bfloat16) on float32 parameters."""
    return MotionTransformer(cfg.transformer, cfg.pos_encode,
                             torch_dtype(cfg.compute_dtype))


def init_motion_params(cfg, seed: int) -> MotionTransformer:
    """The motion transformer of ``cfg`` with flax's initial weights drawn
    on the CPU from ``seed`` (the counterpart of the JAX package's
    ``init_motion_params``): dense kernels lecun-normal (a normal of
    variance 1/fan_in truncated at two of its deviations), zero biases,
    layer-norm scales 1 and offsets 0, the learned position table
    uniform in [0, 1)."""
    model = build_motion_model(cfg)
    g = torch.Generator().manual_seed(seed)
    # flax's truncated-normal stddev correction for the cut at ±2σ
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Dense):
                std = math.sqrt(1.0 / m.weight.shape[1]) / trunc_std
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, LearnedPositionEncoding):
                m.embedding.uniform_(0.0, 1.0, generator=g)
    return model
