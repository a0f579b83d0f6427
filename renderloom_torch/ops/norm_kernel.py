"""Instance norm over NHWC with optional affine and fused leaky: the CUDA
kernels ``csrc/instance_norm.cu`` (forward K2, backward K2b), their
plain PyTorch twins, and the ``autograd.Function`` that joins them.

K2 replaces the TPU kernel ``renderloom/ops/norm_pallas.py:
instance_norm_fused`` (forward, ``parity=False`` and ``parity=True``).
K2b is the backward the JAX package wrote as a custom VJP
(``renderloom/models/layers.py:_in_bwd``).  On the H100 both are bound
by device-memory bytes; each makes two passes over its inputs, with
partial sums per pixel range in a scratch buffer and a fixed-order
reduction, so results do not depend on block scheduling.  See the
source for the design.

Numerics are the fp32 contract of the JAX package's
``models/layers.py:_in_moments``/``_in_apply``/``_in_bwd``: moments of
``x - s`` with ``s = x[b, 0, 0, c]`` accumulated in fp32, the centered
apply ``((x - s) - m1) · rsqrt(var + eps) · γ + β``, and the backward
``dx = inv · (g − E[g] − x̂·E[g·x̂])`` with ``g = dy·γ`` from the saved
per-(B, C) residuals ``(s, m1, inv)``.  A fused leaky takes its
derivative from the sign of the recomputed pre-leaky value (1 at 0, as
``jnp.where(x >= 0, ...)`` gives).

``parity=True`` takes a space-to-depth tensor (B, H/2, W/2, 4C) with
channel ``(p·2+q)·C + c`` and normalizes with the full-resolution
statistics, line for line ``renderloom/models/fastpath.py:
instance_norm_p4``: one shift per (B, C) shared by the four parity
groups (the parity average of the means of packed row 0), per-group
moments of ``x − s`` averaged over the groups, ``(d − m1)·(inv·γ) + β``
with γ, β already parity-tiled (4C,).  It is inference-only, as the JAX
kernel is: a call that autograd would record raises.

:func:`instance_norm` runs the kernels for a CUDA tensor and the twins
for a CPU tensor, through :class:`InstanceNormFunction` whenever a
gradient is wanted; it never falls back from one device's path to the
other's.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

EPS = 1e-5
_MAX_CT = 32            # channels per block (one warp's width)
_THREADS = 256          # csrc/instance_norm.cu kThreads
_TARGET_BLOCKS = 528    # about four blocks per SM on a 132-SM card


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 arithmetic for fp32 and bf16 inputs; float64 stays float64
    (the twins run ``gradcheck``)."""
    return torch.promote_types(dtype, torch.float32)


def _plain_forward(x, scale, bias, slope, eps):
    """(out, stats): the twin's output and its (B, C, 3) residuals
    ``s, m1, inv``."""
    xf = x.to(_compute_dtype(x.dtype))
    s = xf[:, :1, :1, :]
    d = xf - s
    m1 = d.mean(dim=(1, 2), keepdim=True)
    m2 = (d * d).mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    inv = torch.rsqrt(var + eps)
    out = (d - m1) * inv
    if scale is not None:
        out = out * scale
        out = out + bias
    if slope is not None:
        out = torch.where(out >= 0, out, out * slope)
    stats = torch.stack([s, m1, inv], dim=-1)[:, 0, 0]
    return out.to(x.dtype), stats


def _plain_parity(x, scale, bias, slope, eps):
    """``fastpath.instance_norm_p4`` (+ the fused leaky) on x (B, h, w, 4C)."""
    B, C = x.shape[0], x.shape[-1] // 4
    tile = lambda v: v.repeat(1, 4)[:, None, None, :]
    group_mean = lambda v: v.mean(dim=(1, 2)).reshape(B, 4, C).mean(dim=1)
    xf = x.to(_compute_dtype(x.dtype))
    s = group_mean(xf[:, :1])
    d = xf - tile(s)
    m1 = group_mean(d)
    m2 = group_mean(d * d)
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    a = tile(torch.rsqrt(var + eps))
    if scale is not None:
        a = a * scale
    out = (d - tile(m1)) * a
    if bias is not None:
        out = out + bias
    if slope is not None:
        out = torch.where(out >= 0, out, out * slope)
    return out.to(x.dtype)


def instance_norm_plain(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        slope: Optional[float] = None,
                        eps: float = EPS,
                        parity: bool = False) -> torch.Tensor:
    """The forward kernel's arithmetic in plain PyTorch, x (B, H, W, C)."""
    if parity:
        return _plain_parity(x, scale, bias, slope, eps)
    return _plain_forward(x, scale, bias, slope, eps)[0]


def instance_norm_bwd_plain(x: torch.Tensor, dy: torch.Tensor,
                            stats: torch.Tensor,
                            scale: Optional[torch.Tensor] = None,
                            bias: Optional[torch.Tensor] = None,
                            slope: Optional[float] = None
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                       Optional[torch.Tensor]]:
    """The backward kernel's arithmetic in plain PyTorch, line for line
    ``_in_bwd``: (dx, dγ, dβ) from x, the output cotangent ``dy`` and
    the forward's (B, C, 3) residuals; dγ/dβ are None without affine."""
    ct = _compute_dtype(x.dtype)
    s, m1, inv = (v[:, None, None, :] for v in stats.to(ct).unbind(-1))
    dyf = dy.to(ct)
    xhat = ((x.to(ct) - s) - m1) * inv
    if slope is not None:
        z = xhat
        if scale is not None:
            z = z * scale
            z = z + bias
        dyf = torch.where(z >= 0, dyf, dyf * slope)
    g = dyf * scale if scale is not None else dyf
    mg = g.mean(dim=(1, 2), keepdim=True)
    mgx = (g * xhat).mean(dim=(1, 2), keepdim=True)
    dx = ((g - mg - xhat * mgx) * inv).to(x.dtype)
    dscale = ((dyf * xhat).sum(dim=(0, 1, 2)).to(scale.dtype)
              if scale is not None else None)
    dbias = (dyf.sum(dim=(0, 1, 2)).to(bias.dtype)
             if bias is not None else None)
    return dx, dscale, dbias


def _geometry(B: int, n_px: int, C: int):
    ct = min(_MAX_CT, 1 << (C - 1).bit_length())
    rows = _THREADS // ct
    ctiles = -(-C // ct)
    n_split = max(1, min(-(-_TARGET_BLOCKS // (B * ctiles)),
                         -(-n_px // rows)))
    rows_per_split = -(-n_px // n_split)
    n_split = -(-n_px // rows_per_split)
    return ct, n_split, rows_per_split


def _check_input(x: torch.Tensor, name: str):
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, H, W, C) tensor")
    B, H, W, C = x.shape
    if B == 0 or H * W == 0 or C == 0:
        raise ValueError(f"empty instance-norm input {tuple(x.shape)}")
    if H * W * C >= 2 ** 31 or B > 65535:
        raise ValueError(f"instance-norm input too large {tuple(x.shape)}")


def _check_affine(x, scale, bias):
    if (scale is None) != (bias is None):
        raise ValueError("scale and bias come together")
    if scale is not None:
        C = x.shape[-1]
        for t in (scale, bias):
            if (t.shape != (C,) or t.dtype != torch.float32
                    or t.device != x.device or not t.is_contiguous()):
                raise ValueError("scale/bias must be contiguous float32 "
                                 f"({C},) on {x.device}")


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def instance_norm_cuda(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None,
                       slope: Optional[float] = None,
                       eps: float = EPS,
                       stats: Optional[torch.Tensor] = None,
                       parity: bool = False) -> torch.Tensor:
    """Launch ``rl_instance_norm`` on the current stream.  With
    ``stats`` (a contiguous (B, C, 3) float32 CUDA tensor) the kernel
    also writes the residuals ``s, m1, inv`` that the backward reads.
    ``parity`` runs the parity pre-pass and reduction (counted in
    ``instance_norm_cuda.parity_launches``, the standard norm in
    ``.launches``)."""
    _check_input(x, "instance_norm_cuda")
    _check_affine(x, scale, bias)
    B, H, W, C = x.shape
    if parity and (C % 4 or stats is not None):
        raise ValueError("the parity norm needs C divisible by 4 and "
                         "writes no residuals")
    if stats is not None and (stats.shape != (B, C, 3)
                              or stats.dtype != torch.float32
                              or stats.device != x.device
                              or not stats.is_contiguous()):
        raise ValueError(f"stats must be contiguous float32 ({B}, {C}, 3)")
    from renderloom_torch.ops import _build

    fn = _build.load("instance_norm").rl_instance_norm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    n_px = H * W
    ct, n_split, rows_per_split = _geometry(B, n_px, C)
    out = torch.empty_like(x)
    partial = torch.empty((B, n_split, 2, C), dtype=torch.float32,
                          device=x.device)
    shift = (torch.empty((B, C // 4), dtype=torch.float32, device=x.device)
             if parity else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), out.data_ptr(), _ptr(scale), _ptr(bias),
             partial.data_ptr(), _ptr(stats), _ptr(shift), W, B, n_px, C,
             int(x.dtype == torch.bfloat16), int(slope is not None),
             float(slope or 0.0), float(eps), n_split, rows_per_split, ct,
             stream)
    if err != 0:
        raise RuntimeError(f"rl_instance_norm launch failed: CUDA error {err}")
    if parity:
        instance_norm_cuda.parity_launches += 1
    else:
        instance_norm_cuda.launches += 1
    return out


# kernel launches since the last reset: standard and parity norms
instance_norm_cuda.launches = 0
instance_norm_cuda.parity_launches = 0


def instance_norm_bwd_cuda(x: torch.Tensor, dy: torch.Tensor,
                           stats: torch.Tensor,
                           scale: Optional[torch.Tensor] = None,
                           bias: Optional[torch.Tensor] = None,
                           slope: Optional[float] = None
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                      Optional[torch.Tensor]]:
    """Launch ``rl_instance_norm_bwd`` on the current stream: (dx, dγ,
    dβ) as :func:`instance_norm_bwd_plain` returns them."""
    _check_input(x, "instance_norm_bwd_cuda")
    _check_affine(x, scale, bias)
    B, H, W, C = x.shape
    if (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device
            or not dy.is_contiguous()):
        raise ValueError("dy must be contiguous, with x's shape and dtype")
    if (stats.shape != (B, C, 3) or stats.dtype != torch.float32
            or stats.device != x.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be contiguous float32 ({B}, {C}, 3)")
    from renderloom_torch.ops import _build

    fn = _build.load("instance_norm").rl_instance_norm_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    n_px = H * W
    ct, n_split, rows_per_split = _geometry(B, n_px, C)
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale) if scale is not None else None
    dbias = torch.empty_like(bias) if bias is not None else None
    partial = torch.empty((B, n_split, 2, C), dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), dy.data_ptr(), stats.data_ptr(), _ptr(scale),
             _ptr(bias), dx.data_ptr(), _ptr(dscale), _ptr(dbias),
             partial.data_ptr(), B, n_px, C, int(x.dtype == torch.bfloat16),
             int(slope is not None), float(slope or 0.0), n_split,
             rows_per_split, ct, stream)
    if err != 0:
        raise RuntimeError(
            f"rl_instance_norm_bwd launch failed: CUDA error {err}")
    instance_norm_bwd_cuda.launches += 1
    return dx, dscale, dbias


instance_norm_bwd_cuda.launches = 0  # kernel launches since the last reset


class InstanceNormFunction(torch.autograd.Function):
    """Instance norm with its hand-written backward: the forward saves x
    and the (B, C, 3) residuals, the residual set of ``_in_fwd``.  CUDA
    tensors run K2 and K2b, CPU tensors the twins."""

    @staticmethod
    def forward(ctx, x, scale, bias, slope, eps):
        if x.is_cuda:
            stats = torch.empty((x.shape[0], x.shape[-1], 3),
                                dtype=torch.float32, device=x.device)
            out = instance_norm_cuda(x, scale, bias, slope, eps, stats)
        else:
            out, stats = _plain_forward(x, scale, bias, slope, eps)
        ctx.save_for_backward(x, stats, scale, bias)
        ctx.slope = slope
        return out

    @staticmethod
    def backward(ctx, dy):
        x, stats, scale, bias = ctx.saved_tensors
        bwd = instance_norm_bwd_cuda if x.is_cuda else instance_norm_bwd_plain
        dx, dscale, dbias = bwd(x, dy.contiguous(), stats, scale, bias,
                                ctx.slope)
        return dx, dscale, dbias, None, None


def instance_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  slope: Optional[float] = None,
                  eps: float = EPS, parity: bool = False) -> torch.Tensor:
    """Instance norm of NHWC ``x``: the CUDA kernels for a CUDA tensor,
    the plain twins for a CPU tensor.  When autograd records, the call
    goes through :class:`InstanceNormFunction`, so the gradient reaches
    x, γ and β on either device.  ``parity``: the space-to-depth norm,
    inference only (a call autograd would record raises)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    wants_grad = torch.is_grad_enabled() and (
        x.requires_grad or (scale is not None and scale.requires_grad)
        or (bias is not None and bias.requires_grad))
    if wants_grad:
        if parity:
            raise RuntimeError("the parity instance norm is inference-only: "
                               "it has no backward")
        return InstanceNormFunction.apply(x, scale, bias, slope, eps)
    if x.is_cuda:
        return instance_norm_cuda(x, scale, bias, slope, eps, parity=parity)
    return instance_norm_plain(x, scale, bias, slope, eps, parity)
