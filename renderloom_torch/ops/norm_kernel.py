"""Instance norm over NHWC with optional affine and fused leaky: the CUDA
kernel ``csrc/instance_norm.cu`` and its plain PyTorch twin.

Replaces the TPU kernel ``renderloom/ops/norm_pallas.py:
instance_norm_fused`` (non-parity, forward).  On the H100 it is bound
by device-memory bytes: two reads and one write of x (moments, then
apply), with partial sums per pixel range in a scratch buffer and a
fixed-order reduction, so results do not depend on block scheduling.
See the source for the design.

Numerics are the fp32 contract of the JAX package's
``models/layers.py:_in_moments``/``_in_apply``: moments of ``x - s``
with ``s = x[b, 0, 0, c]`` accumulated in fp32, and the centered apply
``((x - s) - m1) · rsqrt(var + eps) · γ + β``; the output has x's dtype.

:func:`instance_norm` takes the twin for a CPU tensor and the kernel for
a CUDA tensor; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

EPS = 1e-5
_MAX_CT = 32            # channels per block (one warp's width)
_THREADS = 256          # csrc/instance_norm.cu kThreads
_TARGET_BLOCKS = 528    # about four blocks per SM on a 132-SM card


def instance_norm_plain(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        slope: Optional[float] = None,
                        eps: float = EPS) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, x (B, H, W, C)."""
    xf = x.float()
    s = xf[:, :1, :1, :]
    d = xf - s
    m1 = d.mean(dim=(1, 2), keepdim=True)
    m2 = (d * d).mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    out = (d - m1) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale
        out = out + bias
    if slope is not None:
        out = torch.where(out >= 0, out, out * slope)
    return out.to(x.dtype)


def _geometry(B: int, n_px: int, C: int):
    ct = min(_MAX_CT, 1 << (C - 1).bit_length())
    rows = _THREADS // ct
    ctiles = -(-C // ct)
    n_split = max(1, min(-(-_TARGET_BLOCKS // (B * ctiles)),
                         -(-n_px // rows)))
    rows_per_split = -(-n_px // n_split)
    n_split = -(-n_px // rows_per_split)
    return ct, n_split, rows_per_split


def instance_norm_cuda(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None,
                       slope: Optional[float] = None,
                       eps: float = EPS) -> torch.Tensor:
    """Launch ``rl_instance_norm`` on the current stream."""
    if not x.is_cuda:
        raise ValueError("instance_norm_cuda needs a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, H, W, C) tensor")
    B, H, W, C = x.shape
    n_px = H * W
    if B == 0 or n_px == 0 or C == 0:
        raise ValueError(f"empty instance-norm input {tuple(x.shape)}")
    if n_px * C >= 2 ** 31 or B > 65535:
        raise ValueError(f"instance-norm input too large {tuple(x.shape)}")
    if (scale is None) != (bias is None):
        raise ValueError("scale and bias come together")
    if scale is not None:
        for t in (scale, bias):
            if (t.shape != (C,) or t.dtype != torch.float32
                    or t.device != x.device or not t.is_contiguous()):
                raise ValueError("scale/bias must be contiguous float32 "
                                 f"({C},) on {x.device}")
    from renderloom_torch.ops import _build

    lib = _build.load("instance_norm")
    fn = lib.rl_instance_norm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    ct, n_split, rows_per_split = _geometry(B, n_px, C)
    out = torch.empty_like(x)
    partial = torch.empty((B, n_split, 2, C), dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), out.data_ptr(),
             scale.data_ptr() if scale is not None else None,
             bias.data_ptr() if bias is not None else None,
             partial.data_ptr(), B, n_px, C,
             int(x.dtype == torch.bfloat16), int(slope is not None),
             float(slope or 0.0), float(eps), n_split, rows_per_split, ct,
             stream)
    if err != 0:
        raise RuntimeError(f"rl_instance_norm launch failed: CUDA error {err}")
    instance_norm_cuda.launches += 1
    return out


instance_norm_cuda.launches = 0     # kernel launches since the last reset


def instance_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  slope: Optional[float] = None,
                  eps: float = EPS) -> torch.Tensor:
    """Instance norm of NHWC ``x``: the CUDA kernel for a CUDA tensor,
    the plain twin for a CPU tensor."""
    if x.is_cuda:
        return instance_norm_cuda(x, scale, bias, slope, eps)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return instance_norm_plain(x, scale, bias, slope, eps)
