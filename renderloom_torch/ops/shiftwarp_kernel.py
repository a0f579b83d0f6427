"""The clipped separable shift warp as a gather, alone and fused with the
Lucas-Kanade backgrounds' time blend: the CUDA kernels
``csrc/shiftwarp.cu``, their plain PyTorch twins, and the registered
operators ``renderloom::shift_warp`` and ``renderloom::shift_warp_blend``
that a ``torch.export`` program calls.

They replace no TPU kernel: the JAX package writes the warp as a sum
over 2R + 2 integer shifts per axis (``renderloom/ops/flow.py:
_shift_resample1d``), which XLA fuses.  Run as PyTorch ops on the card,
that loop is some 1,400 elementwise launches a clip at the serving
pipeline's R = 16, where for every pixel only two of the 34 weights
along an axis are not zero.  :func:`renderloom_torch.ops.flow.
backward_warp_shift` and ``upsample_background`` send their float32 card
tensors here.

The identity (exact, bit for bit the loop): along an axis, with f
clamped to ±R, f0 = floor(f) and w = f − f0, the loop's value at i is
``(1 − w)·p[clamp(i + f0)] + w·p[clamp(i + f0 + 1)]``, the two products
and the sum each rounded once (every other term adds an exact zero);
the vertical pass reads the horizontal result at rows clamp(y + f0y)
and the next, each resampled with its own x-flow.  :func:`shift_warp_plain`
computes exactly that with two gathers an axis; the kernel with four
horizontal taps and one vertical blend a pixel.

The fused form takes the keyframes (K, H, W, C), the full-resolution
flows (2(K−1), H, W, 2), first 0→1 of every pair then 1→0, and the
consistency errors (2(K−1), H, W, 1), and returns the whole
((K−1)·rate + 1, H, W, C) stream: :func:`blend_stream`, which
``upsample_background`` runs on its other paths, with the gather warp.
Its times t = j/rate: the card's PyTorch divides a tensor by a Python
number as a product with the rounded reciprocal, so the kernel takes
fl(j · fl(1/rate)); this is j/rate rounded whenever rate is a power of
two or 3 (the serving pipeline's 4 among them).

Each wrapper runs the kernel for a CUDA tensor, the operator under
``torch.export`` and the twin for a CPU tensor; it never falls back
from one to another.  Inference only: no autograd is registered.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from renderloom_torch.ops import _build


def _resample_gather(img: torch.Tensor, f: torch.Tensor, axis: int,
                     R: int) -> torch.Tensor:
    """``flow._shift_resample1d`` of (B, H, W, C) ``img`` along ``axis``
    (1 = rows, 2 = columns) by (B, H, W) offsets ``f``, as two gathers."""
    f = torch.clamp(f, -float(R), float(R))
    f0 = torch.floor(f)
    w = (f - f0)[..., None]
    n = img.shape[axis]
    pos = torch.arange(n, device=img.device).reshape(
        (1, n, 1) if axis == 1 else (1, 1, n))
    i0 = pos + f0.long()
    take = lambda i: torch.gather(img, axis, i.clamp(0, n - 1)[..., None]
                                  .expand(img.shape))
    return (1.0 - w) * take(i0) + w * take(i0 + 1)


def shift_warp_plain(img: torch.Tensor, flow: torch.Tensor,
                     max_disp: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: ``backward_warp_shift``
    of (B, H, W, C) ``img`` by (B, H, W, 2) ``flow`` (xy), horizontal
    pass then vertical, with gathers in place of the shift loop."""
    R = int(max_disp)
    out = _resample_gather(img, flow[..., 0], 2, R)
    return _resample_gather(out, flow[..., 1], 1, R)


def blend_stream(frames: torch.Tensor, flows: torch.Tensor,
                 errs: torch.Tensor, rate: int,
                 warp: Callable) -> torch.Tensor:
    """(K, H, W, C) keyframes → ((K−1)·rate + 1, H, W, C): at every time
    t = j/rate of pair k, keyframe k warped by t·f10 and keyframe k+1 by
    (1−t)·f01 (``warp(img, flow)``), blended by (1−t, t), each weighted
    down by its consistency error (``errs``: e0 of every pair, then e1);
    the keyframes in their slots."""
    K, H, W, C = frames.shape
    p0, p1 = frames[:-1], frames[1:]
    e0, e1 = errs[:K - 1], errs[K - 1:]
    f01, f10 = flows[:K - 1], flows[K - 1:]
    T = rate - 1
    t = (torch.arange(1, rate, dtype=torch.float32, device=frames.device)
         / rate).reshape(T, 1, 1, 1, 1)
    rep = lambda x: x[None].expand(T, *x.shape).reshape(-1, *x.shape[1:])
    flat = lambda x: x.reshape(T * (K - 1), *x.shape[2:])
    w0 = warp(rep(p0), flat(t * f10))
    w1 = warp(rep(p1), flat((1.0 - t) * f01))
    a0 = (1.0 - t) / (1.0 + e0)
    a1 = t / (1.0 + e1)
    w0 = w0.reshape(T, K - 1, H, W, C)
    w1 = w1.reshape(T, K - 1, H, W, C)
    mids = (a0 * w0 + a1 * w1) / (a0 + a1)          # (T, K-1, H, W, C)
    grp = torch.cat([frames[:-1, None], mids.transpose(0, 1)], dim=1)
    return torch.cat([grp.reshape((K - 1) * rate, H, W, C), frames[-1:]])


def shift_warp_blend_plain(frames: torch.Tensor, flows: torch.Tensor,
                           errs: torch.Tensor, rate: int,
                           max_disp: int) -> torch.Tensor:
    """The fused kernel's function in plain PyTorch: :func:`blend_stream`
    with :func:`shift_warp_plain` as the warp."""
    return blend_stream(frames, flows, errs, rate,
                        lambda x, f: shift_warp_plain(x, f, max_disp))


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The compiled kernels, loaded and bound once."""
    global _lib
    if _lib is None:
        lib = _build.load("shiftwarp")
        for fn, n_ptr, n_int in ((lib.rl_shift_warp, 3, 5),
                                 (lib.rl_shift_warp_blend, 4, 6)):
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_void_p])
        _lib = lib
    return _lib


def _check(name: str, x: torch.Tensor, shape: tuple, device,
           align: int = 4):
    """Raise unless ``x`` is a contiguous float32 tensor of ``shape`` on
    ``device`` that starts on ``align`` bytes (8 for flows: the kernels
    read a pixel's flow vector in one 8-byte load)."""
    if (tuple(x.shape) != tuple(shape) or x.dtype != torch.float32
            or x.device != device or not x.is_contiguous()
            or x.data_ptr() % align):
        raise ValueError(f"{name} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}, {align}-byte "
                         f"aligned; got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")


def _check_disp(max_disp: int):
    if int(max_disp) < 1:
        raise ValueError(f"max_disp must be at least 1, got {max_disp}")


def shift_warp_cuda(img: torch.Tensor, flow: torch.Tensor,
                    max_disp: int) -> torch.Tensor:
    """Launch ``rl_shift_warp`` on the current stream (counted in
    ``shift_warp_cuda.launches``): :func:`shift_warp_plain`'s function
    for a (B, H, W, C) ``img`` and (B, H, W, 2) ``flow``."""
    if img.dim() != 4 or img.numel() == 0:
        raise ValueError(f"img must be a non-empty (B, H, W, C) tensor, "
                         f"got {tuple(img.shape)}")
    B, H, W, C = img.shape
    _check("img", img, (B, H, W, C), img.device)
    _check("flow", flow, (B, H, W, 2), img.device, align=8)
    _check_disp(max_disp)
    if img.numel() >= 2 ** 31 or flow.numel() >= 2 ** 31:
        raise ValueError(f"shift_warp input too large {tuple(img.shape)}")
    if not img.is_cuda:
        raise ValueError("shift_warp_cuda needs a CUDA tensor")
    out = torch.empty_like(img)
    err = _library().rl_shift_warp(
        img.data_ptr(), flow.data_ptr(), out.data_ptr(), B, H, W, C,
        int(max_disp), torch._C._cuda_getCurrentRawStream(img.device.index))
    if err != 0:
        raise RuntimeError(f"rl_shift_warp launch failed: CUDA error {err}")
    shift_warp_cuda.launches += 1
    return out


shift_warp_cuda.launches = 0     # kernel launches since the last reset


def shift_warp_blend_cuda(frames: torch.Tensor, flows: torch.Tensor,
                          errs: torch.Tensor, rate: int,
                          max_disp: int) -> torch.Tensor:
    """Launch ``rl_shift_warp_blend`` on the current stream (counted in
    ``shift_warp_blend_cuda.launches``): :func:`shift_warp_blend_plain`'s
    function, up to the times' rounding (module docstring)."""
    if frames.dim() != 4 or frames.shape[0] < 2 or frames[0].numel() == 0:
        raise ValueError(f"frames must be (K >= 2, H, W, C), got "
                         f"{tuple(frames.shape)}")
    K, H, W, C = frames.shape
    if not 1 <= int(rate) or K - 1 > 65535:
        raise ValueError(f"rate {rate} with {K} keyframes")
    _check("frames", frames, (K, H, W, C), frames.device)
    _check("flows", flows, (2 * (K - 1), H, W, 2), frames.device, align=8)
    _check("errs", errs, (2 * (K - 1), H, W, 1), frames.device)
    _check_disp(max_disp)
    L = (K - 1) * int(rate) + 1
    if L * H * W * max(C, 2) >= 2 ** 31:
        raise ValueError(f"shift_warp_blend output too large "
                         f"({L}, {H}, {W}, {C})")
    if not frames.is_cuda:
        raise ValueError("shift_warp_blend_cuda needs a CUDA tensor")
    out = torch.empty((L, H, W, C), dtype=torch.float32,
                      device=frames.device)
    err = _library().rl_shift_warp_blend(
        frames.data_ptr(), flows.data_ptr(), errs.data_ptr(), out.data_ptr(),
        K, H, W, C, int(rate), int(max_disp),
        torch._C._cuda_getCurrentRawStream(frames.device.index))
    if err != 0:
        raise RuntimeError(f"rl_shift_warp_blend launch failed: CUDA error "
                           f"{err}")
    shift_warp_blend_cuda.launches += 1
    return out


shift_warp_blend_cuda.launches = 0     # kernel launches since the last reset


@torch.library.custom_op("renderloom::shift_warp", mutates_args=())
def shift_warp_op(img: torch.Tensor, flow: torch.Tensor,
                  max_disp: int) -> torch.Tensor:
    """The warp as the registered operator ``renderloom::shift_warp``,
    what a ``torch.export`` program of the port calls:
    :func:`shift_warp_cuda` for a CUDA tensor (counted there),
    :func:`shift_warp_plain` for a CPU tensor."""
    if img.is_cuda:
        return shift_warp_cuda(img, flow, max_disp)
    return shift_warp_plain(img, flow, max_disp)


@shift_warp_op.register_fake
def _shift_warp_fake(img, flow, max_disp):
    return torch.empty_like(img)


@torch.library.custom_op("renderloom::shift_warp_blend", mutates_args=())
def shift_warp_blend_op(frames: torch.Tensor, flows: torch.Tensor,
                        errs: torch.Tensor, rate: int,
                        max_disp: int) -> torch.Tensor:
    """The fused warp and blend as the registered operator
    ``renderloom::shift_warp_blend``: :func:`shift_warp_blend_cuda` for a
    CUDA tensor, :func:`shift_warp_blend_plain` for a CPU tensor."""
    if frames.is_cuda:
        return shift_warp_blend_cuda(frames, flows, errs, rate, max_disp)
    return shift_warp_blend_plain(frames, flows, errs, rate, max_disp)


@shift_warp_blend_op.register_fake
def _shift_warp_blend_fake(frames, flows, errs, rate, max_disp):
    K, H, W, C = frames.shape
    return frames.new_empty(((K - 1) * rate + 1, H, W, C))


def _dispatch(x: torch.Tensor, op, cuda, plain, *args) -> torch.Tensor:
    if _build.traced(x):
        return op(x, *args)
    if x.is_cuda:
        return cuda(x, *args)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return plain(x, *args)


def shift_warp(img: torch.Tensor, flow: torch.Tensor,
               max_disp: int) -> torch.Tensor:
    """``backward_warp_shift(img, flow, max_disp)`` of a float32 NHWC
    ``img``: the kernel for a CUDA tensor, the operator under
    ``torch.export``, the twin for a CPU tensor."""
    return _dispatch(img, torch.ops.renderloom.shift_warp, shift_warp_cuda,
                     shift_warp_plain, flow, max_disp)


def shift_warp_blend(frames: torch.Tensor, flows: torch.Tensor,
                     errs: torch.Tensor, rate: int,
                     max_disp: int) -> torch.Tensor:
    """The LK backgrounds' stream from full-resolution flows and errors:
    the fused kernel for a CUDA tensor, the operator under
    ``torch.export``, the twin for a CPU tensor."""
    return _dispatch(frames, torch.ops.renderloom.shift_warp_blend,
                     shift_warp_blend_cuda, shift_warp_blend_plain, flows,
                     errs, rate, max_disp)
