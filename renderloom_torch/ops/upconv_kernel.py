"""Nearest ×2 upsample fused into the 3×3, stride-1, float32 convolution
that follows it: the CUDA kernel ``csrc/upconv.cu``, its plain PyTorch
twin, the weight fold both read, and the registered operator
``renderloom::upconv`` that a ``torch.export`` program calls.

It replaces no TPU kernel: the JAX package leaves the standard mask
net's ``upsample2x`` and convolution to XLA.  cuDNN runs that
convolution in float32 through its FFT path (PERF.md), so
:class:`renderloom_torch.models.layers.Conv` sends its float32 up
convolutions that want no gradient here (see its ``forward``).

The identity (exact, not an approximation): output pixel (2i+a, 2j+b)
of ``conv3x3(upsample2x(x))`` sees only the low-resolution rows i−1+a+r
and columns j−1+b+s, r, s ∈ {0, 1}.  Each output parity (a, b) is
therefore a 2×2 convolution of x whose taps are the 3×3 taps that land
on the same low-resolution pixel, summed: along an axis, parity 0 takes
(k0, k1 + k2) and parity 1 (k0 + k1, k2).  Rows and columns outside x
are exactly the upsampled tensor's zero padding.  :func:`fold_weights`
sums the taps once per weight, laid out [parity][tap][Cin][Cout]
(parity a·2 + b, tap r·2 + s), zero-padded to the kernel's tile;
:func:`upconv_plain` (the twin) and the kernel read the same fold, with
float32 accumulation throughout.

:func:`upconv` runs the kernel for a CUDA tensor, the operator under
``torch.export`` and the twin for a CPU tensor; it never falls back
from one to another.  Inference only: no autograd is registered.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from renderloom_torch.ops import _build

# (BM, BN, BK): output pixels, output channels and input channels of a
# K step per block tile (csrc/upconv.cu rl_upconv's ``tile``)
TILES = ((128, 128, 32), (256, 64, 32), (512, 32, 32))


def tile(cout: int) -> int:
    """The block tile for ``cout`` output channels: the narrowest N tile
    that holds them, 128 at most."""
    return 0 if cout > 64 else 1 if cout > 32 else 2


def _fold(k: torch.Tensor, parity: int, dim: int):
    """The two low-resolution taps along ``dim`` of a 3-tap kernel axis
    for output ``parity``: (k0, k1 + k2) or (k0 + k1, k2)."""
    k0, k1, k2 = k.unbind(dim)
    return (k0, k1 + k2) if parity == 0 else (k0 + k1, k2)


def fold_weights(weight: torch.Tensor) -> torch.Tensor:
    """The OIHW 3×3 ``weight`` folded per output parity: (4, 4, Cin',
    Cout') with [a·2 + b][r·2 + s][c][o], zeros in the padding up to
    the tile's BK and BN (Cin' and Cout')."""
    O, I = weight.shape[:2]
    _, bn, bk = TILES[tile(O)]
    w = weight.permute(2, 3, 1, 0)              # (ky, kx, I, O)
    taps = [t for a in (0, 1) for b in (0, 1)
            for row in _fold(w, a, 0) for t in _fold(row, b, 0)]
    wf = torch.stack(taps).reshape(4, 4, I, O)
    return F.pad(wf, (0, -O % bn, 0, -I % bk)).contiguous()


def upconv_plain(x: torch.Tensor, wf: torch.Tensor,
                 bias: Optional[torch.Tensor], cout: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: x (B, h, w, Cin) NHWC,
    ``wf`` from :func:`fold_weights`, → (B, 2h, 2w, cout), one 2×2
    convolution per output parity on the zero-padded input."""
    B, h, w, cin = x.shape
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1))
    ys = []
    for p in range(4):
        a, b = divmod(p, 2)
        k = wf[p, :, :cin, :cout].reshape(2, 2, cin, cout)
        ys.append(F.conv2d(xp[:, :, a:a + h + 1, b:b + w + 1],
                           k.permute(3, 2, 0, 1), bias))
    y = torch.stack(ys, -1).reshape(B, cout, h, w, 2, 2)
    return y.permute(0, 2, 4, 3, 5, 1).reshape(B, 2 * h, 2 * w, cout)


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The compiled kernel, loaded and bound once."""
    global _lib
    if _lib is None:
        lib = _build.load("upconv")
        lib.rl_upconv.restype = ctypes.c_int
        lib.rl_upconv.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                                  + [ctypes.c_void_p])
        _lib = lib
    return _lib


def upconv_cuda(x: torch.Tensor, wf: torch.Tensor,
                bias: Optional[torch.Tensor], cout: int) -> torch.Tensor:
    """Launch ``rl_upconv`` on the current stream (counted in
    ``upconv_cuda.launches``): :func:`upconv_plain`'s function.  ``wf``
    must start on 16 bytes: the kernel reads it in 16-byte copies."""
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 (B, h, w, C) "
                         "tensor")
    B, h, w, cin = x.shape
    if B * h * w * cin == 0 or cout < 1:
        raise ValueError(f"empty upconv input {tuple(x.shape)} -> {cout}")
    if 4 * B * h * w * max(cin, cout) >= 2 ** 31:
        raise ValueError(f"upconv input too large {tuple(x.shape)}")
    _, bn, bk = TILES[tile(cout)]
    want = (4, 4, -(-cin // bk) * bk, -(-cout // bn) * bn)
    if (tuple(wf.shape) != want or wf.dtype != torch.float32
            or wf.device != x.device or not wf.is_contiguous()
            or wf.data_ptr() % 16):
        raise ValueError(f"wf must be contiguous float32 {want} on "
                         f"{x.device}, 16-byte aligned (fold_weights)")
    if bias is not None and (bias.shape != (cout,)
                             or bias.dtype != torch.float32
                             or bias.device != x.device
                             or not bias.is_contiguous()):
        raise ValueError(f"bias must be contiguous float32 ({cout},) on "
                         f"{x.device}")
    if not x.is_cuda:
        raise ValueError("upconv_cuda needs a CUDA tensor")
    out = torch.empty((B, 2 * h, 2 * w, cout), dtype=torch.float32,
                      device=x.device)
    err = _library().rl_upconv(
        x.data_ptr(), wf.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        B, h, w, cin, cout, want[2], want[3], tile(cout),
        int(cin % 4 == 0 and x.data_ptr() % 16 == 0),
        torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        raise RuntimeError(f"rl_upconv launch failed: CUDA error {err}")
    upconv_cuda.launches += 1
    return out


upconv_cuda.launches = 0     # kernel launches since the last reset


@torch.library.custom_op("renderloom::upconv", mutates_args=())
def upconv_op(x: torch.Tensor, wf: torch.Tensor,
              bias: Optional[torch.Tensor], cout: int) -> torch.Tensor:
    """The kernel as the registered operator ``renderloom::upconv``,
    what a ``torch.export`` program of the port calls:
    :func:`upconv_cuda` for a CUDA tensor (counted there),
    :func:`upconv_plain` for a CPU tensor."""
    if x.is_cuda:
        return upconv_cuda(x, wf, bias, cout)
    return upconv_plain(x, wf, bias, cout)


@upconv_op.register_fake
def _upconv_fake(x, wf, bias, cout):
    B, h, w, _ = x.shape
    return x.new_empty((B, 2 * h, 2 * w, cout))


def upconv(x: torch.Tensor, wf: torch.Tensor,
           bias: Optional[torch.Tensor], cout: int) -> torch.Tensor:
    """``conv3x3(upsample2x(x)) + bias`` of a float32 NHWC ``x`` from its
    folded weights ``wf``: the kernel for a CUDA tensor, the operator
    under ``torch.export``, the twin for a CPU tensor."""
    if _build.traced(x):
        return torch.ops.renderloom.upconv(x, wf, bias, cout)
    if x.is_cuda:
        return upconv_cuda(x, wf, bias, cout)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return upconv_plain(x, wf, bias, cout)
