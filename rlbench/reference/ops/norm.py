"""Instance norm over NHWC with optional affine and fused leaky, in
plain float32 PyTorch: the shifted fp32 contract (moments of ``x - s``
with ``s = x[b, 0, 0, c]``, the centered apply, then γ, β and the
leaky).  Autograd differentiates the composition; there is no kernel
and no closed-form backward here.

:func:`observe_norms` lets a caller see every call (input shape and
dtype, whether it is affine), which the norm roofline metric counts
bytes from.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import torch

EPS = 1e-5

_observers: List[Callable] = []


@contextlib.contextmanager
def observe_norms(callback: Callable):
    """Call ``callback(x, scale, slope)`` on every norm inside the
    block."""
    _observers.append(callback)
    try:
        yield
    finally:
        _observers.remove(callback)


def instance_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  slope: Optional[float] = None,
                  eps: float = EPS, parity: bool = False) -> torch.Tensor:
    if parity:
        raise ValueError("the reference runs the standard layout only")
    for cb in _observers:
        cb(x, scale, slope)
    xf = x.float()
    s = xf[:, :1, :1, :]
    d = xf - s
    m1 = d.mean(dim=(1, 2), keepdim=True)
    m2 = (d * d).mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    out = (d - m1) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale + bias
    if slope is not None:
        out = torch.where(out >= 0, out, out * slope)
    return out.to(x.dtype)
