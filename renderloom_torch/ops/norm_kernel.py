"""Instance norm over NHWC with optional affine and fused leaky: the CUDA
kernels ``csrc/instance_norm.cu`` (forward K2, backward K2b), their
plain PyTorch twins, and the ``autograd.Function`` that joins them.

K2 replaces the TPU kernel ``renderloom/ops/norm_pallas.py:
instance_norm_fused`` (forward, ``parity=False`` and ``parity=True``).
K2b is the backward the JAX package wrote as a custom VJP
(``renderloom/models/layers.py:_in_bwd``), and in its r3centered mode
the gradient JAX's autodiff takes of the bf16 dispatch.  On the H100
their large calls are bound by device-memory bytes and their small ones
by a fixed device floor.  Each call is one launch, on one of two paths
that :func:`_plan` picks from the shape and the card (see the source
for the design):

* the **cluster path** (the r3centered mode, forward and backward,
  wherever a slab fits in one thread-block cluster: every bf16
  main-path call of 80×120 pixels or fewer): an ordinary launch with a
  cluster dimension, one cluster per slab, shared memory sized to the
  slab; the blocks of a slab exchange their partial sums through
  distributed shared memory behind a cluster barrier, the only barrier.
  It takes away what set the small calls' floor: the grid barriers, the
  partial rows in L2 and the shared-memory reduction tree.  It needs no
  scratch; its backward at an affine call site sums dγ/dβ over b in
  batch order in the last slab to finish, through a small workspace
  kept per device and stream (:func:`_workspace`);
* the **grid path** (everything else): one cooperative launch of a
  persistent grid that copies its chunk of the input into shared
  memory, reads it from device memory once, reduces the per-(B, C) sums
  from partial rows in L2 behind a grid barrier and writes the output
  from shared memory; what bounds it at the main paths' largest calls is
  the chain of load, sums and apply inside each block.

Both sum in a fixed order with no float atomics, so two calls give the
same bits.  A refused launch raises; neither path falls back to the
other or to the twin.

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

``r3centered=True`` is the bf16 contract of the JAX package's
``models/layers.py:instance_norm`` (its dtype dispatch, :186-188 and
:226-236), which XLA computes there (no Pallas kernel): unshifted fp32
moments ``m1 = E[x]``, ``m2 = E[x²]``, ``n = bf16((x − m1)·rsqrt(var +
eps))`` rounded to nearest even, and, at an affine call site, ``n·γ +
β`` (then the fused leaky) returned in float32; without affine ``n`` in
bf16.  It is K2's forward with the shift 0 and the rounding before the
affine; its residuals are ``(0, m1, inv)``.  JAX has no custom VJP
there and differentiates the body, whose gradient K2b's r3centered mode
computes in closed form: with ``x̂ = (x − m1)·inv`` unrounded and ``n =
bf16(x̂)``, dz = dy through the leaky (its sign from ``n·γ + β``), at
an affine call site (dy float32) ``g = bf16(dz·γ)`` — the transpose of
the cast of n rounds its cotangent — else ``g = dz`` (dy bf16), ``dx =
bf16(inv·(g − E[g] − x̂·E[g·x̂]))``, ``dγ = Σ dz·n``, ``dβ = Σ dz``.

:func:`instance_norm` picks the contract by the input, as the JAX
dispatch does: r3centered for a bf16 tensor in the standard layout, the
shifted fp32 contract otherwise, the parity norm when asked.  It runs
the kernels for a CUDA tensor and the twins for a CPU tensor, through
:class:`InstanceNormFunction` whenever a gradient is wanted (the
shifted and the r3centered contract; the parity norm is inference-only);
it never falls back from one device's path to the other's.  Its
inference calls under ``torch.export`` go through the registered
operator ``renderloom::instance_norm`` (:func:`instance_norm_op`, with
a fake that gives the output's shape and dtype), so that an exported
program carries K2 and a loaded one launches it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from renderloom_torch.ops import _build

EPS = 1e-5
_THREADS = 512          # csrc/instance_norm.cu kThreads
_FWD_TABLES = 7         # per-channel fp32 tables in shared memory:
_BWD_TABLES = 9         # csrc/instance_norm.cu norm_{fwd,bwd}_kernel,
                        # the backward's with two sums (7 + n_sums)
_BLOCK_SUMS_DEPTH = 40  # partial values one thread may add in a block
# The cluster path (csrc/instance_norm.cu cluster_fwd / cluster_bwd):
_C_GROUPS = (128, 64, 32, 16)       # channels per slab: 16-byte columns,
                                    # a power of two that divides a warp
_C_CLUSTERS = (1, 2, 3, 4, 5, 6, 7, 8)   # blocks per cluster: the
                                        # portable sizes
_C_MAX_ROWS = 2048                  # pixels a block may hold
_C_ROW_BYTES = 64                   # a slab's row of its widest input
_C_BLOCKS = 96                      # blocks a call should spread over
_C_MIN_ROWS = 200                   # pixels a block keeps at least


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


def _plain_r3_forward(x, scale, bias, slope, eps):
    """(out, stats): ``layers.instance_norm``'s bf16 body
    (``r3centered``) + the fused leaky — bf16 ``n`` without affine,
    float32 ``n·γ + β`` with it — and its (B, C, 3) residuals ``0, m1,
    inv``."""
    x32 = x.float()
    m1 = x32.mean(dim=(1, 2), keepdim=True)
    m2 = (x32 * x32).mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    inv = torch.rsqrt(var + eps)
    out = ((x32 - m1) * inv).to(torch.bfloat16)
    if scale is not None:
        out = out.float() * scale
        out = out + bias
    if slope is not None:
        out = torch.where(out >= 0, out, out * slope)
    stats = torch.stack([torch.zeros_like(m1), m1, inv], dim=-1)[:, 0, 0]
    return out, stats


def _plain_r3centered(x, scale, bias, slope, eps):
    """:func:`_plain_r3_forward`'s output."""
    return _plain_r3_forward(x, scale, bias, slope, eps)[0]


def instance_norm_plain(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        slope: Optional[float] = None,
                        eps: float = EPS,
                        parity: bool = False,
                        r3centered: bool = False) -> torch.Tensor:
    """The forward kernel's arithmetic in plain PyTorch, x (B, H, W, C)."""
    if parity:
        return _plain_parity(x, scale, bias, slope, eps)
    if r3centered:
        return _plain_r3centered(x, scale, bias, slope, eps)
    return _plain_forward(x, scale, bias, slope, eps)[0]


def instance_norm_bwd_plain(x: torch.Tensor, dy: torch.Tensor,
                            stats: torch.Tensor,
                            scale: Optional[torch.Tensor] = None,
                            bias: Optional[torch.Tensor] = None,
                            slope: Optional[float] = None,
                            r3centered: bool = False
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                       Optional[torch.Tensor]]:
    """The backward kernel's arithmetic in plain PyTorch, line for line
    ``_in_bwd``: (dx, dγ, dβ) from x, the output cotangent ``dy`` and
    the forward's (B, C, 3) residuals; dγ/dβ are None without affine.
    ``r3centered``: the gradient of the bf16 contract (module docstring),
    for a bf16 x and the residuals ``(0, m1, inv)``."""
    ct = _compute_dtype(x.dtype)
    s, m1, inv = (v[:, None, None, :] for v in stats.to(ct).unbind(-1))
    dyf = dy.to(ct)
    xhat = ((x.to(ct) - s) - m1) * inv
    # the forward rounded x̂ to bf16 before the affine and the leaky
    n = xhat.to(torch.bfloat16).to(ct) if r3centered else xhat
    if slope is not None:
        z = n
        if scale is not None:
            z = z * scale
            z = z + bias
        dz = dyf * slope
        if r3centered and scale is None:    # the leaky of a bf16 output
            dz = dz.to(torch.bfloat16).to(ct)
        dyf = torch.where(z >= 0, dyf, dz)
    g = dyf * scale if scale is not None else dyf
    if r3centered and scale is not None:    # the cotangent of the bf16 n
        g = g.to(torch.bfloat16).to(ct)
    mg = g.mean(dim=(1, 2), keepdim=True)
    mgx = (g * xhat).mean(dim=(1, 2), keepdim=True)
    dx = ((g - mg - xhat * mgx) * inv).to(x.dtype)
    dscale = ((dyf * n).sum(dim=(0, 1, 2)).to(scale.dtype)
              if scale is not None else None)
    dbias = (dyf.sum(dim=(0, 1, 2)).to(bias.dtype)
             if bias is not None else None)
    return dx, dscale, dbias


def _cluster_threads(bwd: bool, out_f32: bool) -> int:
    """Threads of a cluster-path block (csrc/instance_norm.cu
    ``cluster_threads``): 512 for the forward with a bf16 output, else
    256."""
    return 256 if bwd or out_f32 else 512


def _cluster_smem(rows: int, G: int, bwd: bool, n_sums: int, k: int,
                  threads: int) -> int:
    """Dynamic shared memory of a cluster-path block, as
    csrc/instance_norm.cu ``cluster_smem`` sizes its launch (the plan
    needs it on any device to choose a split): ``rows`` pixels of G bf16
    channels of x, and of g in the backward, 16-byte aligned, then the
    fp32 tables, the per-warp sums, the ``k`` blocks' partial sums, one
    int."""
    tables = (6 if bwd else 4) + (threads // 32 + k) * n_sums
    return (-(-rows * G * 2 // 16) * 16 * (2 if bwd else 1)
            + 4 * G * tables + 16)


def _cluster_plan(B: int, n_px: int, C: int, dsz: int, n_sums: int,
                  out_f32: bool, smem: int) -> Optional[dict]:
    """The cluster path's split of an r3centered call whose dy has
    ``dsz`` bytes (0: the forward), or None where no slab fits in one
    cluster (see :func:`_plan`)."""
    threads = _cluster_threads(dsz > 0, out_f32)
    width = max(2, dsz)             # bytes of the widest input's element
    splits = {}                     # G: [(blocks a cluster, pixels a block)]
    for G in _C_GROUPS:
        for k in _C_CLUSTERS:
            rows = -(-n_px // k)
            k = -(-n_px // rows)        # no block without pixels
            if (C % G == 0 and rows <= _C_MAX_ROWS
                    and _cluster_smem(rows, G, dsz > 0, n_sums, k,
                                      threads) <= smem
                    and (k, rows) not in splits.get(G, [])):
                splits.setdefault(G, []).append((k, rows))
    if not splits:
        return None
    G = min(splits, key=lambda G: (
        abs(math.log2(G * width / _C_ROW_BYTES)), -G))
    n_slabs = B * (C // G)
    k_cap = max(1, n_px // _C_MIN_ROWS)
    k, rows = next((s for s in splits[G]
                    if n_slabs * s[0] >= _C_BLOCKS or s[0] >= k_cap),
                   splits[G][-1])
    return dict(path="cluster", grid=n_slabs * k, group=G, cluster=k,
                rows_per_block=rows, threads=threads,
                smem=_cluster_smem(rows, G, dsz > 0, n_sums, k, threads),
                slabs=n_slabs, streaming=False)


@functools.lru_cache(maxsize=None)
def _plan(B: int, n_px: int, C: int, itemsize: int, n_inputs: int,
          n_sms: int, blocks_per_sm: int, smem_per_block: int,
          parity: bool = False, dy_itemsize: Optional[int] = None,
          n_sums: int = 2, cluster_smem: int = 0,
          out_f32: bool = False) -> dict:
    """The work split the kernel follows, for ``n_inputs`` (B, n_px, C)
    tensors of ``itemsize`` bytes (1: the forward, 2: the backward's x
    and dy, dy of ``dy_itemsize`` bytes where that differs, with
    ``n_sums`` partial sums per (b, c)) on a grid of ``n_sms ·
    blocks_per_sm`` blocks with ``smem_per_block`` bytes of dynamic
    shared memory each.

    **The cluster path** (``path == "cluster"``), asked for by a
    ``cluster_smem`` > 0 (an r3centered call on 16-byte columns; a
    cluster-path block may have ``cluster_smem`` bytes of dynamic shared
    memory on the card; ``out_f32``: a forward at an affine call site,
    whose blocks have 256 threads, not 512): one cluster per slab of
    ``group`` channels (16 to 128, a power of two), ``cluster`` blocks
    of ``rows_per_block`` pixels each (at most 2048: beyond that, at the
    main paths' 160×240 forwards, the grid path measured faster on the
    H100), everything on chip at once.  The slab is, among those that
    fit in a cluster of at most 8 blocks (the portable sizes), the one
    whose rows of the widest input (x, or the backward's float32 dy)
    come nearest 64 bytes, wider on a tie;
    its cluster the smallest that spreads the call over 96 blocks or
    that leaves a block 200 pixels, else the largest.  (These three
    numbers are the H100's: the rule that came nearest the fastest
    split at each of the main paths' shapes, of every split
    ``scripts/norm_r3_h100.py --sweep`` timed.)  Where no slab fits in
    one cluster it returns the grid path.

    **The grid path** (``path == "grid"``):

    The work unit is a slab: one batch element and ``group`` channels (a
    divisor of C), slab s being b = s // (C / group) and channels from
    (s % (C / group)) · group.  ``slabs_per_chunk`` slabs at a time are
    cut into ``parts`` ranges of ``rows_per_part`` pixels, one range per
    block (block k: slab k // parts of the chunk, range k % parts), and
    ``n_chunks`` chunks cover every slab.  A block keeps up to
    ``rows_cap`` pixels of its inputs in shared memory beside its
    per-channel tables; ``streaming`` marks a call whose range exceeds
    that, where the rest is read from device memory again.

    After each chunk's barrier the partial rows of a slab are reduced by
    every block of the slab on its own, from L2, where one thread adds
    at most ``_BLOCK_SUMS_DEPTH`` of them; else (``grid_reduce``) once,
    a warp per (b, c) across the grid, behind a second barrier.

    The group is the one that needs the fewest chunks, the widest among
    those: C where a whole batch element fits, else a narrower slab with
    pixel runs of at least 64 bytes (32 where only those avoid
    streaming).  The parity norm keeps group = C, so that the four
    parity groups of a channel sit in one slab."""
    dsz = itemsize if dy_itemsize is None else dy_itemsize
    if cluster_smem > 0:
        p = _cluster_plan(B, n_px, C, 0 if n_inputs == 1 else dsz, n_sums,
                          out_f32, cluster_smem)
        if p is not None:
            return p
    grid = n_sms * blocks_per_sm
    n_tables = (_FWD_TABLES if n_inputs == 1
                else _BWD_TABLES + n_sums - 2)
    row_bytes = itemsize if n_inputs == 1 else itemsize + dsz
    # the tables start 16-byte aligned after the rows; a dy of another
    # size starts at the next multiple of its size after x's rows
    pad = 16 + (dsz if dsz != itemsize else 0)

    def plan(G):
        rows_cap = ((smem_per_block - n_tables * G * 4 - pad)
                    // (G * row_bytes))
        if rows_cap < 1:
            return None
        n_slabs = B * (C // G)

        def split(spc):
            parts = min(grid // spc, n_px)
            rows = -(-n_px // parts)
            return -(-n_px // rows), rows

        spc = next((k for k in range(min(n_slabs, grid), 0, -1)
                    if split(k)[1] <= rows_cap), 1)
        n_chunks = -(-n_slabs // spc)
        spc = -(-n_slabs // n_chunks)       # the same chunk count, balanced
        parts, rows = split(spc)
        n = n_sums * G                      # sums per slab
        depth = -(-parts // max(1, _THREADS // n)) * -(-n // _THREADS)
        return dict(path="grid", grid=grid, group=G, slabs_per_chunk=spc,
                    n_chunks=n_chunks, parts=parts, rows_per_part=rows,
                    rows_cap=rows_cap, streaming=rows > rows_cap,
                    grid_reduce=depth > _BLOCK_SUMS_DEPTH)

    groups = [C] if parity else [
        G for G in range(C, 0, -1)
        if C % G == 0 and (G == C or (G * itemsize % 16 == 0
                                      and G * itemsize >= 32))]
    plans = [p for p in map(plan, groups) if p is not None]
    if not plans:
        raise ValueError(f"instance norm with C = {C} does not fit in "
                         f"{smem_per_block} bytes of shared memory")
    wide = [p for p in plans
            if p["group"] == C or p["group"] * itemsize >= 64]
    if all(p["streaming"] for p in wide):
        wide = plans
    return min(wide, key=lambda p: (p["streaming"], p["n_chunks"],
                                    -p["group"]))


def _scratch_floats(B: int, C: int, parts: int, parity: bool,
                    n_sums: int = 2) -> int:
    """fp32 scratch of one call: the partial sums (B, parts, n_sums, C),
    the per-(B, C) sums (B, n_sums, C) and, for parity, the shifts
    (B, C / 4)."""
    return (B * parts * n_sums * C + B * n_sums * C
            + (B * C // 4 if parity else 0))


class _Config(ctypes.Structure):
    """A call's scalars (csrc/instance_norm.cu ``struct Config``), packed
    once per shape, so a launch passes eight arguments through ctypes."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "width", "B", "n_px", "C", "G", "is_bf16", "vec", "leaky", "grid",
        "parts", "rows_per_part", "rows_cap", "slabs_per_chunk",
        "n_chunks", "grid_reduce", "r3", "out_f32", "n_sums",
        "dy_f32", "cluster")] + [
            ("slope", ctypes.c_float), ("eps", ctypes.c_float)]


_lib: Optional[ctypes.CDLL] = None
_devices: Dict[int, Tuple[int, int, int, int]] = {}
_configs: Dict[tuple, Tuple[_Config, int, int]] = {}
_work: Dict[Tuple[int, int], torch.Tensor] = {}


def _library() -> ctypes.CDLL:
    """The compiled kernels, loaded and bound once."""
    global _lib
    if _lib is None:
        lib = _build.load("instance_norm")
        ptr, cfg = ctypes.c_void_p, ctypes.POINTER(_Config)
        lib.rl_norm_device.restype = ctypes.c_int
        lib.rl_norm_device.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
        lib.rl_instance_norm.restype = ctypes.c_int
        lib.rl_instance_norm.argtypes = [ptr] * 6 + [cfg, ptr]
        lib.rl_instance_norm_bwd.restype = ctypes.c_int
        lib.rl_instance_norm_bwd.argtypes = [ptr] * 9 + [cfg, ptr]
        _lib = lib
    return _lib


def _device(index: int) -> Tuple[int, int, int, int]:
    """(SMs, blocks per SM, shared memory per block; the cluster path's
    shared memory per block) of a card, queried once:
    ``rl_norm_device`` also raises the kernels' shared-memory limits,
    which every launch on that card needs."""
    geo = _devices.get(index)
    if geo is None:
        vals = [ctypes.c_int() for _ in range(4)]
        with torch.cuda.device(index):
            err = _library().rl_norm_device(*vals)
        if err != 0 or vals[1].value < 1:
            raise RuntimeError(f"rl_norm_device failed: CUDA error {err}, "
                               f"{vals[1].value} blocks per SM")
        geo = _devices[index] = tuple(v.value for v in vals)
    return geo


def _pack(p: dict, B: int, n_px: int, C: int, is_bf16: bool, vec: bool,
          width: int, slope, eps: float, r3: bool, out_f32: bool,
          dy_f32: bool) -> _Config:
    """The ``_Config`` of plan ``p``."""
    n_sums = 4 if dy_f32 else 2
    common = dict(width=width, B=B, n_px=n_px, C=C, G=p["group"],
                  is_bf16=int(is_bf16), leaky=int(slope is not None),
                  grid=p["grid"], r3=int(r3), out_f32=int(out_f32),
                  n_sums=n_sums, dy_f32=int(dy_f32),
                  slope=float(slope or 0.0), eps=float(eps))
    if p["path"] == "cluster":
        rows = p["rows_per_block"]
        return _Config(vec=1, parts=p["cluster"], rows_per_part=rows,
                       rows_cap=rows, slabs_per_chunk=p["slabs"],
                       n_chunks=1, grid_reduce=0, cluster=p["cluster"],
                       **common)
    return _Config(vec=int(vec and p["group"] * (2 if is_bf16 else 4) % 16
                           == 0),
                   parts=p["parts"], rows_per_part=p["rows_per_part"],
                   rows_cap=p["rows_cap"],
                   slabs_per_chunk=p["slabs_per_chunk"],
                   n_chunks=p["n_chunks"],
                   grid_reduce=int(p["grid_reduce"]), cluster=0,
                   **common)


def _config(x: torch.Tensor, n_inputs: int, width: int, slope, eps: float,
            vec: bool, r3: bool = False, out_f32: bool = False,
            dy_f32: bool = False) -> Tuple[_Config, int, int]:
    """The packed scalars of a call on ``x``, its scratch size in floats
    (the grid path's partial sums, fresh each call) and its workspace
    size in floats (the cluster path's backward at an affine call site:
    the dgamma/dbeta table, kept per device and stream), made once per
    (shape, dtype, device, options).  ``dy_f32``: the r3centered
    backward at an affine call site (a float32 dy, four sums per (b,
    c)); ``r3`` with ``vec`` may take the cluster path."""
    key = (x.shape, x.dtype, x.device.index, n_inputs, width, slope, eps,
           vec, r3, out_f32, dy_f32)
    hit = _configs.get(key)
    if hit is None:
        B, H, W, C = x.shape
        isz = x.element_size()
        n_sums = 4 if dy_f32 else 2
        n_sms, bps, smem, csmem = _device(x.device.index)
        p = _plan(B, H * W, C, isz, n_inputs, n_sms, bps, smem,
                  parity=width > 0, dy_itemsize=4 if dy_f32 else None,
                  n_sums=n_sums, cluster_smem=csmem if r3 and vec else 0,
                  out_f32=out_f32)
        cfg = _pack(p, B, H * W, C, x.dtype == torch.bfloat16, vec, width,
                    slope, eps, r3, out_f32, dy_f32)
        if p["path"] == "cluster":
            hit = (cfg, 0, 4 + B * 2 * C if dy_f32 else 0)
        else:
            hit = (cfg, _scratch_floats(B, C, p["parts"], width > 0,
                                        n_sums), 0)
        _configs[key] = hit
    return hit


def _workspace(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The cluster path's workspace on ``stream``: an int count (0
    between launches: the kernel that raises it to the slab count resets
    it) and the dgamma/dbeta table.  One per device and stream, so two
    streams never share a count; made once, larger when a call needs
    more."""
    key = (device.index, stream)
    w = _work.get(key)
    if w is None or w.numel() < n:
        w = _work[key] = torch.zeros(max(n, 1 << 14), dtype=torch.float32,
                                     device=device)
    return w


def batch_order_sums(table: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dβ, dγ) from the cluster path's (B, 2, C) table of per-slab sums
    (dz, dz·n): the slabs added over b in batch order, as the last slab
    of a call adds them (csrc/instance_norm.cu ``cluster_bwd``, its
    tail), whichever slab finishes last."""
    dbeta, dgamma = table[0, 0].clone(), table[0, 1].clone()
    for b in range(1, table.shape[0]):
        dbeta = dbeta + table[b, 0]
        dgamma = dgamma + table[b, 1]
    return dbeta, dgamma


def _stream(index: int) -> int:
    """The raw handle of the current stream on card ``index``."""
    return torch._C._cuda_getCurrentRawStream(index)


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
                       parity: bool = False,
                       r3centered: bool = False) -> torch.Tensor:
    """Launch ``rl_instance_norm`` on the current stream.  With
    ``stats`` (a contiguous (B, C, 3) float32 CUDA tensor) the kernel
    also writes the residuals ``s, m1, inv`` that the backward reads
    (``s = 0`` in the r3centered mode).
    ``parity`` takes the parity shift and reduction (counted in
    ``instance_norm_cuda.parity_launches``); ``r3centered`` the bf16
    contract of ``layers.instance_norm`` (a bf16 x; float32 output with
    affine; counted in ``.r3_launches``); the shifted standard norm is
    counted in ``.launches``."""
    _check_input(x, "instance_norm_cuda")
    _check_affine(x, scale, bias)
    B, H, W, C = x.shape
    if parity and (C % 4 or stats is not None):
        raise ValueError("the parity norm needs C divisible by 4 and "
                         "writes no residuals")
    if r3centered and (parity or x.dtype != torch.bfloat16):
        raise ValueError("the r3centered norm takes a bfloat16 x in the "
                         "standard layout")
    if stats is not None and (stats.shape != (B, C, 3)
                              or stats.dtype != torch.float32
                              or stats.device != x.device
                              or not stats.is_contiguous()):
        raise ValueError(f"stats must be contiguous float32 ({B}, {C}, 3)")
    out_f32 = r3centered and scale is not None
    cfg, n_scratch, _ = _config(x, 1, W if parity else 0, slope, eps,
                                x.data_ptr() % 16 == 0, r3centered, out_f32)
    out = torch.empty(x.shape, device=x.device,
                      dtype=torch.float32 if out_f32 else x.dtype)
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=x.device)
               if n_scratch else None)     # the grid path's partial sums
    err = _library().rl_instance_norm(
        x.data_ptr(), out.data_ptr(), _ptr(scale), _ptr(bias), _ptr(stats),
        _ptr(scratch), ctypes.byref(cfg), _stream(x.device.index))
    if err != 0:
        raise RuntimeError(f"rl_instance_norm launch failed: CUDA error {err}")
    if parity:
        instance_norm_cuda.parity_launches += 1
    elif r3centered:
        instance_norm_cuda.r3_launches += 1
    else:
        instance_norm_cuda.launches += 1
    return out


# kernel launches since the last reset: shifted, parity and r3centered
instance_norm_cuda.launches = 0
instance_norm_cuda.parity_launches = 0
instance_norm_cuda.r3_launches = 0


def instance_norm_bwd_cuda(x: torch.Tensor, dy: torch.Tensor,
                           stats: torch.Tensor,
                           scale: Optional[torch.Tensor] = None,
                           bias: Optional[torch.Tensor] = None,
                           slope: Optional[float] = None,
                           r3centered: bool = False
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                      Optional[torch.Tensor]]:
    """Launch ``rl_instance_norm_bwd`` on the current stream: (dx, dγ,
    dβ) as :func:`instance_norm_bwd_plain` returns them.  ``r3centered``
    (a bf16 x; dy float32 with affine, bf16 without, the dtype of the
    forward's output) is counted in ``instance_norm_bwd_cuda.r3_launches``,
    the shifted backward in ``.launches``."""
    _check_input(x, "instance_norm_bwd_cuda")
    _check_affine(x, scale, bias)
    B, H, W, C = x.shape
    if r3centered and x.dtype != torch.bfloat16:
        raise ValueError("the r3centered backward takes a bfloat16 x")
    dy_f32 = r3centered and scale is not None
    dy_dtype = torch.float32 if dy_f32 else x.dtype
    if (dy.shape != x.shape or dy.dtype != dy_dtype or dy.device != x.device
            or not dy.is_contiguous()):
        raise ValueError(f"dy must be contiguous {dy_dtype}, with x's "
                         "shape")
    if (stats.shape != (B, C, 3) or stats.dtype != torch.float32
            or stats.device != x.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be contiguous float32 ({B}, {C}, 3)")
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    cfg, n_scratch, n_work = _config(x, 2, 0, slope, 0.0, aligned,
                                     r3centered, dy_f32=dy_f32)
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale) if scale is not None else None
    dbias = torch.empty_like(bias) if bias is not None else None
    stream = _stream(x.device.index)
    if n_scratch:       # the grid path's partial sums
        scratch = torch.empty(n_scratch, dtype=torch.float32,
                              device=x.device)
    else:               # the cluster path's dgamma/dbeta table, or none
        scratch = _workspace(x.device, stream, n_work) if n_work else None
    err = _library().rl_instance_norm_bwd(
        x.data_ptr(), dy.data_ptr(), stats.data_ptr(), _ptr(scale),
        _ptr(bias), dx.data_ptr(), _ptr(dscale), _ptr(dbias), _ptr(scratch),
        ctypes.byref(cfg), stream)
    if err != 0:
        raise RuntimeError(
            f"rl_instance_norm_bwd launch failed: CUDA error {err}")
    if r3centered:
        instance_norm_bwd_cuda.r3_launches += 1
    else:
        instance_norm_bwd_cuda.launches += 1
    return dx, dscale, dbias


# kernel launches since the last reset: shifted and r3centered
instance_norm_bwd_cuda.launches = 0
instance_norm_bwd_cuda.r3_launches = 0


class InstanceNormFunction(torch.autograd.Function):
    """Instance norm with its hand-written backward: the forward saves x
    and the (B, C, 3) residuals, the residual set of ``_in_fwd``.  A
    bf16 x takes the r3centered contract, forward and backward.  CUDA
    tensors run K2 and K2b, CPU tensors the twins."""

    @staticmethod
    def forward(ctx, x, scale, bias, slope, eps):
        r3 = x.dtype == torch.bfloat16
        if x.is_cuda:
            stats = torch.empty((x.shape[0], x.shape[-1], 3),
                                dtype=torch.float32, device=x.device)
            out = instance_norm_cuda(x, scale, bias, slope, eps, stats,
                                     r3centered=r3)
        else:
            plain = _plain_r3_forward if r3 else _plain_forward
            out, stats = plain(x, scale, bias, slope, eps)
        ctx.save_for_backward(x, stats, scale, bias)
        ctx.slope, ctx.r3 = slope, r3
        return out

    @staticmethod
    def backward(ctx, dy):
        x, stats, scale, bias = ctx.saved_tensors
        bwd = instance_norm_bwd_cuda if x.is_cuda else instance_norm_bwd_plain
        dx, dscale, dbias = bwd(x, dy.contiguous(), stats, scale, bias,
                                ctx.slope, ctx.r3)
        return dx, dscale, dbias, None, None


@torch.library.custom_op("renderloom::instance_norm", mutates_args=())
def instance_norm_op(x: torch.Tensor, scale: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], slope: Optional[float],
                     eps: float, parity: bool, r3centered: bool
                     ) -> torch.Tensor:
    """K2 as the registered operator ``renderloom::instance_norm``, what a
    ``torch.export`` program of the port calls: :func:`instance_norm_cuda`
    for a CUDA tensor (counted there), :func:`instance_norm_plain` for a
    CPU tensor.  Inference only: no autograd is registered."""
    if x.is_cuda:
        return instance_norm_cuda(x, scale, bias, slope, eps, parity=parity,
                                  r3centered=r3centered)
    return instance_norm_plain(x, scale, bias, slope, eps, parity,
                               r3centered)


@instance_norm_op.register_fake
def _instance_norm_fake(x, scale, bias, slope, eps, parity, r3centered):
    # r3centered returns float32 n·γ + β at an affine call site
    f32 = r3centered and scale is not None
    return x.new_empty(x.shape, dtype=torch.float32 if f32 else x.dtype)


def instance_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  slope: Optional[float] = None,
                  eps: float = EPS, parity: bool = False) -> torch.Tensor:
    """Instance norm of NHWC ``x``: the CUDA kernels for a CUDA tensor,
    the plain twins for a CPU tensor.  A bf16 ``x`` in the standard
    layout takes the r3centered contract (float32 output with affine),
    as the JAX ``layers.instance_norm`` dispatches on the dtype.  When
    autograd records, the call goes through :class:`InstanceNormFunction`,
    so the gradient reaches x, γ and β on either device.  ``parity``: the
    space-to-depth norm, inference only: a call autograd would record
    raises."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    r3 = x.dtype == torch.bfloat16 and not parity
    wants_grad = torch.is_grad_enabled() and (
        x.requires_grad or (scale is not None and scale.requires_grad)
        or (bias is not None and bias.requires_grad))
    if wants_grad:
        if parity:
            raise RuntimeError("the parity instance norm is inference-only: "
                               "it has no backward")
        return InstanceNormFunction.apply(x, scale, bias, slope, eps)
    if _build.traced(x):
        return torch.ops.renderloom.instance_norm(x, scale, bias, slope, eps,
                                                  parity, r3)
    if x.is_cuda:
        return instance_norm_cuda(x, scale, bias, slope, eps, parity=parity,
                                  r3centered=r3)
    return instance_norm_plain(x, scale, bias, slope, eps, parity, r3)
