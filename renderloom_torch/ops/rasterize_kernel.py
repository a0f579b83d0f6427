"""Pose label rasterizer: per-frame tables, the CUDA kernel
``csrc/rasterize.cu`` and its plain PyTorch twin.

Replaces the TPU kernel ``renderloom/ops/rasterize_pallas.py:
rasterize_frames_fused`` (layouts ``"nhwc"``, ``"packed"`` and
``"cfhw"``, deterministic and train-mode tables).  Evaluating every
term at every pixel is bound by arithmetic on the H100, not by the
label's bytes: the first design took 0.29 ms for the f32 label of 29
frames of 320×480 and 0.30 ms for the packed bf16 label of half the
bytes, and twice as long with the 39 mask capsules.  So each block
takes one pixel tile, keeps only the terms that can reach it
(:func:`tile_terms` is the rule), evaluates each pixel over those, and
stores the tile's rows of the NHWC (or packed) label from a shared
staging tile with 16-byte stores, or each channel plane directly
(cfhw).  See the source for the design.

Layouts, as the JAX wrapper gives them (:278-293):

  nhwc    label (F, H, W, 22) = [skeleton·2 − 1, heatmaps];
  packed  label (F, H/2, W/2, 88), channel (row_parity·2 + col_parity)·22
          + c, exactly ``space_to_depth`` of the nhwc label (H, W even);
          the masks stay full-resolution;
  cfhw    heatmaps (F, 19, H, W) and skeleton (F, 3, H, W) in [0, 1]
          (not scaled), masks always (the JAX wrapper asserts it).

The tables (:func:`build_tables`, the port of ``_build_tables``) carry
everything data-dependent, the training draws included (per-joint σ,
joint and limb keep flags, part limbs; :func:`draw_train_tables`), so
the kernel and the twin take the same inputs and the tests can inject
the JAX-drawn values:

  joints (F, 19, 4) = x_floor, y_floor, 1/(2σ²), heat_valid
  skel   (F, 18, 8) = ax, ay, bx, by, valid, r, g, b   (unfloored)
  caps   (F, 39, 7) = ax, ay, bx, by, radius, valid, part  (floored;
                      19 zero-length joint disks, then 20 limbs)

:func:`rasterize_tables` takes the twin for CPU tensors and the kernel
for CUDA tensors; it never falls back from one to the other.  Under
``torch.export`` it calls the registered operator
``renderloom::rasterize`` (:func:`rasterize_op`, with a fake that gives
every output's shape and dtype), so that an exported program carries K1
and a loaded one launches it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from renderloom_torch.ops import _build
from renderloom_torch.ops import rasterize as R

J = 19
E_SKEL = R.POSE_EDGES_19.shape[0]           # 18
E_CAPS = J + R.MASK_EDGES.shape[0]          # 39
LABEL_C = 3 + J                             # 22
LAYOUTS = ("nhwc", "packed", "cfhw")        # csrc/rasterize.cu's Layout
# full-resolution (rows, cols) of the kernel's pixel tile per layout
TILES = {"nhwc": (16, 16), "packed": (16, 16), "cfhw": (8, 32)}
# the cull rule's constants (csrc/rasterize.cu: kFar, kHeatCut, kMargin)
CULL_FAR, CULL_HEAT, CULL_MARGIN = 65536.0, 110.0, 1.0


def draw_train_tables(generator: torch.Generator, F: int,
                      gauss_sigma: float = 5.0,
                      random_drop_prob: float = 0.02,
                      random_blur_rate: float = 0.06
                      ) -> Dict[str, torch.Tensor]:
    """The train-mode draws of ``rasterize_frames_fused`` (:313-335) for
    F frames, from ``generator`` on its device: σ (F, 19) uniform over
    the integers ``[g − 1, g + 1)``, joint keep (F, 19) and limb keep
    (F, 18) where a uniform exceeds ``random_drop_prob``, part limbs
    (F, 20) where a uniform is below ``random_blur_rate``."""
    dev = generator.device
    u = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    g = int(gauss_sigma)
    return {"sigma": torch.randint(g - 1, g + 1, (F, J), generator=generator,
                                   device=dev).float(),
            "keep_j": u(F, J) > random_drop_prob,
            "keep_e": u(F, E_SKEL) > random_drop_prob,
            "part": u(F, E_CAPS - J) < random_blur_rate}


def build_tables(coords: torch.Tensor, conf: torch.Tensor, height: int,
                 width: int, gauss_sigma: float = 5.0, thres: float = 0.001,
                 foot_thres: float = 0.001,
                 draws: Optional[Dict[str, torch.Tensor]] = None):
    """Per-frame tables from coords (F, J, 2), conf (F, J).  ``draws`` are
    the train draws as :func:`draw_train_tables` gives them, all four of
    σ (F, 19), keep_j (F, 19), keep_e (F, 18) and part (F, 20); without
    them the tables are the deterministic ones: σ = ``gauss_sigma``,
    everything kept, no part limb."""
    F, dev = coords.shape[0], coords.device
    x, y = coords[..., 0], coords[..., 1]
    inb = (x >= 0) & (y >= 0) & (x < width) & (y < height)
    heat_valid = inb & (conf > thres)
    if draws is None:
        sigma = torch.full((F, J), gauss_sigma, dtype=torch.float32,
                           device=dev)
        keep_e, part = None, None
    else:
        if draws.keys() != {"sigma", "keep_j", "keep_e", "part"}:
            raise KeyError(f"draws must hold sigma, keep_j, keep_e and "
                           f"part, got {sorted(draws)}")
        sigma, keep_e, part = draws["sigma"], draws["keep_e"], draws["part"]
        heat_valid = heat_valid & draws["keep_j"]
    joints = torch.stack([torch.floor(x), torch.floor(y),
                          1.0 / (2.0 * sigma * sigma), heat_valid.float()],
                         dim=-1)

    valid = R.valid_joints(coords, conf, height, width, thres, foot_thres)
    safe = torch.where(valid[..., None], coords, torch.zeros_like(coords))
    edges = torch.as_tensor(R.POSE_EDGES_19, device=dev)
    e_ok = valid[:, edges[:, 0]] & valid[:, edges[:, 1]]
    if keep_e is not None:
        e_ok = e_ok & keep_e
    colors = (torch.as_tensor(R.POSE_COLORS_19, device=dev) / 255.0
              ).expand(F, E_SKEL, 3)
    skel = torch.cat([safe[:, edges[:, 0]], safe[:, edges[:, 1]],
                      e_ok.float()[..., None], colors], dim=-1)

    mvalid = inb & (conf > thres)
    pt = torch.stack([torch.floor(x), torch.floor(y)], dim=-1)
    col = lambda v, n: torch.as_tensor(v, device=dev).expand(F, n)[..., None]
    disk = torch.cat([pt, pt, col(R.MASK_JOINT_RADII, J),
                      mvalid.float()[..., None],
                      torch.zeros((F, J, 1), device=dev)], dim=-1)
    medges = torch.as_tensor(R.MASK_EDGES, device=dev)
    EM = medges.shape[0]
    m_ok = mvalid[:, medges[:, 0]] & mvalid[:, medges[:, 1]]
    part_col = (part.float()[..., None] if part is not None
                else torch.zeros((F, EM, 1), device=dev))
    seg = torch.cat([pt[:, medges[:, 0]], pt[:, medges[:, 1]],
                     col(R.MASK_EDGE_RADII, EM), m_ok.float()[..., None],
                     part_col], dim=-1)
    return joints, skel, torch.cat([disk, seg], dim=1)


def _check_layout(layout: str, height: int, width: int, emit_masks: bool):
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "packed" and (height % 2 or width % 2):
        raise ValueError(f"the packed label needs an even size, got "
                         f"{height}x{width}")
    if layout == "cfhw" and not emit_masks:
        raise ValueError("cfhw is the rasterize.py-compatible form; masks "
                         "are part of it")


def rasterize_tables_plain(joints, skel, caps, height: int, width: int,
                           out_dtype=torch.float32,
                           emit_masks: bool = False,
                           brush: float = R.SKELETON_BRUSH,
                           layout: str = "nhwc"
                           ) -> Dict[str, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch, element by element."""
    _check_layout(layout, height, width, emit_masks)
    F, dev = joints.shape[0], joints.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    at = lambda tab, i, k: tab[:, i, k].reshape(F, 1, 1)

    zeros = torch.zeros((F, height, width), dtype=torch.float32, device=dev)
    racc, gacc, bacc, cnt = zeros, zeros, zeros, zeros
    for e in range(E_SKEL):
        ax, ay, bx, by = (at(skel, e, k) for k in range(4))
        d2 = R.segment_dist2(xs, ys, ax, ay, bx, by)
        da2 = (xs - ax) ** 2 + (ys - ay) ** 2
        db2 = (xs - bx) ** 2 + (ys - by) ** 2
        hit = ((d2 <= brush * brush) | (da2 <= (2 * brush) ** 2)
               | (db2 <= (2 * brush) ** 2))
        cover = torch.where(hit, at(skel, e, 4), zeros)
        racc = racc + cover * at(skel, e, 5)
        gacc = gacc + cover * at(skel, e, 6)
        bacc = bacc + cover * at(skel, e, 7)
        cnt = cnt + cover
    denom = torch.clamp(cnt, min=1.0)
    colors = [acc / denom for acc in (racc, gacc, bacc)]
    heat = []
    for j in range(J):
        d2 = (xs - at(joints, j, 0)) ** 2 + (ys - at(joints, j, 1)) ** 2
        heat.append(torch.exp(-d2 * at(joints, j, 2)) * at(joints, j, 3))
    if layout == "cfhw":
        out = {"heatmaps": torch.stack(heat, dim=1).to(out_dtype),
               "skeleton": torch.stack(colors, dim=1).to(out_dtype)}
    else:
        label = torch.stack([c * 2.0 - 1.0 for c in colors] + heat, dim=-1)
        if layout == "packed":
            label = label.reshape(F, height // 2, 2, width // 2, 2, LABEL_C
                                  ).permute(0, 1, 3, 2, 4, 5).reshape(
                F, height // 2, width // 2, 4 * LABEL_C)
        out = {"label": label.to(out_dtype)}
    if emit_masks:
        macc, pacc = zeros, zeros
        for c in range(E_CAPS):
            d2 = R.segment_dist2(xs, ys, *(at(caps, c, k) for k in range(4)))
            radius = at(caps, c, 4)
            cover = torch.where(d2 <= radius * radius, at(caps, c, 5), zeros)
            macc = torch.maximum(macc, cover)
            pacc = torch.maximum(pacc, cover * at(caps, c, 6))
        out["mask"], out["part_mask"] = macc, pacc
    return out


def tile_terms(joints, skel, caps, height: int, width: int, tile=None,
               emit_masks: bool = False, layout: str = "nhwc",
               brush: float = R.SKELETON_BRUSH) -> Dict[str, torch.Tensor]:
    """The kernel's cull rule: which terms each pixel tile evaluates.

    Returns boolean keep masks ``joints`` (F, ty, tx, 19), ``skel``
    (F, ty, tx, 18) and, with ``emit_masks``, ``caps`` (F, ty, tx, 39),
    over the ty × tx tiles of ``tile`` = (rows, cols) full-resolution
    pixels (default: the kernel's tile for ``layout``, :data:`TILES`),
    the last row and column of tiles reaching past the image.  A term is
    skipped only where it is +0 at every pixel of the tile (a gaussian:
    exactly 0·valid), so evaluating the kept terms alone, in table
    order, gives the plain version's bits; each condition is false for
    NaN.  The same float32 operations as ``csrc/rasterize.cu``:

    - gaussian: x, y within ±65536, inv and valid finite, inv ≥ 0, and
      valid = 0 or (least squared distance of the tile) · inv > 110
      (exp rounds to +0 past 103.97);
    - skeleton capsule: finite colours, and valid = 0 or its endpoints
      within ±65536 and the tile centre farther from the segment than
      2·brush + half the tile's diagonal + 1 px;
    - mask capsule: part flag finite and ≥ 0, and valid = +0 or its
      endpoints bounded and the tile centre farther than its radius +
      half-diagonal + 1 px.
    """
    th, tw = TILES[layout] if tile is None else tile
    dev, f32 = joints.device, torch.float32
    ny, nx = -(-height // th), -(-width // tw)
    y0 = (torch.arange(ny, device=dev) * th).to(f32).reshape(1, ny, 1, 1)
    x0 = (torch.arange(nx, device=dev) * tw).to(f32).reshape(1, 1, nx, 1)
    hy, hx = 0.5 * (th - 1), 0.5 * (tw - 1)
    hd = torch.sqrt(torch.tensor(hy * hy + hx * hx, dtype=f32, device=dev))
    cy, cx = y0 + hy, x0 + hx
    col = lambda tab, k: tab[..., k][:, None, None, :]
    near = lambda *v: torch.stack([a.abs() <= CULL_FAR for a in v]).all(0)

    def centre_d2(tab):
        ax, ay, bx, by = (col(tab, k) for k in range(4))
        return R.segment_dist2(cx, cy, ax, ay, bx, by), near(ax, ay, bx, by)

    x, y, inv, v = (col(joints, k) for k in range(4))
    dxm = torch.clamp(torch.maximum(x0 - x, x - (x0 + (tw - 1))), min=0.0)
    dym = torch.clamp(torch.maximum(y0 - y, y - (y0 + (th - 1))), min=0.0)
    skip = (near(x, y) & torch.isfinite(inv) & torch.isfinite(v)
            & (inv >= 0) & ((v == 0)
                            | ((dxm * dxm + dym * dym) * inv > CULL_HEAT)))
    out = {"joints": ~skip}

    d2c, bnd = centre_d2(skel)
    lim = (torch.tensor(abs(2.0 * brush), dtype=f32, device=dev) + hd
           ) + CULL_MARGIN
    skip = (torch.isfinite(skel[..., 5:8]).all(-1)[:, None, None, :]
            & ((col(skel, 4) == 0) | (bnd & (d2c > lim * lim))))
    out["skel"] = ~skip

    if emit_masks:
        d2c, bnd = centre_d2(caps)
        lim = (col(caps, 4).abs() + hd) + CULL_MARGIN
        valid, part = col(caps, 5), col(caps, 6)
        skip = (torch.isfinite(part) & (part >= 0)
                & (((valid == 0) & ~torch.signbit(valid))
                   | (bnd & (d2c > lim * lim))))
        out["caps"] = ~skip
    return out


def rasterize_tables_cuda(joints, skel, caps, height: int, width: int,
                          out_dtype=torch.float32,
                          emit_masks: bool = False,
                          brush: float = R.SKELETON_BRUSH,
                          layout: str = "nhwc"
                          ) -> Dict[str, torch.Tensor]:
    """Launch ``rl_rasterize`` on the current stream; counted by layout in
    ``rasterize_tables_cuda.layout_launches``.  Each block evaluates the
    terms that :func:`tile_terms` keeps for its tile."""
    _check_layout(layout, height, width, emit_masks)
    F = joints.shape[0]
    for name, t, shape in (("joints", joints, (F, J, 4)),
                           ("skel", skel, (F, E_SKEL, 8)),
                           ("caps", caps, (F, E_CAPS, 7))):
        if (not t.is_cuda or t.device != joints.device
                or t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             f"tensor of shape {shape}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"label dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    if not (0 < F <= 65535 and height > 0 and width > 0
            and height * width < 2 ** 31):
        raise ValueError(f"unsupported raster size F={F} {height}x{width}")
    fn = _build.load("rasterize").rl_rasterize
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    dev = joints.device
    empty = lambda *shape, dtype=out_dtype: torch.empty(shape, dtype=dtype,
                                                        device=dev)
    if layout == "cfhw":
        out = {"heatmaps": empty(F, J, height, width),
               "skeleton": empty(F, 3, height, width)}
        first, second = out["heatmaps"], out["skeleton"].data_ptr()
    else:
        shape = ((F, height, width, LABEL_C) if layout == "nhwc" else
                 (F, height // 2, width // 2, 4 * LABEL_C))
        out = {"label": empty(*shape)}
        first, second = out["label"], None
    if emit_masks:
        out["mask"] = empty(F, height, width, dtype=torch.float32)
        out["part_mask"] = torch.empty_like(out["mask"])
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda k: out[k].data_ptr() if emit_masks else None
    err = fn(joints.data_ptr(), skel.data_ptr(), caps.data_ptr(),
             first.data_ptr(), second, ptr("mask"), ptr("part_mask"), F,
             height, width, int(out_dtype == torch.bfloat16),
             LAYOUTS.index(layout), float(brush), stream)
    if err != 0:
        raise RuntimeError(f"rl_rasterize launch failed: CUDA error {err}")
    rasterize_tables_cuda.layout_launches[layout] += 1
    return out


# kernel launches since the last reset, by layout
rasterize_tables_cuda.layout_launches = dict.fromkeys(LAYOUTS, 0)


def _as_dict(outs, layout: str, emit_masks: bool) -> Dict[str, torch.Tensor]:
    """The operator's fixed tuple (first, second, mask, part_mask) as the
    wrappers' dict; unused slots are empty tensors."""
    first, second, mask, part_mask = outs
    out = ({"heatmaps": first, "skeleton": second} if layout == "cfhw"
           else {"label": first})
    if emit_masks:
        out["mask"], out["part_mask"] = mask, part_mask
    return out


@torch.library.custom_op("renderloom::rasterize", mutates_args=())
def rasterize_op(joints: torch.Tensor, skel: torch.Tensor,
                 caps: torch.Tensor, height: int, width: int,
                 out_dtype: torch.dtype, emit_masks: bool, layout: str
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """K1 as the registered operator ``renderloom::rasterize``, what a
    ``torch.export`` program of the port calls: (label, empty, mask,
    part_mask) for the nhwc and packed layouts, (heatmaps, skeleton,
    mask, part_mask) for cfhw, the masks empty without ``emit_masks``.
    :func:`rasterize_tables_cuda` for CUDA tables (counted there), the
    twin for CPU tables."""
    run = (rasterize_tables_cuda if joints.is_cuda
           else rasterize_tables_plain)
    out = run(joints, skel, caps, height, width, out_dtype, emit_masks,
              layout=layout)
    empty = lambda dtype: joints.new_empty((0,), dtype=dtype)
    masks = ((out["mask"], out["part_mask"]) if emit_masks
             else (empty(torch.float32), empty(torch.float32)))
    if layout == "cfhw":
        return out["heatmaps"], out["skeleton"], *masks
    return out["label"], empty(out_dtype), *masks


@rasterize_op.register_fake
def _rasterize_fake(joints, skel, caps, height, width, out_dtype,
                    emit_masks, layout):
    _check_layout(layout, height, width, emit_masks)
    F = joints.shape[0]
    new = lambda *shape, dtype=out_dtype: joints.new_empty(shape,
                                                           dtype=dtype)
    if layout == "cfhw":
        first, second = new(F, J, height, width), new(F, 3, height, width)
    elif layout == "packed":
        first = new(F, height // 2, width // 2, 4 * LABEL_C)
        second = new(0)
    else:
        first, second = new(F, height, width, LABEL_C), new(0)
    n = (F, height, width) if emit_masks else (0,)
    return (first, second, new(*n, dtype=torch.float32),
            new(*n, dtype=torch.float32))


def rasterize_tables(joints, skel, caps, height: int, width: int,
                     out_dtype=torch.float32, emit_masks: bool = False,
                     layout: str = "nhwc") -> Dict[str, torch.Tensor]:
    """The label in ``layout`` and ``out_dtype`` (see the module
    docstring) plus, with ``emit_masks``, the human and part masks
    (F, H, W) f32 0/1: the CUDA kernel for CUDA tables, the plain twin
    for CPU tables.  Under ``torch.export`` (fake tables) the call goes
    through the registered operator :func:`rasterize_op`; eager calls
    skip its dispatch and reach the same kernel."""
    if _build.traced(joints):
        return _as_dict(torch.ops.renderloom.rasterize(
            joints, skel, caps, height, width, out_dtype, emit_masks,
            layout), layout, emit_masks)
    if joints.is_cuda:
        return rasterize_tables_cuda(joints, skel, caps, height, width,
                                     out_dtype, emit_masks, layout=layout)
    if joints.device.type != "cpu":
        raise ValueError(f"unsupported device {joints.device}")
    return rasterize_tables_plain(joints, skel, caps, height, width,
                                  out_dtype, emit_masks, layout=layout)


def rasterize_frames_fused(coords: torch.Tensor, conf: torch.Tensor,
                           height: int, width: int,
                           gauss_sigma: float = 5.0, thres: float = 0.001,
                           foot_thres: float = 0.001,
                           out_dtype=torch.float32,
                           emit_masks: bool = False,
                           draws: Optional[Dict[str, torch.Tensor]] = None,
                           layout: str = "nhwc"
                           ) -> Dict[str, torch.Tensor]:
    """coords (F, J, 2), conf (F, J) → the label stack of F frames in
    ``layout`` (the JAX function's ``layout``); ``draws`` (from
    :func:`draw_train_tables`) makes it the train path."""
    tables = build_tables(coords.float(), conf.float(), height, width,
                          gauss_sigma, thres, foot_thres, draws)
    return rasterize_tables(*(t.contiguous() for t in tables), height,
                            width, out_dtype, emit_masks, layout)
