"""The pose label rasterizer in plain PyTorch: per-frame tables
(joints, limbs, mask capsules) and the label, element by element over
full frames.  Frozen copy of the port's ``ops/rasterize_kernel.py``
without its kernel (no per-tile culling, no layouts but the ones the
reference serves and trains in).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from rlbench.reference.ops import rasterize as R

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


def rasterize_frames_fused(coords: torch.Tensor, conf: torch.Tensor,
                           height: int, width: int,
                           gauss_sigma: float = 5.0, thres: float = 0.001,
                           foot_thres: float = 0.001,
                           out_dtype=torch.float32,
                           emit_masks: bool = False,
                           draws: Optional[Dict[str, torch.Tensor]] = None,
                           layout: str = "nhwc",
                           brush: float = R.SKELETON_BRUSH
                           ) -> Dict[str, torch.Tensor]:
    """coords (F, J, 2), conf (F, J) → the label stack of F frames in
    ``layout`` (the JAX function's ``layout``), limbs of radius
    ``brush``; ``draws`` (from :func:`draw_train_tables`) makes it the
    train path."""
    tables = build_tables(coords.float(), conf.float(), height, width,
                          gauss_sigma, thres, foot_thres, draws)
    return rasterize_tables_plain(*(t.contiguous() for t in tables),
                                  height, width, out_dtype, emit_masks,
                                  brush, layout)
