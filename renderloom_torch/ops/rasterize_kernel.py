"""Pose label rasterizer: per-frame tables, the CUDA kernel
``csrc/rasterize.cu`` and its plain PyTorch twin.

Replaces the TPU kernel ``renderloom/ops/rasterize_pallas.py:
rasterize_frames_fused`` (layout ``"nhwc"``, deterministic tables).  On
the H100 it is bound by the bytes of the label it writes (F·H·W·22
values); each thread computes one pixel from tables held in shared
memory, and the block stores its contiguous run of the NHWC label
through a staging tile.  See the source for the design.

The tables (:func:`build_tables`, the port of ``_build_tables``) carry
everything data-dependent, so the kernel and the twin take the same
inputs and the tests can inject the JAX-built tables:

  joints (F, 19, 4) = x_floor, y_floor, 1/(2σ²), heat_valid
  skel   (F, 18, 8) = ax, ay, bx, by, valid, r, g, b   (unfloored)
  caps   (F, 39, 7) = ax, ay, bx, by, radius, valid, part  (floored;
                      19 zero-length joint disks, then 20 limbs)

:func:`rasterize_tables` takes the twin for CPU tensors and the kernel
for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from renderloom_torch.ops import rasterize as R

J = 19
E_SKEL = R.POSE_EDGES_19.shape[0]           # 18
E_CAPS = J + R.MASK_EDGES.shape[0]          # 39
LABEL_C = 3 + J                             # 22


def build_tables(coords: torch.Tensor, conf: torch.Tensor, height: int,
                 width: int, gauss_sigma: float = 5.0, thres: float = 0.001,
                 foot_thres: float = 0.001):
    """Deterministic per-frame tables from coords (F, J, 2), conf (F, J)."""
    F, dev = coords.shape[0], coords.device
    x, y = coords[..., 0], coords[..., 1]
    inb = (x >= 0) & (y >= 0) & (x < width) & (y < height)
    heat_valid = inb & (conf > thres)
    sigma = torch.full((F, J), gauss_sigma, dtype=torch.float32, device=dev)
    joints = torch.stack([torch.floor(x), torch.floor(y),
                          1.0 / (2.0 * sigma * sigma), heat_valid.float()],
                         dim=-1)

    valid = R.valid_joints(coords, conf, height, width, thres, foot_thres)
    safe = torch.where(valid[..., None], coords, torch.zeros_like(coords))
    edges = torch.as_tensor(R.POSE_EDGES_19, device=dev)
    e_ok = valid[:, edges[:, 0]] & valid[:, edges[:, 1]]
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
    seg = torch.cat([pt[:, medges[:, 0]], pt[:, medges[:, 1]],
                     col(R.MASK_EDGE_RADII, EM), m_ok.float()[..., None],
                     torch.zeros((F, EM, 1), device=dev)], dim=-1)
    return joints, skel, torch.cat([disk, seg], dim=1)


def rasterize_tables_plain(joints, skel, caps, height: int, width: int,
                           out_dtype=torch.float32,
                           emit_masks: bool = False,
                           brush: float = R.SKELETON_BRUSH
                           ) -> Dict[str, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch, element by element."""
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
    chans = [acc / denom * 2.0 - 1.0 for acc in (racc, gacc, bacc)]
    for j in range(J):
        d2 = (xs - at(joints, j, 0)) ** 2 + (ys - at(joints, j, 1)) ** 2
        chans.append(torch.exp(-d2 * at(joints, j, 2)) * at(joints, j, 3))
    out = {"label": torch.stack(chans, dim=-1).to(out_dtype)}
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


def rasterize_tables_cuda(joints, skel, caps, height: int, width: int,
                          out_dtype=torch.float32,
                          emit_masks: bool = False,
                          brush: float = R.SKELETON_BRUSH
                          ) -> Dict[str, torch.Tensor]:
    """Launch ``rl_rasterize`` on the current stream."""
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
    from renderloom_torch.ops import _build

    fn = _build.load("rasterize").rl_rasterize
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    dev = joints.device
    label = torch.empty((F, height, width, LABEL_C), dtype=out_dtype,
                        device=dev)
    out = {"label": label}
    if emit_masks:
        out["mask"] = torch.empty((F, height, width), dtype=torch.float32,
                                  device=dev)
        out["part_mask"] = torch.empty_like(out["mask"])
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda k: out[k].data_ptr() if emit_masks else None
    err = fn(joints.data_ptr(), skel.data_ptr(), caps.data_ptr(),
             label.data_ptr(), ptr("mask"), ptr("part_mask"), F, height,
             width, int(out_dtype == torch.bfloat16), float(brush), stream)
    if err != 0:
        raise RuntimeError(f"rl_rasterize launch failed: CUDA error {err}")
    rasterize_tables_cuda.launches += 1
    return out


rasterize_tables_cuda.launches = 0   # kernel launches since the last reset


def rasterize_tables(joints, skel, caps, height: int, width: int,
                     out_dtype=torch.float32, emit_masks: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """NHWC label (F, H, W, 22) in ``out_dtype`` plus, with
    ``emit_masks``, the human and part masks (F, H, W) f32 0/1: the CUDA
    kernel for CUDA tables, the plain twin for CPU tables."""
    if joints.is_cuda:
        return rasterize_tables_cuda(joints, skel, caps, height, width,
                                     out_dtype, emit_masks)
    if joints.device.type != "cpu":
        raise ValueError(f"unsupported device {joints.device}")
    return rasterize_tables_plain(joints, skel, caps, height, width,
                                  out_dtype, emit_masks)


def rasterize_frames_fused(coords: torch.Tensor, conf: torch.Tensor,
                           height: int, width: int,
                           gauss_sigma: float = 5.0, thres: float = 0.001,
                           foot_thres: float = 0.001,
                           out_dtype=torch.float32,
                           emit_masks: bool = False
                           ) -> Dict[str, torch.Tensor]:
    """coords (F, J, 2), conf (F, J) → the NHWC label stack of F frames
    (``layout="nhwc"`` of the JAX function, deterministic path)."""
    tables = build_tables(coords.float(), conf.float(), height, width,
                          gauss_sigma, thres, foot_thres)
    return rasterize_tables(*(t.contiguous() for t in tables), height,
                            width, out_dtype, emit_masks)
