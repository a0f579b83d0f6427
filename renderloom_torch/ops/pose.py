"""Pose geometry: motion inference and the AMASS training-sample
synthesis.

Port of the JAX package's ``renderloom/ops/pose.py``.  A motion clip is
(..., J, D, L) — joints × coordinate dim × time — with any leading batch
dims (the JAX functions take one clip and are ``vmap``-ed; here the
batch is written out).

The synthesis (:func:`synthesize_batch`: centralize → view rotation →
projection → openpose remap → keyframe corruption → localize and
normalize → masks → linear prior) is split from its randomness:
:func:`draw_synthesis` draws every random value of a batch from an
explicit ``torch.Generator`` (the view angles, the focal and depth
jitter, :func:`random_drop`'s keyframe and joint permutations and its
noise, the decoder's unmasked indices), and the synthesis is a
deterministic function of the clips and those draws, so the tests can
feed it the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

# SMPL-H 52-joint → 17 body joints of the 19-joint openpose-like layout;
# rows 17/18 are the averaged hand clusters
SMPL_TO_OPENPOSE17 = (15, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
                      10, 11)

ROOT_2D = 8   # openpose mid-hip row
ROOT_3D = 0

# joint groups of the noise augmentation
NOISE_JOINTS = (3, 4, 6, 7, 10, 11, 13, 14, 15, 16, 17, 18)
DROP_JOINTS = (0, 3, 4, 6, 7, 10, 11, 13, 14, 15, 16, 17, 18)
RIGHT_LEG = (9, 10, 11, 16)
LEFT_LEG = (12, 13, 14, 15)


def joints_to_openpose(data: torch.Tensor) -> torch.Tensor:
    """SMPL-H (..., 52, D, L) → openpose-like (..., 19, D, L): rows 0-16
    remapped body joints, rows 17/18 the means of the right and left
    hand joint clusters."""
    body = data[..., list(SMPL_TO_OPENPOSE17), :, :]
    right_hand = data[..., 22:37, :, :].mean(dim=-3, keepdim=True)
    left_hand = data[..., 37:52, :, :].mean(dim=-3, keepdim=True)
    return torch.cat([body, right_hand, left_hand], dim=-3)


def centralize(data: torch.Tensor) -> torch.Tensor:
    """Subtract joint 0's temporal mean."""
    centers = data[..., 0, :, :].mean(dim=-1, keepdim=True)   # (..., D, 1)
    return data - centers[..., None, :, :]


def body_basis(motion3d: torch.Tensor,
               angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., 3, 3) body-aligned basis of (..., 52, 3, L) joints,
    optionally view-rotated by ``angles`` (..., 3): a rotation about the
    basis's x axis (Rodrigues) by angle 0, then about z by angle 2.
    The reference's non-orthogonal construction is kept: horizontal axis
    from the shoulder and hip joints, z up, y = h × z, x = y × z."""
    m = motion3d
    horizontal = ((m[..., 17, :, :] - m[..., 16, :, :] + m[..., 2, :, :]
                   - m[..., 1, :, :]) / 2).mean(dim=-1)
    horizontal = horizontal / torch.linalg.vector_norm(
        horizontal, dim=-1, keepdim=True)
    local_z = torch.zeros_like(horizontal)
    local_z[..., 2] = 1.0
    local_y = torch.linalg.cross(horizontal, local_z, dim=-1)
    local_y = local_y / torch.linalg.vector_norm(local_y, dim=-1,
                                                 keepdim=True)
    local_x = torch.linalg.cross(local_y, local_z, dim=-1)
    local = torch.stack([local_x, local_y, local_z], dim=-2)
    if angles is None:
        return local
    cx, cz = torch.cos(angles[..., 0]), torch.cos(angles[..., 2])
    sx, sz = torch.sin(angles[..., 0]), torch.sin(angles[..., 2])
    x = local[..., 0, :]
    zero = torch.zeros_like(x[..., 0])
    x_cpm = torch.stack([
        torch.stack([zero, -x[..., 2], x[..., 1]], dim=-1),
        torch.stack([x[..., 2], zero, -x[..., 0]], dim=-1),
        torch.stack([-x[..., 1], x[..., 0], zero], dim=-1)], dim=-2)
    xx = x[..., :, None] * x[..., None, :]
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    mat33_x = (cx[..., None, None] * eye + sx[..., None, None] * x_cpm
               + (1.0 - cx)[..., None, None] * xx)
    one = torch.ones_like(cz)
    mat33_z = torch.stack([
        torch.stack([cz, sz, zero], dim=-1),
        torch.stack([-sz, cz, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1)], dim=-2)
    return torch.einsum("...ij,...kj,...kl->...il", local, mat33_x, mat33_z)


def rotate_motion_3d(motion3d: torch.Tensor,
                     angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The body basis applied to every joint: ``basis @ motion``."""
    basis = body_basis(motion3d, angles)
    return torch.einsum("...ij,...kjl->...kil", basis, motion3d)


def project_2d(point3d: torch.Tensor, focal: float = 4.0, depth: float = 4.0,
               border: float = 10.0, mode: str = "perspective",
               focal_jitter=0.0, depth_jitter=0.0) -> torch.Tensor:
    """Pinhole (or orthogonal) projection of (..., J, 3, L) → (..., J, 2,
    L): y is the depth axis, image y is −z, the denominator is clamped at
    ``0.1 * depth`` (the un-jittered depth), the output clipped to
    ±``border``.  The jitters are scalars or (...,) tensors."""
    d_min = 0.1 * depth
    jit = lambda j: j[..., None, None, None] if isinstance(
        j, torch.Tensor) else j
    f = focal + jit(focal_jitter)
    d = depth + jit(depth_jitter)
    xz = point3d[..., [0, 2], :]
    if mode == "orthogonal":
        point2d = xz
    else:
        denom = torch.clamp(point3d[..., 1:2, :] + d, min=d_min)
        point2d = f * xz / denom
    point2d = point2d * torch.tensor([1.0, -1.0], dtype=point2d.dtype,
                                     device=point2d.device)[:, None]
    return torch.clamp(point2d, -border, border)


def localize(motion: torch.Tensor, root_idx: int) -> torch.Tensor:
    """Root-relative joints with the root row removed and the absolute
    root trajectory appended as the last row."""
    centers = motion[..., root_idx:root_idx + 1, :, :]
    rel = motion - centers
    return torch.cat([rel[..., :root_idx, :, :], rel[..., root_idx + 1:, :, :],
                      centers], dim=-3)


def globalize(motion: torch.Tensor, root_idx: int) -> torch.Tensor:
    """Inverse of :func:`localize`."""
    centers = motion[..., -1:, :, :]
    rel = motion[..., :-1, :, :]
    zero = torch.zeros_like(rel[..., :1, :, :])
    full = torch.cat([rel[..., :root_idx, :, :], zero,
                      rel[..., root_idx:, :, :]], dim=-3)
    return full + centers


def normalize(motion: torch.Tensor, mean: torch.Tensor,
              std: torch.Tensor) -> torch.Tensor:
    """(motion − mean) / std with (J, D) statistics."""
    return (motion - mean[..., None]) / std[..., None]


def denormalize(motion: torch.Tensor, mean: torch.Tensor,
                std: torch.Tensor) -> torch.Tensor:
    return motion * std[..., None] + mean[..., None]


def _interleave(data: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
    """[d0, m0, d1, m1, ..., d_{L-1}] along the last axis."""
    pairs = torch.stack([data[..., :-1], mid], dim=-1)
    return torch.cat([pairs.flatten(-2), data[..., -1:]], dim=-1)


def frame_double(data: torch.Tensor, mask: torch.Tensor,
                 conf: Optional[torch.Tensor] = None):
    """One linear frame-doubling pass, L → 2L − 1.  ``mask`` is (L,);
    midpoints take the mask of the next frame."""
    out = _interleave(data, (data[..., 1:] + data[..., :-1]) / 2)
    new_mask = _interleave(mask, mask[1:])
    new_conf = None
    if conf is not None:
        new_conf = _interleave(conf, (conf[..., 1:] + conf[..., :-1]) / 2)
    return out, new_mask, new_conf


def interpolate_frames(data: torch.Tensor, mask: torch.Tensor,
                       conf: Optional[torch.Tensor] = None, times: int = 1):
    """Repeated frame doubling, L → 2^times·(L − 1) + 1."""
    for _ in range(times):
        data, mask, conf = frame_double(data, mask, conf)
    return data, mask, conf


def encoder_mask_from_pad(pad_mask: torch.Tensor, rate: int) -> torch.Tensor:
    """Keyframe visibility, True = hidden from the encoder: every
    ``rate``-th frame is visible unless padded."""
    idx = torch.arange(pad_mask.shape[-1], device=pad_mask.device)
    return ((idx % rate) != 0) | pad_mask.bool()


def keyframe_interpolate(motion: torch.Tensor, rate: int,
                         mode: str = "linear") -> torch.Tensor:
    """Interpolate a (..., L) sequence from its every-``rate``-th
    keyframes; the final partial segment runs toward the last frame (its
    keyframe index clamped to L − 1).  ``quadratic`` is the reference's
    variant from central differences, in whose first segment the
    negated next keyframe stands in for the previous one."""
    seq_len = motion.shape[-1]
    idx = torch.arange(seq_len, device=motion.device)
    chunk = torch.div(idx, rate, rounding_mode="floor")
    remain = idx % rate
    prev = motion[..., chunk * rate]
    nxt_idx = torch.cat([(chunk[:-1] + 1) * rate,
                         torch.tensor([seq_len - 1], device=motion.device)])
    nxt = motion[..., torch.clamp(nxt_idx, max=seq_len - 1)]
    if mode == "linear":
        w = remain.to(motion.dtype)
        return prev / rate * (rate - w) + nxt / rate * w
    first_seg = idx <= rate
    prev_key_idx = torch.where(first_seg, (chunk + 1) * rate,
                               (chunk - 1) * rate).clamp(0, seq_len - 1)
    one = torch.ones((), dtype=motion.dtype, device=motion.device)
    prv = motion[..., prev_key_idx] * torch.where(first_seg, -one, one)
    this = prev
    t = (remain / rate).to(motion.dtype)
    return this + ((nxt - this) + (prv - this)) / 2 * (t ** 2) \
        + ((nxt - this) - (prv - this)) / 2 * t


def decoder_mask_from_encoder(encoder_mask: torch.Tensor,
                              indices: torch.Tensor) -> torch.Tensor:
    """(..., L) encoder mask with the target positions ``indices``
    (..., sample_size), drawn with replacement, unmasked."""
    return encoder_mask.scatter(-1, indices, False)


def _perm(generator: torch.Generator, B: int, n: int) -> torch.Tensor:
    """B independent random permutations of range(n), (B, n)."""
    return torch.argsort(torch.rand(B, n, generator=generator), dim=1)


def draw_random_drop(generator: torch.Generator, B: int, J: int, D: int,
                     L: int, rate: int) -> Dict[str, torch.Tensor]:
    """:func:`random_drop`'s draws for B clips of (J, D, L), on the
    generator's device: permutations of the keyframes (for the noised,
    dropped and flipped frames) and of the noise and drop joint pools,
    and the uniform [0, 1) noise."""
    n_keys = len(range(0, L, rate))
    return {"noise_frames": _perm(generator, B, n_keys),
            "drop_frames": _perm(generator, B, n_keys),
            "flip_frames": _perm(generator, B, n_keys),
            "noise_joints": _perm(generator, B, len(NOISE_JOINTS)),
            "drop_joints": _perm(generator, B, len(DROP_JOINTS)),
            "noise": torch.rand(B, J, D, L, generator=generator)}


def random_drop(data: torch.Tensor, rate: int, draws: Dict[str, torch.Tensor],
                noise_weight: float = 0.5, noise_rate: int = 15,
                joint_drop_rate: int = 15, flip_rate: int = 8
                ) -> torch.Tensor:
    """Keyframe corruption of (B, J, D, L) clips: on ``noise_rate``
    random keyframes, uniform [0, noise_weight) noise on 5 random limb
    joints; on ``joint_drop_rate`` keyframes, 3 random droppable joints
    zeroed; on ``flip_rate`` keyframes, the legs swapped left for right.
    Every selection is without replacement: the first n entries of a
    permutation in ``draws`` (:func:`draw_random_drop`)."""
    B, J, D, L = data.shape
    dev = data.device
    key_positions = torch.arange(0, L, rate, device=dev)

    def pick(perm, pool, n, size):
        chosen = pool[perm[:, :n].to(dev)]
        mask = torch.zeros(B, size, dtype=torch.bool, device=dev)
        return mask.scatter(1, chosen, True)

    noise_frames = pick(draws["noise_frames"], key_positions, noise_rate, L)
    drop_frames = pick(draws["drop_frames"], key_positions,
                       joint_drop_rate, L)
    flip_frames = pick(draws["flip_frames"], key_positions, flip_rate, L)
    pool = lambda p: torch.tensor(p, device=dev)
    noise_joints = pick(draws["noise_joints"], pool(NOISE_JOINTS), 5, J)
    drop_joints = pick(draws["drop_joints"], pool(DROP_JOINTS), 3, J)

    noise = draws["noise"].to(dev, data.dtype) * noise_weight
    zero = torch.zeros((), dtype=data.dtype, device=dev)
    noise_mask = noise_joints[:, :, None, None] & noise_frames[:, None, None]
    data = data + torch.where(noise_mask, noise, zero)
    drop_mask = drop_joints[:, :, None, None] & drop_frames[:, None, None]
    data = torch.where(drop_mask, zero, data)
    swapped = data.clone()
    swapped[:, list(RIGHT_LEG)] = data[:, list(LEFT_LEG)]
    swapped[:, list(LEFT_LEG)] = data[:, list(RIGHT_LEG)]
    return torch.where(flip_frames[:, None, None], swapped, data)


# ---------------------------------------------------------------------------
# Training-sample synthesis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SynthesisParams:
    """Static parameters of the AMASS → network-sample synthesis."""

    rate: int = 8
    sample_size: int = 50
    rotation_axes: Tuple[float, float, float] = (0.2, 0.0, 1.0)
    rotation_aug: bool = True
    focal: float = 4.0
    depth: float = 4.0
    projection_noise: bool = True
    border: float = 10.0
    camera: str = "perspective"
    train_noise: bool = True
    noise_weight: float = 0.5
    noise_rate: int = 15
    joint_drop_rate: int = 15
    flip_rate: int = 8
    return_3d: bool = False


def synthesis_params(d) -> SynthesisParams:
    """The training synthesis of a :class:`MotionDatasetConfig`."""
    return SynthesisParams(
        rate=d.train_sample_rate, sample_size=d.train_sample_size,
        rotation_axes=d.rotation_axes, rotation_aug=d.rotation_aug,
        focal=d.focal, depth=d.depth, projection_noise=d.projection_noise,
        border=d.frame_boarder, camera=d.camera_project,
        train_noise=d.train_noise, noise_weight=d.noise_weight,
        noise_rate=d.noise_rate, joint_drop_rate=d.joint_drop_rate,
        flip_rate=d.flip_rate, return_3d=d.return_type == "3D")


def draw_synthesis(generator: torch.Generator, B: int, L: int,
                   params: SynthesisParams) -> Dict[str, torch.Tensor]:
    """Every random value of one :func:`synthesize_batch` of B clips of L
    frames: the view angles (B, 3), uniform in ±π·``rotation_axes``; the
    focal and depth jitter (B,), uniform in ±0.1·depth; the
    :func:`random_drop` draws; and the decoder's ``sample_size``
    unmasked indices (B, sample_size), with replacement.  The options
    that are off draw nothing."""
    draws = {}
    if params.rotation_aug:
        axes = torch.tensor(params.rotation_axes) * math.pi
        draws["view"] = (torch.rand(B, 3, generator=generator) * 2 - 1) * axes
    if params.projection_noise:
        d_min = 0.1 * params.depth
        for name in ("focal", "depth"):
            draws[name] = (torch.rand(B, generator=generator) * 2 - 1) * d_min
    if params.train_noise:
        J, D = (52, 3) if params.return_3d else (19, 2)
        draws.update(draw_random_drop(generator, B, J, D, L, params.rate))
    draws["dec_idx"] = torch.randint(0, L, (B, params.sample_size),
                                     generator=generator)
    return draws


def synthesize_sample(motion3d: torch.Tensor, pad_mask: torch.Tensor,
                      mean: torch.Tensor, std: torch.Tensor,
                      params: SynthesisParams, draws: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """One clip (52, 3, L) with its (L,) pad mask and a batch of one's
    ``draws``: :func:`synthesize_batch`'s outputs without the batch
    axis."""
    out = synthesize_batch(motion3d[None], pad_mask[None], mean, std,
                           params, draws)
    return {k: v[0] for k, v in out.items()}


def synthesize_batch(motion3d: torch.Tensor, pad_mask: torch.Tensor,
                     mean: torch.Tensor, std: torch.Tensor,
                     params: SynthesisParams, draws: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Raw SMPL windows (B, 52, 3, L) with their pad masks (B, L), True =
    padded, → training samples: ``data`` (clean), ``input`` (corrupted,
    zero off the visible keyframes) and ``interp`` (the linear prior of
    the corrupted keyframes), each (B, C, L) normalized by the (J, D)
    ``mean``/``std``, and the boolean ``src_mask`` (hidden from the
    encoder), ``tar_mask`` (the decoder's) and ``mask`` (padding), each
    (B, L).  Deterministic given ``draws`` (:func:`draw_synthesis`)."""
    dev = motion3d.device
    on = lambda k: draws[k].to(dev)
    view = on("view") if params.rotation_aug else None
    data3d = rotate_motion_3d(centralize(motion3d), view)
    if params.return_3d:
        projected, root = data3d, ROOT_3D
    else:
        jitter = ((on("focal"), on("depth")) if params.projection_noise
                  else (0.0, 0.0))
        projected = joints_to_openpose(project_2d(
            data3d, params.focal, params.depth, params.border,
            params.camera, *jitter))
        root = ROOT_2D

    to_network = lambda x: normalize(localize(x, root), mean, std)
    clean = to_network(projected)
    noised_src = projected
    if params.train_noise:
        noised_src = random_drop(projected, params.rate, draws,
                                 params.noise_weight, params.noise_rate,
                                 params.joint_drop_rate, params.flip_rate)
    noised = to_network(noised_src)

    pad = pad_mask.bool()
    enc_mask = encoder_mask_from_pad(pad, params.rate)
    dec_mask = decoder_mask_from_encoder(enc_mask, on("dec_idx"))
    interp = keyframe_interpolate(noised, params.rate)
    inputs = noised * (~enc_mask)[:, None, None, :]
    B, J, D, L = clean.shape
    flat = lambda x: x.reshape(B, J * D, L)
    return {"data": flat(clean), "input": flat(inputs),
            "interp": flat(interp), "src_mask": enc_mask,
            "tar_mask": dec_mask, "mask": pad}
