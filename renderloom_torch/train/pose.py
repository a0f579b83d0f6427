"""PoseNet training on (image, pose) pairs.

Port of the JAX package's ``renderloom/train/pose.py``.  Targets are the
port's gaussian heatmaps (``ops.rasterize.gaussian_heatmaps``, the
rasterizer the renderer conditions on) drawn at heatmap resolution; the
loss is a foreground-weighted MSE against them, masked per joint by
label confidence, plus a small soft-argmax coordinate loss.  Optional
occlusion augmentation (:func:`random_erase`).  Optimizer, as JAX's
``apply_if_finite(chain(clip_by_global_norm(grad_clip), adam(lr)),
10)``: :func:`~renderloom_torch.train.gan.adam_if_finite`.

Metrics (device scalars): ``loss/heat``, ``loss/coord``,
``loss/total``, ``grad_norm`` (of the raw gradients) and ``notfinite``
(the consecutive skipped updates).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from renderloom_torch.convert import flax_init_, load_flax_params
from renderloom_torch.core.config import PoseNetConfig, torch_dtype
from renderloom_torch.models.posenet import (N_JOINTS, STRIDE, PoseNet,
                                             decode_heatmaps)
from renderloom_torch.ops.rasterize import gaussian_heatmaps
from renderloom_torch.train.gan import (AmsgradIfFinite, adam_if_finite,
                                        set_float32_precision)


@dataclasses.dataclass
class PoseTrainState:
    """The head (float32 parameters, viewed into the optimizer's flat
    buffer), its optimizer, the step count and the seed of the occlusion
    draws."""

    model: PoseNet
    opt: AmsgradIfFinite
    step: int
    seed: int


def build_pose_model(cfg: PoseNetConfig) -> PoseNet:
    return PoseNet(cfg.base_filters, cfg.blocks,
                   torch_dtype(cfg.compute_dtype))


def create_pose_state(cfg: PoseNetConfig, device, seed: int = 0,
                      params: Optional[dict] = None) -> PoseTrainState:
    """The head in training mode on ``device`` with its optimizer:
    weights from the numpy flax tree ``params``, or flax's initializers
    drawn from ``seed`` (the logits conv zero); the occlusion draws from
    ``seed + 1``.  float32 means float32 (no TF32)."""
    set_float32_precision()
    model = build_pose_model(cfg)
    if params is None:
        flax_init_(model, seed)
    else:
        load_flax_params(model, params)
    model = model.to(device).train()
    return PoseTrainState(model, adam_if_finite(model.parameters(), cfg.lr,
                                                cfg.grad_clip), 0, seed + 1)


def pose_loss(model: PoseNet, images: torch.Tensor, poses: torch.Tensor,
              cfg: PoseNetConfig):
    """``images``: (B, H, W, 3) in [0, 1]; ``poses``: (B, 19, 3) image
    pixels (x, y, conf).  Returns ``(total, metrics)``."""
    B, H, W, _ = images.shape
    logits = model(images)
    h, w = H // STRIDE, W // STRIDE
    coords = poses[..., :2] / STRIDE - 0.5          # heatmap-cell coords
    conf = poses[..., 2]                            # (B, J)
    sigma = torch.full((N_JOINTS,), cfg.sigma / STRIDE,
                       device=images.device)
    target = gaussian_heatmaps(coords, conf, h, w, sigma).permute(0, 2, 3, 1)
    valid = (conf > cfg.conf_thres).float()
    # MSE on linear heatmaps, weighted towards the peaks (the 19 peak
    # cells would otherwise drown in h·w background zeros)
    weight = (1.0 + cfg.fg_weight * target) * valid[:, None, None, :]
    l_heat = (((logits - target) ** 2) * weight).sum() \
        / torch.clamp(weight.sum(), min=1.0)
    kps, _ = decode_heatmaps(logits)
    l_coord = (torch.abs(kps - poses[..., :2]) * valid[..., None]).sum() \
        / torch.clamp(valid.sum() * 2, min=1.0) / max(H, W)
    total = l_heat + cfg.w_coord * l_coord
    return total, {"loss/heat": l_heat, "loss/coord": l_coord,
                   "loss/total": total}


def draw_erase(generator: torch.Generator, B: int, count: int,
               frac: float) -> Dict[str, torch.Tensor]:
    """The draws of :func:`random_erase` from a CPU ``generator``, per
    rectangle i and image b: ``wh`` (count, B, 2) box height and width
    as shares of the side, uniform in [0.1, max(frac, 0.1)); ``cyx``
    (count, B, 2) the centre as shares, uniform in [0, 1); ``u`` (count,
    B) uniform, the rectangle drawn where ``u < rate``; ``color`` (count,
    B, 3) uniform."""
    hi = max(frac, 0.1)
    out = {k: [] for k in ("wh", "cyx", "u", "color")}
    for _ in range(count):
        out["wh"].append(0.1 + (hi - 0.1) * torch.rand((B, 2),
                                                       generator=generator))
        out["cyx"].append(torch.rand((B, 2), generator=generator))
        out["u"].append(torch.rand((B,), generator=generator))
        out["color"].append(torch.rand((B, 3), generator=generator))
    return {k: torch.stack(v) for k, v in out.items()}


def apply_erase(images: torch.Tensor, draws: Dict[str, torch.Tensor],
                rate: float) -> torch.Tensor:
    """Occlusion augmentation of (B, H, W, 3) ``images`` with the draws
    of :func:`draw_erase`: each rectangle i, where ``u[i] < rate``,
    fills the pixels within half its size of its centre with its flat
    colour, in order.  The pose targets are not edited: the head learns
    to infer hidden joints from context."""
    B, H, W, _ = images.shape
    dev = images.device
    d = {k: v.to(dev) for k, v in draws.items()}
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :, None]
    col = lambda v: v[:, None, None, None]
    for i in range(d["wh"].shape[0]):
        bh, bw = d["wh"][i, :, 0] * H, d["wh"][i, :, 1] * W
        cy, cx = d["cyx"][i, :, 0] * H, d["cyx"][i, :, 1] * W
        inside = ((torch.abs(ys - col(cy)) < col(bh) / 2)
                  & (torch.abs(xs - col(cx)) < col(bw) / 2)
                  & col(d["u"][i] < rate))
        images = torch.where(inside, d["color"][i][:, None, None, :], images)
    return images


def random_erase(generator: torch.Generator, images: torch.Tensor,
                 count: int, rate: float, frac: float) -> torch.Tensor:
    """``count`` random flat-colour rectangles per image, each drawn
    with probability ``rate``, up to ``frac`` of the image side
    (:func:`draw_erase`, then :func:`apply_erase`)."""
    return apply_erase(images, draw_erase(generator, images.shape[0], count,
                                          frac), rate)


def erase_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s occlusion draws, seeded from
    (seed, step): where JAX folds the step into its key
    (``fold_in(key, step)``), so the stream is stable across a resumed
    run."""
    return torch.Generator().manual_seed((seed << 32) + step)


def make_pose_train_step(cfg: PoseNetConfig) -> Callable:
    """``train_step(state, batch, draws=None) -> metrics`` on ``{"images":
    (B, H, W, 3) uint8 (divided by 255) or float in [0, 1], "poses": (B,
    19, 3)}`` on the model's device.  With ``cfg.occlude_rate > 0`` the
    images are erased with ``draws`` (:func:`draw_erase`), drawn from
    :func:`erase_generator` (state.seed, state.step) when not given."""

    def train_step(state: PoseTrainState, batch: Dict[str, torch.Tensor],
                   draws: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
        images = batch["images"].float()
        if not batch["images"].is_floating_point():
            images = images / 255.0
        if cfg.occlude_rate > 0.0:
            if draws is None:
                draws = draw_erase(erase_generator(state.seed, state.step),
                                   images.shape[0], cfg.occlude_count,
                                   cfg.occlude_frac)
            images = apply_erase(images, draws, cfg.occlude_rate)
        _, metrics = pose_loss(state.model, images, batch["poses"].float(),
                               cfg)
        grads = torch.autograd.grad(metrics["loss/total"], state.opt.params,
                                    materialize_grads=True)
        metrics["grad_norm"] = state.opt.step(grads)
        metrics["notfinite"] = state.opt.notfinite_count.float()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step
