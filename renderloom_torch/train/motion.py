"""Motion-transformer training.

Port of the JAX package's ``renderloom/train/motion.py``: the step takes
raw (B, 52, 3, L) SMPL windows with their pad masks, synthesizes the
training samples on the device (:func:`renderloom_torch.ops.pose.
synthesize_batch`, its draws made from the state's CPU generator, so
every device gets the same ones), runs the transformer with dropout (its
masks from the state's generator on the device), takes the gradients and
updates the parameters.

Loss: masked L1 on the denoised keyframes (``src_mask``) weighted
``w_codition``, plus masked L1 on the generated frames (``~(src_mask XOR
pad_mask)``), the sum scaled by ``w_2d``.  Optimizer, as the JAX
package's ``apply_if_finite(chain(clip_by_global_norm(grad_clip),
amsgrad(schedule, beta1, beta2)), 10)``: the flat-buffer
:class:`~renderloom_torch.train.gan.AmsgradIfFinite` with its global-norm
clip; ``weight_decay`` is not applied, as in JAX.  The step computes in
the config's ``compute_dtype`` on float32 parameters.

Metrics (device scalars): ``loss/denoise``, ``loss/pose2d``,
``loss/total``, ``grad_norm`` (of the raw gradients) and ``notfinite``
(the consecutive skipped updates).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from renderloom_torch.convert import load_flax_params
from renderloom_torch.core.config import MotionConfig
from renderloom_torch.models.motion_transformer import (MotionTransformer,
                                                        build_motion_model,
                                                        init_motion_params)
from renderloom_torch.ops import pose as pose_ops
from renderloom_torch.train.gan import (AmsgradIfFinite,
                                        set_float32_precision)
from renderloom_torch.train.schedules import step_schedule


def masked_l1(pred: torch.Tensor, mask: torch.Tensor,
              target: torch.Tensor) -> torch.Tensor:
    """Masked L1 over (B, C, L) with a (B, L) mask, True = excluded: the
    sum of |pred − target| over the unmasked steps over their count × C."""
    not_mask = (~mask.bool()).to(pred.dtype)[:, None, :]
    n = not_mask.sum() * pred.shape[1]
    return ((pred - target).abs() * not_mask).sum() / torch.clamp(n, min=1.0)


def masked_mse(pred: torch.Tensor, mask: torch.Tensor,
               target: torch.Tensor) -> torch.Tensor:
    """Masked MSE with :func:`masked_l1`'s normalization."""
    not_mask = (~mask.bool()).to(pred.dtype)[:, None, :]
    n = not_mask.sum() * pred.shape[1]
    return (((pred - target) ** 2) * not_mask).sum() / torch.clamp(n,
                                                                   min=1.0)


@dataclasses.dataclass
class MotionTrainState:
    """The model (float32 parameters, viewed into the optimizer's flat
    buffer), its optimizer, the step count, the CPU generator of the
    synthesis draws and the device generator of the dropout masks."""

    model: MotionTransformer
    opt: AmsgradIfFinite
    step: int
    rng: torch.Generator
    dropout_rng: torch.Generator


def make_optimizer(cfg: MotionConfig, model: MotionTransformer,
                   steps_per_epoch: int) -> AmsgradIfFinite:
    o = cfg.optim
    return AmsgradIfFinite(
        list(model.parameters()),
        step_schedule(o.lr, o.lr_policy, steps_per_epoch, o.gamma,
                      o.step_size, o.warmup),
        b1=o.beta1, b2=o.beta2, max_consecutive_errors=10,
        clip_norm=o.grad_clip)


def create_motion_state(cfg: MotionConfig, device, seed: int = 0,
                        steps_per_epoch: int = 1,
                        params: Optional[dict] = None) -> MotionTrainState:
    """The motion transformer in training mode on ``device`` with its
    optimizer: weights from the numpy flax tree ``params``, or flax's
    initializers drawn from ``seed``
    (:func:`~renderloom_torch.models.motion_transformer.
    init_motion_params`); the synthesis draws from a CPU generator
    seeded ``seed + 1``, the dropout masks from a generator on
    ``device`` seeded ``seed + 2``.  float32 means float32 (no TF32)."""
    set_float32_precision()
    if params is None:
        model = init_motion_params(cfg, seed)
    else:
        model = load_flax_params(build_motion_model(cfg), params)
    model = model.to(device).train()
    device = torch.device(device)
    return MotionTrainState(
        model, make_optimizer(cfg, model, steps_per_epoch), 0,
        torch.Generator().manual_seed(seed + 1),
        torch.Generator(device=device).manual_seed(seed + 2))


def _seq(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)            # (B, C, L) ↔ (B, L, C)


def motion_loss(model: MotionTransformer, batch: Dict[str, torch.Tensor],
                rate: int, w_codition: float, w_2d: float,
                dropout_rng: Optional[torch.Generator] = None):
    """Forward and loss on a synthesized batch (values (B, C, L));
    dropout on when ``dropout_rng`` is given.  Returns ``(total, (pred,
    metrics))``."""
    src_mask, pad_mask = batch["src_mask"], batch["mask"]
    pred, reco = model(_seq(batch["input"]), src_mask, _seq(batch["interp"]),
                       pad_mask, rate, dropout_rng=dropout_rng)
    pred, reco = _seq(pred), _seq(reco)
    gt = batch["data"]
    mask_gen = ~torch.logical_xor(src_mask.bool(), pad_mask.bool())
    loss_reco = masked_l1(reco, src_mask, gt)
    loss_pred = masked_l1(pred, mask_gen, gt)
    total = (w_codition * loss_reco + loss_pred) * w_2d
    metrics = {"loss/denoise": loss_reco, "loss/pose2d": loss_pred,
               "loss/total": total}
    return total, (pred, metrics)


def make_train_step(cfg: MotionConfig, mean, std,
                    synth: Optional[pose_ops.SynthesisParams] = None
                    ) -> Callable:
    """``train_step(state, raw_batch, draws=None) -> metrics`` over raw
    windows ``{"motion3d": (B, 52, 3, L) float32, "pad_mask": (B, L)
    bool}`` on the model's device; ``draws`` (:func:`~renderloom_torch.
    ops.pose.draw_synthesis`) are drawn from ``state.rng`` when not
    given."""
    synth = synth or pose_ops.synthesis_params(cfg.dataset)
    stats = {}

    def train_step(state: MotionTrainState,
                   raw_batch: Dict[str, torch.Tensor],
                   draws: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
        motion3d, pad_mask = raw_batch["motion3d"], raw_batch["pad_mask"]
        dev = motion3d.device
        if dev not in stats:
            stats[dev] = tuple(torch.as_tensor(x, dtype=torch.float32,
                                               device=dev)
                               for x in (mean, std))
        B, L = pad_mask.shape
        if draws is None:
            draws = pose_ops.draw_synthesis(state.rng, B, L, synth)
        batch = pose_ops.synthesize_batch(motion3d, pad_mask, *stats[dev],
                                          synth, draws)
        total, (_, metrics) = motion_loss(state.model, batch, synth.rate,
                                          cfg.w_codition, cfg.w_2d,
                                          state.dropout_rng)
        grads = torch.autograd.grad(total, state.opt.params,
                                    materialize_grads=True)
        metrics["grad_norm"] = state.opt.step(grads)
        metrics["notfinite"] = state.opt.notfinite_count.float()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(rate: int) -> Callable:
    """``eval_step(model, batch) -> (pred, reco)``, both (B, C, L): the
    deterministic forward on a synthesized batch."""

    @torch.no_grad()
    def eval_step(model: MotionTransformer, batch: Dict[str, torch.Tensor]):
        pred, reco = model(_seq(batch["input"]), batch["src_mask"],
                           _seq(batch["interp"]), batch["mask"], rate)
        return _seq(pred), _seq(reco)

    return eval_step
