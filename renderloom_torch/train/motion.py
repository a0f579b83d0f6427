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

Data parallel (``renderloom_torch.parallel``): each rank's step takes
its block of the global batch, the synthesis draws are made for the
global batch on every rank and sliced, the optimizer averages the
gradients over the ranks before its clip, and the metrics are
global-batch means.  Dropout masks come from each rank's own generator.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from renderloom_torch.convert import load_flax_params, state_dict_from_flax
from renderloom_torch.core.config import MotionConfig
from renderloom_torch.models.motion_transformer import (MotionTransformer,
                                                        build_motion_model,
                                                        init_motion_params)
from renderloom_torch.ops import pose as pose_ops
from renderloom_torch.parallel.mesh import (count_share, mean_metrics,
                                            replicate, shard_batch, world)
from renderloom_torch.train.gan import (AmsgradIfFinite,
                                        set_float32_precision)
from renderloom_torch.train.schedules import step_schedule


def masked_l1(pred: torch.Tensor, mask: torch.Tensor,
              target: torch.Tensor,
              count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked L1 over (B, C, L) with a (B, L) mask, True = excluded: the
    sum of |pred − target| over the unmasked steps over their count × C
    (at least 1), or over ``count`` where given."""
    not_mask = (~mask.bool()).to(pred.dtype)[:, None, :]
    n = (torch.clamp(not_mask.sum() * pred.shape[1], min=1.0)
         if count is None else count)
    return ((pred - target).abs() * not_mask).sum() / n


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
    ``device`` seeded ``seed + 2`` (+ rank·2³² on other ranks of a data-
    parallel run).  float32 means float32 (no TF32)."""
    set_float32_precision()
    if params is None:
        model = init_motion_params(cfg, seed)
    else:
        model = load_flax_params(build_motion_model(cfg), params)
    model = model.to(device).train()
    replicate(model)            # data parallel: rank 0's weights
    device = torch.device(device)
    return MotionTrainState(
        model, make_optimizer(cfg, model, steps_per_epoch), 0,
        torch.Generator().manual_seed(seed + 1),
        # each rank its own dropout masks (rank 0: seed + 2)
        torch.Generator(device=device).manual_seed(
            seed + 2 + (world()[0] << 32)))


def splice_amsgrad_state(opt: AmsgradIfFinite, model: torch.nn.Module,
                         count: int, mu: dict, nu: dict,
                         nu_max: dict) -> AmsgradIfFinite:
    """Set ``opt``'s AMSGrad moments, in place, to the flax trees ``mu``,
    ``nu`` and ``nu_max`` and its update count to ``count``: the port of
    the JAX package's ``train/motion.py:splice_amsgrad_state``, which
    resumes from the reference's ``opt_epochNNN.pth``
    (``Human_Motion_Modelling/models/trainer.py:100-118``).  Each tree is
    laid out in ``model``'s parameter order, the order of ``opt``'s flat
    buffers.  The parameters, the skip counters and the schedule's own
    count (``schedule_count``) stay as they are, as the JAX package keeps
    its clip, apply_if_finite and schedule states fresh.

    torch's ``exp_avg_sq`` and ``max_exp_avg_sq`` are spliced as they
    are, as in JAX, although torch keeps the maximum of the uncorrected
    second moment and this optimizer that of the corrected one
    (:class:`~renderloom_torch.train.gan.AmsgradIfFinite`)."""
    named = list(model.named_parameters())
    if [id(p) for _, p in named] != [id(p) for p in opt.params]:
        raise ValueError("the optimizer's parameters are not the model's, "
                         "in its order")

    def flat(tree: dict, what: str) -> torch.Tensor:
        sd = state_dict_from_flax(tree)
        names = {n for n, _ in named}
        if set(sd) != names:
            raise ValueError(f"{what} does not match the model's "
                             f"parameters: {sorted(set(sd) ^ names)[:10]}")
        return torch.cat([sd[n].reshape(-1) for n, _ in named]).to(
            opt.flat.device)

    opt.mu, opt.nu, opt.nu_max = (flat(t, w) for t, w in (
        (mu, "mu"), (nu, "nu"), (nu_max, "nu_max")))
    opt.count = torch.tensor(int(count), dtype=torch.int32,
                             device=opt.flat.device)
    return opt


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
    # both terms' counts as this rank's share of the global batch's (data
    # parallel; parallel.count_share), in one all-reduce
    n = count_share(torch.stack([
        (~m.bool()).to(pred.dtype).sum() * pred.shape[1]
        for m in (src_mask, mask_gen)]))
    loss_reco = masked_l1(reco, src_mask, gt, n[0])
    loss_pred = masked_l1(pred, mask_gen, gt, n[1])
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
        b, L = pad_mask.shape
        if draws is None:
            # the global batch's draws; this rank's block of them
            B = b * world()[1]
            draws = shard_batch(pose_ops.draw_synthesis(state.rng, B, L,
                                                        synth), B)
        batch = pose_ops.synthesize_batch(motion3d, pad_mask, *stats[dev],
                                          synth, draws)
        total, (_, metrics) = motion_loss(state.model, batch, synth.rate,
                                          cfg.w_codition, cfg.w_2d,
                                          state.dropout_rng)
        grads = torch.autograd.grad(total, state.opt.params,
                                    materialize_grads=True)
        metrics = mean_metrics(metrics)
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
