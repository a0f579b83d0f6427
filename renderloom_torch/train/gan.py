"""Renderer GAN training and inference.

Port of the JAX package's ``renderloom/train/gan.py``:

* training (``make_gan_optimizers``, ``create_gan_state``, ``d_losses``,
  ``g_gan_losses``, ``make_gan_train_step``): per frame of the window
  one generator forward with ``update_stats``, a D update on its
  detached outputs, then the G loss through the *updated* D (its
  parameters and power-iteration state, without ``update_stats``)
  backpropagated into G only; the previous fused frame is detached, so
  no gradient crosses frames.  The JAX ``lax.scan`` over frames is a
  Python loop.  Two AMSGrad optimizers (TTUR) wrapped like
  ``optax.apply_if_finite``, written out in :class:`AmsgradIfFinite`.
  In the config's compute dtype: under bfloat16, G, D and VGG19 compute
  in bf16 on float32 master parameters, the streamed frames are cast
  once per step, the fused carry stays bf16, the losses reduce in
  float32 and the gradients reach the float32 parameters;
* inference (``make_inference_generator``, ``make_inference_pair``,
  ``make_rollout``, ``rollout_chunked``, ``make_segment_rollout``,
  ``segment_rollout_chunked``): the spectral-norm-folded generator in
  the config's compute dtype (float32 or bfloat16), optionally in the
  parity layout, the sequential and the segment-parallel rollouts, and
  their chunked forms for long clips.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from renderloom_torch.convert import (fold_spectral_norm, load_flax_params,
                                      random_init_)
from renderloom_torch.core.config import RendererConfig, torch_dtype
from renderloom_torch.data.hsm import draw_train_randomness, prepare_batch
from renderloom_torch.models.discriminator import DiscriminatorSet
from renderloom_torch.models.fastpath import FastInferenceGen
from renderloom_torch.models.layers import (cast_weights_,
                                            enable_spectral_norm)
from renderloom_torch.models.perceptual import PerceptualLoss
from renderloom_torch.models.renderer import Generator, composite
from renderloom_torch.ops.image import denorm_to_unit, ssim
from renderloom_torch.parallel.mesh import (all_reduce_mean, count_share,
                                            mean_metrics, replicate,
                                            shard_batch, times_world, world)
from renderloom_torch.train.gan_losses import (feature_matching_loss,
                                               gan_loss,
                                               mask_regulation_loss,
                                               masked_l1_image)
from renderloom_torch.train.schedules import step_schedule

_INT32_MAX = 2 ** 31 - 1


class AmsgradIfFinite:
    """``optax.apply_if_finite(optax.amsgrad(lr_schedule, b1, b2),
    max_consecutive_errors)`` — with ``clip_norm``,
    ``optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(
    clip_norm), optax.amsgrad(...)), max_consecutive_errors)``; with
    ``amsgrad=False`` the same around ``optax.adam(...)`` — over one flat
    float32 buffer that holds
    every parameter (each parameter's ``.data`` becomes a view of it, so
    one update is a handful of kernels and needs no host
    synchronisation).

    Per update, with g the flattened gradients:

    * non-finite g: the update is skipped (parameters and the moments
      stay) and ``notfinite_count`` grows by one; a finite g
      resets it to 0.  Once it exceeds ``max_consecutive_errors`` the
      update is applied all the same, as optax gives up;
    * with ``clip_norm``, g is clipped first, as optax does: with
      ‖g‖ the global norm of the raw g, ``g / ‖g‖ · clip_norm`` where
      ‖g‖ ≥ clip_norm (finiteness is judged on the raw g);
    * otherwise, in optax's order: ``mu = (1 − b1)·g + b1·mu``,
      ``nu = (1 − b2)·g² + b2·nu``, the bias corrections
      ``1 − b^count`` with ``count`` the applied updates, and ``p +=
      −lr(count_before) · mu_hat / (√v + eps)`` with ``v = nu_max =
      max(nu_max, nu_hat)`` (AMSGrad) or ``v = nu_hat`` (Adam, optax's
      ``eps_root`` 0; ``nu_max`` stays 0).  The schedule reads
      ``schedule_count``, optax's own count of the schedule's state,
      which equals ``count`` unless moments were spliced in.

    Under data parallelism (``renderloom_torch.parallel``) g is first
    averaged over the ranks, one all-reduce of the flat vector per
    update.

    ``torch.optim.Adam(amsgrad=True)`` orders the bias correction and
    the maximum differently (it keeps the max of the uncorrected
    ``nu``), so it is not this optimizer."""

    def __init__(self, params: Sequence[torch.nn.Parameter],
                 schedule: Callable, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, max_consecutive_errors: int = 10,
                 clip_norm: Optional[float] = None, amsgrad: bool = True):
        self.params = list(params)
        self.amsgrad = amsgrad
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.clip_norm = clip_norm
        self.max_consecutive_errors = max_consecutive_errors
        self.flat = torch.cat([p.detach().reshape(-1) for p in self.params])
        off = 0
        for p in self.params:
            p.data = self.flat[off:off + p.numel()].view_as(p)
            off += p.numel()
        dev = self.flat.device
        zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.nu_max = torch.zeros_like(self.flat)
        self.count = zero()
        # optax's scale_by_schedule keeps a count of its own: equal to
        # ``count`` but where moments are spliced in (train/motion.py)
        self.schedule_count = zero()
        self.notfinite_count = zero()
        self.total_notfinite = zero()

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
        """One update; returns the raw gradients' global norm when
        clipping (a device scalar), else None."""
        g = torch.cat([x.reshape(-1) for x in grads]).to(self.flat.dtype)
        # data parallel: the ranks' mean gradient, before the finite check,
        # so every rank takes the same decision and update
        g = all_reduce_mean(g)
        isfinite = torch.isfinite(g).all()
        g_norm = None
        if self.clip_norm is not None:
            g_norm = torch.sqrt((g * g).sum())
            g = torch.where(g_norm < self.clip_norm, g,
                            g / g_norm * self.clip_norm)
        bump = lambda c: torch.clamp(c + 1, max=_INT32_MAX).to(torch.int32)
        nf = torch.where(isfinite, torch.zeros_like(self.notfinite_count),
                         bump(self.notfinite_count))
        ok = isfinite | (nf > self.max_consecutive_errors)
        count_inc = bump(self.count)
        mu = (1 - self.b1) * g + self.b1 * self.mu
        nu = (1 - self.b2) * (g * g) + self.b2 * self.nu
        power = lambda b: torch.pow(
            torch.tensor(b, dtype=torch.float32, device=g.device),
            count_inc.to(torch.float32))
        mu_hat = mu / (1 - power(self.b1))
        nu_hat = nu / (1 - power(self.b2))
        nu_max = (torch.maximum(self.nu_max, nu_hat) if self.amsgrad
                  else self.nu_max)
        lr = self.schedule(self.schedule_count).to(g.dtype)
        v = nu_max if self.amsgrad else nu_hat
        update = -lr * (mu_hat / (torch.sqrt(v) + self.eps))
        self.flat.add_(torch.where(ok, update, torch.zeros_like(update)))
        for name, new in (("mu", mu), ("nu", nu), ("nu_max", nu_max),
                          ("count", count_inc),
                          ("schedule_count", bump(self.schedule_count))):
            setattr(self, name, torch.where(ok, new, getattr(self, name)))
        self.total_notfinite = torch.where(isfinite, self.total_notfinite,
                                           bump(self.total_notfinite))
        self.notfinite_count = nf
        return g_norm

    def state_dict(self) -> dict:
        return {k: getattr(self, k) for k in
                ("flat", "mu", "nu", "nu_max", "count", "schedule_count",
                 "notfinite_count", "total_notfinite")}

    def load_state_dict(self, state: dict):
        with torch.no_grad():
            self.flat.copy_(state["flat"])
        state = dict(state)
        state.setdefault("schedule_count", state["count"])
        for k in ("mu", "nu", "nu_max", "count", "schedule_count",
                  "notfinite_count", "total_notfinite"):
            setattr(self, k, state[k].to(self.flat.device))


def adam_if_finite(params: Sequence[torch.nn.Parameter], lr: float,
                   grad_clip: float) -> AmsgradIfFinite:
    """``optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(
    grad_clip), optax.adam(lr)), 10)``, the optimizer of the flow UNet
    and the pose head."""
    return AmsgradIfFinite(
        params, lambda count: torch.full_like(count, lr, dtype=torch.float32),
        b1=0.9, b2=0.999, max_consecutive_errors=10, clip_norm=grad_clip,
        amsgrad=False)


def make_gan_optimizers(cfg: RendererConfig, gen: torch.nn.Module,
                        dis: torch.nn.Module, steps_per_epoch: int = 1
                        ) -> Tuple[AmsgradIfFinite, AmsgradIfFinite]:
    """TTUR AMSGrad for G (``lr``) and D (``lr_d``), each on the
    ``step_schedule`` of the config's policy, skipping non-finite
    updates (10 in a row at most)."""
    o = cfg.optim
    opt = lambda module, lr: AmsgradIfFinite(
        list(module.parameters()),
        step_schedule(lr, o.lr_policy, steps_per_epoch, o.gamma,
                      o.step_size), b1=o.beta1, b2=o.beta2,
        max_consecutive_errors=10)
    return opt(gen, o.lr), opt(dis, o.lr_d)


def set_float32_precision():
    """float32 means float32: cuDNN would run convolutions in TF32 by
    default, a 1e-3-level difference from the reference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass
class GanTrainState:
    """Both networks (parameters and power-iteration state live in the
    modules), both optimizers, the step count, and the generator of the
    train-mode preparation's draws (a CPU ``torch.Generator``, so every
    device draws the same values)."""

    gen: Generator
    dis: DiscriminatorSet
    opt_g: AmsgradIfFinite
    opt_d: AmsgradIfFinite
    step: int
    rng: torch.Generator


def create_gan_state(cfg: RendererConfig, device, seed: int = 0,
                     steps_per_epoch: int = 1,
                     trees: Optional[Dict[str, dict]] = None
                     ) -> GanTrainState:
    """Generator and discriminator set in their training form on
    ``device`` with their optimizers, computing in the config's
    ``compute_dtype`` on float32 parameters.  Weights: the numpy flax
    trees ``trees`` (``params_g``, ``stats_g``, ``params_d``,
    ``stats_d``) or, without them, seeded random ones (G from ``seed``, D
    from ``seed + 1``)."""
    set_float32_precision()
    dtype = torch_dtype(cfg.compute_dtype)
    gen = enable_spectral_norm(Generator(cfg.gen, dtype))
    dis = enable_spectral_norm(DiscriminatorSet(cfg.dis, dtype))
    if trees is None:
        random_init_(gen, seed)
        random_init_(dis, seed + 1)
    else:
        load_flax_params(gen, trees["params_g"], trees["stats_g"])
        load_flax_params(dis, trees["params_d"], trees["stats_d"])
    gen, dis = gen.to(device).train(), dis.to(device).train()
    replicate(gen)              # data parallel: rank 0's weights
    replicate(dis)
    opt_g, opt_d = make_gan_optimizers(cfg, gen, dis, steps_per_epoch)
    return GanTrainState(gen, dis, opt_g, opt_d, 0,
                         torch.Generator().manual_seed(seed + 2))


def make_perceptual(cfg: RendererConfig, device, seed: int = 0,
                    params: Optional[dict] = None,
                    require_pretrained: bool = False,
                    network: str = "vgg19",
                    weights_path: Optional[str] = None) -> PerceptualLoss:
    """The perceptual loss on ``device``, frozen, as the JAX package's
    ``PerceptualLoss(network=, weights_path=)`` builds it.  The config's
    ``perceptual.model`` is not read (the JAX package reads it nowhere):
    the training CLI, the bench and ``chip_smoke.py`` pass no
    ``network`` and train on VGG19 whatever the config names.

    VGG19: the config's taps and tap weights, in its compute dtype, with
    the flax tree ``params`` (``PerceptualLoss().variables["params"]``
    of the JAX package); else the torchvision weights at
    ``weights_path`` or those ``find_vgg_weights`` finds; else fixed
    random weights from ``seed``, which ``require_pretrained`` refuses.
    Another ``network``: its own taps with uniform weights, in float32,
    with the weights at ``weights_path`` or random ones from ``seed``
    (refused likewise); ``params`` is VGG19's only."""
    if network != "vgg19":
        if params is not None:
            raise ValueError("params is a VGG19 tree; load another "
                             "network's through weights_path")
        vgg = PerceptualLoss(network=network, weights_path=weights_path,
                             require_pretrained=require_pretrained)
    else:
        vgg = PerceptualLoss(cfg.perceptual.layers, cfg.perceptual.weights,
                             torch_dtype(cfg.compute_dtype),
                             weights_path=weights_path,
                             require_pretrained=(require_pretrained
                                                 and params is None))
        if params is not None:
            load_flax_params(vgg.model, params)
    if params is None and not vgg.pretrained:
        random_init_(vgg, seed)
        print("PerceptualLoss: no VGG19 weights found — using fixed random "
              "features (set VGG19_NPZ for parity)" if network == "vgg19"
              else f"PerceptualLoss[{network}]: no weights — using fixed "
              "random features")
    for p in vgg.parameters():
        p.requires_grad_(False)
    return vgg.to(device).eval()


def _weights_dict(cfg: RendererConfig) -> Dict[str, float]:
    g = cfg.gan
    w = {"fuse": g.fuse, "raw": g.raw}
    if cfg.dis.use_face:
        w["face"] = g.face
    if cfg.dis.use_hand:
        w["hand"] = g.hand
    return w


def count_shares(d_out: Dict, fg: torch.Tensor, img: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """A frame's divisors of the losses that divide by a count over the
    batch, in one :func:`~renderloom_torch.parallel.count_share`: the
    foreground's masked elements (``"fg"``, :func:`masked_l1_image`'s)
    and each weighted discriminator's summed sample weight (its key)."""
    keys = [k for k, out in d_out.items() if out.get("weight") is not None]
    shares = count_share(torch.stack(
        [fg.expand(img.shape).float().sum()]
        + [d_out[k]["weight"].float().sum() for k in keys]))
    return {"fg": shares[0], **dict(zip(keys, shares[1:]))}


def d_losses(d_out: Dict, mode: str, weights: Dict[str, float],
             counts: Optional[Dict[str, torch.Tensor]] = None):
    """Σ w_key·(loss on fakes + loss on reals), and the per-key terms;
    ``counts`` (:func:`count_shares`) give the weighted keys' divisors."""
    counts = counts or {}
    per_key = {}
    for key, out in d_out.items():
        wgt, n = out.get("weight"), counts.get(key)
        per_key[key] = (gan_loss(out["pred_fake"]["output"], False, True,
                                 mode, wgt, n)
                        + gan_loss(out["pred_real"]["output"], True, True,
                                   mode, wgt, n))
    total = sum(per_key[k] * weights[k] for k in per_key)
    return total, per_key


def g_gan_losses(d_out: Dict, mode: str, weights: Dict[str, float],
                 fm_w: float,
                 counts: Optional[Dict[str, torch.Tensor]] = None):
    """G-side GAN and feature-matching totals (``counts`` as
    :func:`d_losses`)."""
    counts = counts or {}
    gan_total = 0.0
    fm_total = 0.0
    for key, out in d_out.items():
        wgt, n = out.get("weight"), counts.get(key)
        gan_total = gan_total + weights[key] * gan_loss(
            out["pred_fake"]["output"], True, False, mode, wgt, n)
        fm_total = fm_total + fm_w * feature_matching_loss(
            out["pred_fake"]["features"], out["pred_real"]["features"], wgt,
            n)
    return gan_total, fm_total


def make_gan_train_step(cfg: RendererConfig, perceptual: PerceptualLoss,
                        data_cfg=None,
                        on_stage: Optional[Callable[[str], None]] = None
                        ) -> Callable:
    """The multi-frame train step ``train_step(state, batch) ->
    metrics``.

    ``batch`` (NHWC, frame axis second): label (B, L, H, W, 22), image
    and back (B, L, H, W, 3) in [-1, 1], fg_mask (B, L, H, W, 1).  With
    ``data_cfg`` set it instead takes raw windows (images and dain
    (B, L, H0, W0, 3) in [0, 255], poses (B, L, 19, 3)) and runs the
    train-mode preparation first, drawing its randomness from
    ``state.rng``.  Metrics are device scalars: each loss averaged over
    the L − 2 trained frames, and ``notfinite/g``/``notfinite/d``, the
    optimizers' consecutive skipped updates.  The frames are cast to the
    config's compute dtype once (the label after the preparation
    rasterized it in float32); the metrics are float32.

    Data parallel (``renderloom_torch.parallel``): ``batch`` is this
    rank's block of the global batch (``shard_batch``); the preparation's
    draws are made for the global batch on every rank and each takes its
    block, the optimizers average the gradients over the ranks, and the
    metrics are global-batch means.

    ``on_stage(name)``, when given, is called as each stage ends:
    ``"prep"`` once, then per frame ``"g_forward"``, ``"d_step"`` and
    ``"g_step"`` (a profiler synchronises and reads its clock there)."""
    stage = on_stage or (lambda name: None)
    cdtype = torch_dtype(cfg.compute_dtype)
    mode = cfg.gan_mode
    weights = _weights_dict(cfg)

    def g_loss(dis, label, real, fg, back, img, mask, counts):
        fused = composite(img, mask, back)
        d_out = dis(label, real, fused, img, fg, update_stats=False)
        loss_gan, loss_fm = g_gan_losses(d_out, mode, weights, cfg.fm_w,
                                         counts)
        loss_perc = (perceptual(fused, real) + perceptual(img * fg, real * fg)
                     ) * cfg.perceptual.weight
        loss_l1 = ((fused - real).abs().float().mean()
                   + masked_l1_image(img, fg, real, count=counts["fg"])
                   ) * cfg.l1_w
        # summed over the batch: this rank's share of the global sum
        loss_mask = times_world(mask_regulation_loss(mask)) * cfg.mask_w
        total = loss_gan + loss_fm + loss_perc + loss_l1 + loss_mask
        metrics = {"g/gan": loss_gan, "g/fm": loss_fm, "g/perc": loss_perc,
                   "g/l1": loss_l1, "g/mask": loss_mask}
        if cfg.ssim_w:
            loss_ssim = ssim_loss(fused, real, fg) * cfg.ssim_w
            total = total + loss_ssim
            metrics["g/ssim"] = loss_ssim
        if cfg.grad_w:
            # fg-masked L1 of forward differences, composite vs truth
            fm, rm = (fused * fg).float(), (real * fg).float()
            diff = lambda x, d: x.diff(dim=d)
            loss_grad = ((diff(fm, -3) - diff(rm, -3)).abs().mean()
                         + (diff(fm, -2) - diff(rm, -2)).abs().mean()
                         ) * cfg.grad_w
            total = total + loss_grad
            metrics["g/grad"] = loss_grad
        metrics["g/total"] = total
        return total, fused, metrics

    def frame_step(state: GanTrainState, xs: Dict[str, torch.Tensor],
                   prev_fuse: torch.Tensor):
        gen, dis = state.gen, state.dis
        label, back, real, fg = xs["label"], xs["back"], xs["real"], xs["fg"]
        # one G forward with update_stats, kept for the G backward
        img, mask = gen(label, xs["label_prev"], back, prev_fuse.detach(),
                        update_stats=True)
        fuse = composite(img, mask, back)
        stage("g_forward")

        # D update (old D, detached G outputs)
        d_out = dis(label, real, fuse.detach(), img.detach(), fg,
                    update_stats=True)
        # the frame's counts over the global batch (data parallel), which
        # the G update's discriminator pass shares
        counts = count_shares(d_out, fg, img)
        d_total, d_per_key = d_losses(d_out, mode, weights, counts)
        state.opt_d.step(torch.autograd.grad(d_total, state.opt_d.params,
                                             materialize_grads=True))
        stage("d_step")

        # G update through the updated D, into G only
        g_total, fused, metrics = g_loss(dis, label, real, fg, back, img,
                                         mask, counts)
        state.opt_g.step(torch.autograd.grad(g_total, state.opt_g.params,
                                             materialize_grads=True))
        stage("g_step")
        metrics["d/total"] = d_total
        for k, v in d_per_key.items():
            metrics[f"d/{k}"] = v
        return {k: v.detach() for k, v in metrics.items()}, fused.detach()

    def train_step(state: GanTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        if data_cfg is not None:
            b, F = batch["images"].shape[:2]
            dev = batch["images"].device
            # the global batch's draws; this rank's block of them
            B = b * world()[1]
            draws = shard_batch(draw_train_randomness(state.rng, B, F,
                                                      data_cfg), B)
            batch = prepare_batch(batch, data_cfg,
                                  {k: v.to(dev) for k, v in draws.items()})
            stage("prep")
        # (L, B, ...), cast to the compute dtype once
        tm = lambda x: x.transpose(0, 1).to(cdtype)
        label, image = tm(batch["label"]), tm(batch["image"])
        back, fg = tm(batch["back"]), tm(batch["fg_mask"])
        L = label.shape[0]
        prev_fuse = image[0]
        per_frame: List[Dict[str, torch.Tensor]] = []
        for t in range(1, L - 1):
            metrics, prev_fuse = frame_step(
                state, {"label": label[t], "label_prev": label[t - 1],
                        "back": back[t], "real": image[t], "fg": fg[t]},
                prev_fuse)
            per_frame.append(metrics)
        state.step += 1
        out = mean_metrics({k: torch.stack([m[k] for m in per_frame]).mean()
                            for k in per_frame[0]})
        out["notfinite/g"] = state.opt_g.notfinite_count.float()
        out["notfinite/d"] = state.opt_d.notfinite_count.float()
        return out

    return train_step


def ssim_loss(fused: torch.Tensor, real: torch.Tensor,
              fg: torch.Tensor) -> torch.Tensor:
    """``1 − SSIM`` of the fg-masked composite against the masked truth,
    both mapped to [0, 1] in their own dtype and compared in float32."""
    return 1.0 - ssim((denorm_to_unit(fused) * fg).float(),
                      (denorm_to_unit(real) * fg).float())


def make_inference_generator(cfg: RendererConfig) -> Generator:
    """The generator the rollout runs, in the config's compute dtype, with
    float32 parameters for the folded weights to load into.  The
    config's weight-norm types are kept so the random initializer knows
    which weights to normalize."""
    return Generator(cfg.gen, torch_dtype(cfg.compute_dtype))


def make_inference_pair(cfg: RendererConfig, params_g: Optional[dict],
                        stats_g: Optional[dict], device,
                        fastpath: bool = False) -> nn.Module:
    """The inference generator on ``device`` with its weights: the numpy
    flax trees ``params_g``/``stats_g`` folded and converted, or, when
    ``params_g`` is None, random weights from seed 1.  ``fastpath``
    returns the parity-layout :class:`FastInferenceGen` over those folded
    weights (the JAX ``make_inference_pair`` with ``fold_fast_params``),
    the same function as the standard generator, its kernels built in
    float32.  The standard generator's convolutions hold their weights
    in the compute dtype (cast once here; its norms' γ, β stay float32)."""
    gen = make_inference_generator(cfg)
    if params_g is None:
        random_init_(gen, 1)
    else:
        load_flax_params(gen, fold_spectral_norm(params_g, stats_g or {}))
    gen = gen.to(device).eval()
    if fastpath:
        return FastInferenceGen(gen, cfg.gen).eval()
    return cast_weights_(gen)


def make_rollout(gen: nn.Module) -> Callable:
    """The sequential autoregressive rollout (the evaluator's semantics):
    keyframes pass through with a zero mask, every other frame is
    generated from the previous fused frame and label.

    ``batch``: label (B, L, H, W, 22) (or packed, for the parity-layout
    generator), back and key_img (B, L, H, W, 3), ``is_key`` (L,) bool;
    optionally ``init_fuse`` (B, H, W, 3) and ``init_label``, the carry
    of a previous chunk (:func:`rollout_chunked`), in place of frame 0's
    key image and label.  Returns fused (B, L, H, W, 3) and masks
    (B, L, H, W, 1), the masks in the generator's ``dtype``.  The JAX
    scan runs the generator at every frame and selects the key image at
    keyframes; here a keyframe makes no generator call, with the same
    result.
    """
    def rollout(batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        label, back, key_img = batch["label"], batch["back"], \
            batch["key_img"]
        is_key = torch.as_tensor(batch["is_key"]).reshape(-1).tolist()
        if "init_fuse" in batch:
            prev_fuse, prev_label = batch["init_fuse"], batch["init_label"]
        else:
            prev_fuse, prev_label = key_img[:, 0], label[:, 0]
        fused, masks = [], []
        for t, key in enumerate(is_key):
            if key:
                fuse, mask = key_img[:, t], None
            else:
                img, mask = gen(label[:, t], prev_label, back[:, t],
                                prev_fuse)
                fuse = composite(img, mask, back[:, t])
            fused.append(fuse)
            masks.append(mask)
            prev_fuse, prev_label = fuse, label[:, t]
        zero = torch.zeros(key_img.shape[:1] + key_img.shape[2:-1] + (1,),
                           dtype=gen.dtype, device=key_img.device)
        return (torch.stack(fused, dim=1),
                torch.stack([zero if m is None else m for m in masks],
                            dim=1))

    return rollout


def rollout_chunked(rollout: Callable, batch: Dict[str, torch.Tensor],
                    chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`make_rollout`'s ``rollout`` over a long clip in chunks of
    ``chunk`` frames, the fused frame and label carried from each chunk
    into the next, so memory stays O(chunk).  The JAX function pads the
    last chunk to ``chunk`` frames to keep one compiled shape; eager
    PyTorch has none to keep, and frames after the last valid one cannot
    reach it, so the last chunk runs at its own length."""
    L = batch["label"].shape[1]
    if L <= chunk:
        return rollout(batch)
    is_key = torch.as_tensor(batch["is_key"]).reshape(-1)
    fused_parts, mask_parts, carry = [], [], {}
    for start in range(0, L, chunk):
        end = min(start + chunk, L)
        seg = {k: batch[k][:, start:end] for k in ("label", "back",
                                                   "key_img")}
        seg["is_key"] = is_key[start:end]
        fused, masks = rollout({**seg, **carry})
        fused_parts.append(fused)
        mask_parts.append(masks)
        carry = {"init_fuse": fused[:, -1], "init_label": seg["label"][:, -1]}
    return torch.cat(fused_parts, dim=1), torch.cat(mask_parts, dim=1)


def make_segment_rollout(gen: Generator, rate: int) -> Callable:
    """Segment-parallel rollout for the keyframe pattern ``t % rate ==
    0``: every keyframe resets the autoregressive chain, so the (K−1)
    segments run as one batch through ``rate − 1`` sequential generator
    steps (the JAX ``lax.scan`` becomes a Python loop).

    ``batch``: label (B, L, H, W, 22) (or, for the parity-layout
    generator, packed (B, L, H/2, W/2, 88)), back (B, L, H, W, 3),
    key_img (B, L, H, W, 3) with L = S·rate + 1.  Returns fused
    (B, L, H, W, 3) and masks (B, L, H, W, 1); keyframes pass through
    with a zero mask.
    """
    def rollout(batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        label, back, key_img = batch["label"], batch["back"], \
            batch["key_img"]
        B, L = label.shape[:2]
        if (L - 1) % rate:
            raise ValueError(f"clip length {L} is not S·{rate} + 1")
        S = (L - 1) // rate

        def seg(x):
            # (B, L, ...) → (rate, B·S, ...): segment s covers frames
            # [s·rate, (s+1)·rate), in-segment index first
            body = x[:, :S * rate].reshape((B, S, rate) + x.shape[2:])
            return body.movedim(2, 0).reshape((rate, B * S) + x.shape[2:])

        def unseg(x):
            body = x.reshape((rate, B, S) + x.shape[2:]).movedim(0, 2)
            return body.reshape((B, S * rate) + x.shape[2:])

        label_s, back_s, key_s = seg(label), seg(back), seg(key_img)
        prev_fuse, prev_label = key_s[0], label_s[0]
        fused_seg, masks_seg = [key_s[0]], []
        for t in range(1, rate):
            # the carry is float32 under bf16 compute too: the bf16 image
            # and mask composite over the float32 background
            img, mask = gen(label_s[t], prev_label, back_s[t], prev_fuse)
            prev_fuse = composite(img, mask, back_s[t])
            prev_label = label_s[t]
            fused_seg.append(prev_fuse)
            masks_seg.append(mask)
        masks_seg.insert(0, torch.zeros_like(masks_seg[0]) if masks_seg
                         else torch.zeros(key_s.shape[1:-1] + (1,),
                                          dtype=key_s.dtype,
                                          device=key_s.device))
        fused = torch.cat([unseg(torch.stack(fused_seg)), key_img[:, -1:]],
                          dim=1)
        last = torch.zeros(key_img[:, -1:].shape[:-1] + (1,),
                           dtype=masks_seg[0].dtype, device=key_img.device)
        masks = torch.cat([unseg(torch.stack(masks_seg)), last], dim=1)
        return fused, masks

    return rollout


def segment_rollout_chunked(seg_rollout: Callable,
                            batch: Dict[str, torch.Tensor], rate: int,
                            seg_chunk: int = 16
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`make_segment_rollout`'s ``rollout`` over ``seg_chunk``
    segments at a time, so memory stays O(seg_chunk · rate) frames.
    Every chunk starts at a keyframe, so nothing carries across chunks.
    The JAX function pads the last chunk to ``seg_chunk`` segments to
    keep one compiled shape; eager PyTorch has none to keep, so the last
    chunk runs at its own length."""
    L = batch["label"].shape[1]
    S = (L - 1) // rate
    if S * rate + 1 != L:
        raise ValueError(f"clip length {L} is not S·{rate} + 1")
    if S <= seg_chunk:
        return seg_rollout(batch)
    fused_parts, mask_parts = [], []
    for s0 in range(0, S, seg_chunk):
        s1 = min(s0 + seg_chunk, S)
        fused, masks = seg_rollout({k: batch[k][:, s0 * rate:s1 * rate + 1]
                                    for k in ("label", "back", "key_img")})
        valid = (s1 - s0) * rate + (1 if s1 == S else 0)
        fused_parts.append(fused[:, :valid])
        mask_parts.append(masks[:, :valid])
    return torch.cat(fused_parts, dim=1), torch.cat(mask_parts, dim=1)
