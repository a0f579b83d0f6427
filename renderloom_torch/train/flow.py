"""Flow-interpolator training: middle-frame supervision on triplets.

Port of the JAX package's ``renderloom/train/flow.py``.  For a triplet
(f0, f1, f2) the UNet predicts the flows between f0 and f2, the
Super-SloMo time warp synthesizes t = 0.5, and the losses are

* reconstruction: L1(warp(f0, f2, 0.5), f1), the true middle frame;
* photometric: L1 of each keyframe warped onto the other;
* smoothness: L1 of the flows' spatial differences.

Every warp of the loss is the exact bilinear gather warp, so the
photometric gradient is never clipped at ``max_disp``.  Optimizer, as
JAX's ``apply_if_finite(chain(clip_by_global_norm(grad_clip),
adam(lr)), 10)``: :class:`~renderloom_torch.train.gan.AmsgradIfFinite`
with ``amsgrad=False``.  The step computes in the config's
``compute_dtype`` on float32 parameters and draws nothing.  Its warps
sample the frames, which need no gradient, so no gather is
differentiated; on the card two runs differ only through cuDNN's
convolution backward algorithms (chip_smoke.py phase G).

Metrics (device scalars): ``loss/rec``, ``loss/photo``,
``loss/smooth``, ``loss/total``, ``grad_norm`` (of the raw gradients)
and ``notfinite`` (the consecutive skipped updates).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from renderloom_torch.convert import flax_init_, load_flax_params
from renderloom_torch.core.config import FlowConfig, torch_dtype
from renderloom_torch.models.flownet import FlowUNet, time_warp
from renderloom_torch.ops.flow import backward_warp
from renderloom_torch.train.gan import (AmsgradIfFinite, adam_if_finite,
                                        set_float32_precision)


@dataclasses.dataclass
class FlowTrainState:
    """The UNet (float32 parameters, viewed into the optimizer's flat
    buffer), its optimizer and the step count."""

    model: FlowUNet
    opt: AmsgradIfFinite
    step: int


def build_flow_model(cfg: FlowConfig) -> FlowUNet:
    return FlowUNet(cfg.base_filters, cfg.levels,
                    torch_dtype(cfg.compute_dtype))


def create_flow_state(cfg: FlowConfig, device, seed: int = 0,
                      params: Optional[dict] = None) -> FlowTrainState:
    """The UNet in training mode on ``device`` with its optimizer:
    weights from the numpy flax tree ``params``, or flax's initializers
    drawn from ``seed`` (:func:`~renderloom_torch.convert.flax_init_`;
    the flow head zero).  float32 means float32 (no TF32)."""
    set_float32_precision()
    model = build_flow_model(cfg)
    if params is None:
        flax_init_(model, seed)
    else:
        load_flax_params(model, params)
    model = model.to(device).train()
    return FlowTrainState(model, adam_if_finite(model.parameters(), cfg.lr,
                                                cfg.grad_clip), 0)


def _smoothness(flow: torch.Tensor) -> torch.Tensor:
    dx = torch.abs(flow[:, :, 1:] - flow[:, :, :-1])
    dy = torch.abs(flow[:, 1:] - flow[:, :-1])
    return dx.mean() + dy.mean()


def flow_loss(model: FlowUNet, triplet: torch.Tensor, cfg: FlowConfig):
    """``triplet``: (B, 3, H, W, 3) float in [0, 1].  Returns
    ``(total, metrics)``."""
    f0, f_mid, f2 = triplet[:, 0], triplet[:, 1], triplet[:, 2]
    f01, f10 = model(f0, f2)
    pred = time_warp(f0, f2, f01, f10, 0.5, max_disp=0, exact=True)
    l_rec = torch.abs(pred - f_mid).mean()
    warp1 = backward_warp(f2, f01)
    warp0 = backward_warp(f0, f10)
    l_photo = 0.5 * (torch.abs(warp1 - f0).mean()
                     + torch.abs(warp0 - f2).mean())
    l_smooth = 0.5 * (_smoothness(f01) + _smoothness(f10))
    total = l_rec + cfg.w_photo * l_photo + cfg.w_smooth * l_smooth
    return total, {"loss/rec": l_rec, "loss/photo": l_photo,
                   "loss/smooth": l_smooth, "loss/total": total}


def make_flow_train_step(cfg: FlowConfig) -> Callable:
    """``train_step(state, batch) -> metrics`` on ``{"frames": (B, 3, H,
    W, 3)}``, uint8 (divided by 255) or float in [0, 1], on the model's
    device."""

    def train_step(state: FlowTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        frames = batch["frames"]
        triplet = frames.float()
        if not frames.is_floating_point():              # uint8 windows
            triplet = triplet / 255.0
        _, metrics = flow_loss(state.model, triplet, cfg)
        grads = torch.autograd.grad(metrics["loss/total"], state.opt.params,
                                    materialize_grads=True)
        metrics["grad_norm"] = state.opt.step(grads)
        metrics["notfinite"] = state.opt.notfinite_count.float()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step
