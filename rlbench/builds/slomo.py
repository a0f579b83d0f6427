"""Render-In-Between's serving pipeline with Super SloMo (arXiv:1712.00080)
as its background interpolator: hsm's motion transformer and
pose-guided generator, and the flow and arbitrary-time U-Nets at their
published widths in place of Lucas-Kanade.  The configuration's
``slomo`` section holds the U-Nets' widths, kernels, slope and mean.
It serves only: the training functions raise.

The program side goes through ``renderloom_torch``'s ``build_pipeline``
(``slomo_cfg``, ``slomo_params``); the reference side composes
``rlbench.reference.eval.slomo_pipeline`` from hsm's reference stages
and ``rlbench.reference.models.superslomo``.  :func:`unet_flops`
counts the two U-Nets' direct-convolution FLOPs at a configuration's
shapes, as ``rlbench.drive.FlopCount`` prices the reference's.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from rlbench import port, refrun
from rlbench.builds import hsm

FLOW_IO, TIME_IO = (6, 4), (20, 5)


def program_serving(config: dict, traffic: dict, trees: Dict, stats,
                    device) -> Callable:
    """``build_pipeline``'s callable with Super SloMo's backgrounds."""
    from renderloom_torch.core.config import slomo_config_from_dict
    from renderloom_torch.eval.pipeline import build_pipeline
    mcfg, rcfg = port.configs(config)
    fn, _, _ = build_pipeline(
        mcfg, rcfg, traffic["rate"], traffic["keyframes"],
        m_params=trees["motion"][0], g_params=trees["gen"][0],
        g_stats=trees["gen"][1], mean=stats[0], std=stats[1],
        device=device, fastpath=config["fastpath"],
        slomo_cfg=slomo_config_from_dict(config["slomo"]),
        slomo_params=trees["slomo"][0])
    return fn


def program_training(config: dict, trees: Dict, seed: int, device):
    raise NotImplementedError("slomo serves only; it has no training cell")


def reference_serving(config: dict, traffic: dict, trees: Dict, stats,
                      device) -> Callable:
    """``fn(motion, conf, keys) -> fused`` over N clips, clip by clip."""
    from rlbench.reference.convert import load_flax_params
    from rlbench.reference.eval.motion_infer import make_interpolator
    from rlbench.reference.eval.slomo_pipeline import make_pipeline_fn
    from rlbench.reference.models.superslomo import SuperSloMo
    from rlbench.reference.train.gan import (make_inference_pair,
                                             make_segment_rollout)
    mcfg, rcfg = refrun.configs(config)
    rate, K = traffic["rate"], traffic["keyframes"]
    interp = make_interpolator(mcfg, trees["motion"][0], *stats, device)
    gen = make_inference_pair(rcfg, trees["gen"][0], trees["gen"][1],
                              device)
    slomo = load_flax_params(SuperSloMo(config["slomo"]),
                             trees["slomo"][0]).to(device).eval()
    pipe = make_pipeline_fn(interp, make_segment_rollout(gen, rate), slomo,
                            rcfg.data, rate, K)

    def fn(motion, conf, keys):
        return torch.cat([pipe(motion[i:i + 1], conf[i:i + 1],
                               keys[i:i + 1])
                          for i in range(motion.shape[0])])
    return fn


def reference_training(config: dict, trees: Dict, seed: int, device):
    raise NotImplementedError("slomo serves only; it has no training cell")


def specs(config: dict, kind: str) -> Dict:
    """hsm's serving trees (``gen``, ``motion``), then ``slomo``'s."""
    if kind != "serve":
        raise NotImplementedError("slomo serves only; it has no training "
                                  "cell")
    from rlbench.reference.models.superslomo import SuperSloMo
    from rlbench.weights import tree_spec
    out = hsm.specs(config, kind)
    with torch.device("meta"):
        out["slomo"] = tree_spec(SuperSloMo(config["slomo"]))
    return out


def _unet(cin: int, cout: int, h: int, w: int, widths, kernels) -> int:
    """Direct-convolution FLOPs (2 a multiply-add, bias not counted) of
    one U-Net image at h × w."""
    c, k = list(widths), list(kernels)
    conv = lambda ci, co, kk, s: 2 * ci * co * kk * kk * (h >> s) * (w >> s)
    total = conv(cin, c[0], k[0], 0) + conv(c[0], c[0], k[0], 0)
    for lvl in range(1, 6):
        total += conv(c[lvl - 1], c[lvl], k[lvl], lvl)
        total += conv(c[lvl], c[lvl], k[lvl], lvl)
    for lvl in range(4, -1, -1):
        total += conv(c[lvl + 1], c[lvl], 3, lvl)
        total += conv(2 * c[lvl], c[lvl], 3, lvl)
    return total + conv(c[0], cout, 3, 0)


def unet_flops(config: dict, traffic: dict) -> Dict[str, int]:
    """The two U-Nets' FLOPs at the configuration's frame size for one
    request of ``traffic``: ``flow_net`` (a call a keyframe pair),
    ``time_net`` (a call a pair and in-between time), ``per_frame`` (both
    over the request's output frames)."""
    data, s = config["renderer"]["data"], config["slomo"]
    h, w = data["model_height"], data["model_width"]
    clips, K, rate = (traffic["clips_per_request"], traffic["keyframes"],
                      traffic["rate"])
    pairs = clips * (K - 1)
    flow = pairs * _unet(*FLOW_IO, h, w, s["widths"], s["kernels"])
    time = pairs * (rate - 1) * _unet(*TIME_IO, h, w, s["widths"],
                                      s["kernels"])
    frames = clips * ((K - 1) * rate + 1)
    return {"flow_net": flow, "time_net": time,
            "per_frame": (flow + time) / frames}
