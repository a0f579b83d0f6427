"""Render-In-Between's human synthesis model: the motion transformer,
Lucas-Kanade backgrounds and the pose-conditioned generator for
serving; the generator, its discriminators and VGG19 for training.
The program side goes through ``renderloom_torch``'s ``build_pipeline``,
``create_gan_state``, ``make_perceptual`` and ``make_gan_train_step``;
the reference side builds the same from ``rlbench.reference``."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from rlbench import port, refrun


def program_serving(config: dict, traffic: dict, trees: Dict, stats,
                    device) -> Callable:
    """``build_pipeline``'s callable ``fn(motion, conf, keys) -> (fused,
    sync)`` for the traffic's keyframes and rate."""
    from renderloom_torch.eval.pipeline import build_pipeline
    mcfg, rcfg = port.configs(config)
    fn, _, _ = build_pipeline(
        mcfg, rcfg, traffic["rate"], traffic["keyframes"],
        m_params=trees["motion"][0], g_params=trees["gen"][0],
        g_stats=trees["gen"][1], mean=stats[0], std=stats[1],
        device=device, fastpath=config["fastpath"])
    return fn


def program_training(config: dict, trees: Dict, seed: int, device):
    """``(state, step)``: ``create_gan_state`` from the trees, VGG19 from
    its tree, and ``make_gan_train_step`` on raw windows (the train-mode
    preparation runs inside the step)."""
    from renderloom_torch.train.gan import (create_gan_state,
                                            make_gan_train_step,
                                            make_perceptual)
    _, rcfg = port.configs(config)
    state = create_gan_state(rcfg, device, seed=seed, trees={
        "params_g": trees["gen"][0], "stats_g": trees["gen"][1],
        "params_d": trees["dis"][0], "stats_d": trees["dis"][1]})
    vgg = make_perceptual(rcfg, device, params=trees["vgg"][0])
    return state, make_gan_train_step(rcfg, vgg, data_cfg=rcfg.data)


def reference_serving(config: dict, traffic: dict, trees: Dict, stats,
                      device) -> Callable:
    """``fn(motion, conf, keys) -> fused`` over N clips: the reference
    pipeline (standard layout, float32 label), run clip by clip."""
    from rlbench.reference.eval.motion_infer import make_interpolator
    from rlbench.reference.eval.pipeline import make_pipeline_fn
    from rlbench.reference.train.gan import (make_inference_pair,
                                             make_segment_rollout)
    mcfg, rcfg = refrun.configs(config)
    rate, K = traffic["rate"], traffic["keyframes"]
    interp = make_interpolator(mcfg, trees["motion"][0], *stats, device)
    gen = make_inference_pair(rcfg, trees["gen"][0], trees["gen"][1],
                              device)
    pipe = make_pipeline_fn(interp, make_segment_rollout(gen, rate),
                            rcfg.data, rate, K)

    def fn(motion, conf, keys):
        return torch.cat([pipe(motion[i:i + 1], conf[i:i + 1],
                               keys[i:i + 1])[0]
                          for i in range(motion.shape[0])])
    return fn


def reference_training(config: dict, trees: Dict, seed: int, device):
    """``(state, step)``: the reference's train state from the trees and
    its multi-frame train step on raw windows."""
    from rlbench.reference.models.perceptual import PerceptualLoss
    from rlbench.reference.train.gan import (create_gan_state,
                                             make_gan_train_step)
    _, rcfg = refrun.configs(config)
    state = create_gan_state(rcfg, device, seed=seed, trees={
        "params_g": trees["gen"][0], "stats_g": trees["gen"][1],
        "params_d": trees["dis"][0], "stats_d": trees["dis"][1]})
    vgg = PerceptualLoss(rcfg.perceptual.layers, rcfg.perceptual.weights,
                         trees["vgg"][0]).to(device).eval()
    for p in vgg.parameters():
        p.requires_grad_(False)
    return state, make_gan_train_step(rcfg, vgg, data_cfg=rcfg.data)


def specs(config: dict, kind: str) -> Dict:
    """The weight trees' layouts a cell of ``kind`` needs, from the
    reference's modules on the ``meta`` device."""
    from rlbench.reference.models.discriminator import DiscriminatorSet
    from rlbench.reference.models.layers import enable_spectral_norm
    from rlbench.reference.models.motion_transformer import \
        build_motion_model
    from rlbench.reference.models.perceptual import VGG19Features
    from rlbench.reference.models.renderer import Generator
    from rlbench.weights import tree_spec
    mcfg, rcfg = refrun.configs(config)
    with torch.device("meta"):
        out = {"gen": tree_spec(enable_spectral_norm(Generator(rcfg.gen)))}
        if kind == "serve":
            out["motion"] = tree_spec(build_motion_model(mcfg))
        else:
            out["dis"] = tree_spec(enable_spectral_norm(
                DiscriminatorSet(rcfg.dis)))
            out["vgg"] = tree_spec(VGG19Features(rcfg.perceptual.layers))
    return out
