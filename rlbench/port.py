"""The system under test: ``renderloom_torch``'s serving pipeline and
renderer train step, built from a configuration file and the
benchmark's weight trees through the program's own entry points.
Nothing else of the program is used."""

from __future__ import annotations

from typing import Callable, Dict


def configs(config: dict):
    from renderloom_torch.core.config import (motion_config_from_dict,
                                              renderer_config_from_dict)
    return (motion_config_from_dict(config["motion"]),
            renderer_config_from_dict(config["renderer"]))


def serving(config: dict, traffic: dict, trees: Dict, stats, device
            ) -> Callable:
    """``build_pipeline``'s callable ``fn(motion, conf, keys) -> (fused,
    sync)`` for the traffic's keyframes and rate."""
    from renderloom_torch.eval.pipeline import build_pipeline
    mcfg, rcfg = configs(config)
    fn, _, _ = build_pipeline(
        mcfg, rcfg, traffic["rate"], traffic["keyframes"],
        m_params=trees["motion"][0], g_params=trees["gen"][0],
        g_stats=trees["gen"][1], mean=stats[0], std=stats[1],
        device=device, fastpath=config["fastpath"])
    return fn


def training(config: dict, trees: Dict, seed: int, device):
    """``(state, step)``: ``create_gan_state`` from the trees, VGG19 from
    its tree, and ``make_gan_train_step`` on raw windows (the train-mode
    preparation runs inside the step)."""
    from renderloom_torch.train.gan import (create_gan_state,
                                            make_gan_train_step,
                                            make_perceptual)
    _, rcfg = configs(config)
    state = create_gan_state(rcfg, device, seed=seed, trees={
        "params_g": trees["gen"][0], "stats_g": trees["gen"][1],
        "params_d": trees["dis"][0], "stats_d": trees["dis"][1]})
    vgg = make_perceptual(rcfg, device, params=trees["vgg"][0])
    return state, make_gan_train_step(rcfg, vgg, data_cfg=rcfg.data)
