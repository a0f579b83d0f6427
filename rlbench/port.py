"""The system under test: ``renderloom_torch``'s serving pipeline and
train step, built from a configuration file and the benchmark's weight
trees through the program's own entry points by the configuration's
build (:mod:`rlbench.builds`).  Nothing else of the program is used."""

from __future__ import annotations

from typing import Callable, Dict

from rlbench import builds


def configs(config: dict):
    from renderloom_torch.core.config import (motion_config_from_dict,
                                              renderer_config_from_dict)
    return (motion_config_from_dict(config["motion"]),
            renderer_config_from_dict(config["renderer"]))


def serving(config: dict, traffic: dict, trees: Dict, stats, device
            ) -> Callable:
    """The build's serving callable ``fn(motion, conf, keys) -> (fused,
    sync)`` for the traffic's keyframes and rate."""
    return builds.load(config).program_serving(config, traffic, trees,
                                               stats, device)


def training(config: dict, trees: Dict, seed: int, device):
    """The build's ``(state, step)`` on raw windows."""
    return builds.load(config).program_training(config, trees, seed,
                                                device)
