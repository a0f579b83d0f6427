"""The frozen reference against the program at 64×96 on the CPU: the
same trees and inputs through both."""

import time

import pytest
import torch

from rlbench import port, refrun, train
from rlbench.traffic import serve_request, train_window
from rlbench.weights import make_trees, motion_stats

from conftest import tiny_cell

SEED = 2 ** 31 + 3


@pytest.mark.parametrize("name", ["hsm_standard_f32.single",
                                  "hsm_fastpath_bf16.batch8"])
def test_serving_reference_matches_the_program(name, cpu):
    cell = tiny_cell(name)
    config, traffic = cell["config"], cell["traffic"]
    trees = make_trees(refrun.specs(config, "serve"), SEED, cpu)
    stats = motion_stats()
    inputs = serve_request(traffic, (64, 96), SEED, 0, cpu)
    got, _ = port.serving(config, traffic, trees, stats, cpu)(*inputs)
    with torch.inference_mode(), refrun.precision("float32"):
        want = refrun.serving(config, traffic, trees, stats, cpu)(*inputs)
    N = traffic["clips_per_request"]
    assert got.shape == want.shape == (N, 9, 64, 96, 3)
    gap = (got.float() - want).abs()
    if config["renderer"]["compute_dtype"] == "float32":
        assert float(gap.max()) < 1e-4
    else:       # bf16 and the parity layout against float32
        assert float(gap.mean()) < 0.05


def test_training_reference_matches_the_program(cpu):
    cell = tiny_cell("hsm_standard_f32.train")
    config, traffic = cell["config"], cell["traffic"]
    r = config["renderer"]
    trees = make_trees(refrun.specs(config, "train"), SEED, cpu)
    windows = lambda s: train_window(traffic, 2, 4, (64, 96), SEED, s, cpu)
    got = train._readings(*port.training(config, trees, 5, cpu), windows, 2)
    want = train._readings(*refrun.training(config, trees, 5, cpu),
                           windows, 2)
    assert r["compute_dtype"] == "float32"
    gaps = train.compare(got, want)
    # the first step's losses and first gradients agree to rounding;
    # later numbers pass through AMSGrad's ±lr moves of round-off
    assert gaps["first_loss_gap"] < 1e-5
    assert gaps["g_first_grad_median_gap"] < 1e-3
    assert gaps["loss_gap"] < 5e-2
