"""The harness at a test's size on the CPU, its look for a card
skipped: a sound program comes out correct; the control (the reference
one precision below in the program's place) and each fault planted in
the timed path come out not correct."""

import time

import pytest
import torch

from rlbench import port, refrun, serve, train

from conftest import tiny_cell

SEED = 2 ** 31 + 17


def _serve(name, program=None, limits=None):
    cell = tiny_cell(name)
    if limits:
        cell["check"]["limits"] = limits
    return serve.run(cell, SEED, 0.5, False, torch.device("cpu"),
                     time.perf_counter(), program=program)


def _train(program=None, limits=None):
    cell = tiny_cell("hsm_standard_f32.train")
    cell["check"]["limits"].update(limits or {})
    return train.run(cell, SEED, 0.5, False, torch.device("cpu"),
                     time.perf_counter(), program=program)


def altered_frame(config, traffic, trees, stats, device):
    fn = port.serving(config, traffic, trees, stats, device)

    def broken(*inputs):
        fused, sync = fn(*inputs)
        fused = fused.clone()
        fused[:, 1] = 1.0 - fused[:, 1]     # one frame of each clip
        return fused, sync
    return broken


def half_the_clips(config, traffic, trees, stats, device):
    fn = port.serving(config, traffic, trees, stats, device)

    def broken(motion, conf, keys):
        half = max(motion.shape[0] // 2, 1)
        fused, sync = fn(motion[:half], conf[:half], keys[:half])
        return fused.repeat(motion.shape[0] // half, 1, 1, 1, 1), sync
    return broken


@pytest.mark.parametrize("name", ["hsm_standard_f32.single",
                                  "hsm_fastpath_bf16.batch8"])
def test_sound_serving_is_correct(name):
    res = _serve(name)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("fault", [altered_frame, half_the_clips])
def test_serving_faults_are_caught(fault):
    res = _serve("hsm_fastpath_bf16.batch8", fault)
    assert not res["correct"], res["check"]


def test_serving_control_is_caught():
    cell = "hsm_standard_f32.single"
    res = _serve(cell, refrun.serving_control("tf32"))
    assert not res["correct"], res["check"]
    res = _serve("hsm_fastpath_bf16.single", refrun.serving_control("fp8"))
    assert not res["correct"], res["check"]


def unchanged_state(config, trees, seed, device):
    state, step = port.training(config, trees, seed, device)

    def broken(st, batch):
        keep = lambda sd: {k: v.clone() for k, v in sd.items()}
        saved = [keep(x.state_dict()) for x in (st.gen, st.dis, st.opt_g,
                                                st.opt_d)]
        metrics = step(st, batch)
        for x, sd in zip((st.gen, st.dis, st.opt_g, st.opt_d), saved):
            x.load_state_dict(sd)
        return metrics
    return state, broken


def half_the_batch(config, trees, seed, device):
    state, step = port.training(config, trees, seed, device)

    def broken(st, batch):
        half = batch["images"].shape[0] // 2
        return step(st, {k: v[:half] for k, v in batch.items()})
    return state, broken


def test_sound_training_is_correct():
    # the median leaf's change after three steps is the cell's number
    # with most room at full size (1.9e-3 against 7e-3); at this size a
    # leaf holds about a hundredth of the elements, so the ±lr moves
    # AMSGrad makes of round-off weigh more in its norm (2.0e-2 here)
    res = _train(limits={"median_change_gap": 0.05})
    assert res["correct"], res["check"]


@pytest.mark.parametrize("fault", [unchanged_state, half_the_batch])
def test_training_faults_are_caught(fault):
    res = _train(fault)
    assert not res["correct"], res["check"]


def test_training_control_is_caught():
    res = _train(refrun.training_control("tf32"))
    assert not res["correct"], res["check"]
