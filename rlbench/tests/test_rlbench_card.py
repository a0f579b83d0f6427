"""On the card, at the cell's own size: the program comes out correct
and the control (the reference one precision below the configuration's
in the program's place) does not.  Skips without a CUDA device."""

import time

import pytest

from rlbench import refrun, serve, spec, train

SEED = 2 ** 31 + 29
CELLS = ["hsm_fastpath_bf16.single", "hsm_standard_f32.single",
         "hsm_standard_f32.train"]


def _run(name, device, program=None):
    cell = spec.cell(name)
    loop = train if cell["traffic"]["kind"] == "train" else serve
    return loop.run(cell, SEED, 3.0, False, device, time.perf_counter(),
                    program=program)


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct_and_control_is_not(name, card):
    cell = spec.cell(name)
    assert _run(name, card)["correct"]
    mode = refrun.control_mode(cell["config"])
    control = (refrun.training_control(mode)
               if cell["traffic"]["kind"] == "train"
               else refrun.serving_control(mode))
    assert not _run(name, card, control)["correct"]
