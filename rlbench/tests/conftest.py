"""Shared fixtures of the benchmark's CPU tests: cells cut to a size a
test run holds (64×96 frames, narrow generator), on the CPU."""

from __future__ import annotations

import copy
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from rlbench import spec  # noqa: E402


def tiny_cell(name: str) -> dict:
    """The cell ``name`` at 64×96 with a narrow generator; serving mixes
    send 2 clips of 3 keyframes at most, training takes batch 2 × 4
    frames (the 8×8 hand crops take one hand layer fewer)."""
    c = copy.deepcopy(spec.cell(name))
    r = c["config"]["renderer"]
    for k in ("model_height", "load_height"):
        r["data"][k] = 64
    for k in ("model_width", "load_width"):
        r["data"][k] = 96
    for sub in (r["gen"], r["gen"]["mask"], r["gen"]["embed"]):
        sub["num_filters"], sub["max_num_filters"] = 4, 32
    if c["traffic"]["kind"] == "train":
        r["batch_size"], r["data"]["max_frames"] = 2, 4
        r["dis"]["additional_discriminators"]["hand"]["num_layers"] = 2
        r["dis"]["image"]["max_num_filters"] = 64
    else:
        c["traffic"]["clips_per_request"] = min(
            2, c["traffic"]["clips_per_request"])
        c["traffic"]["keyframes"] = 3
        c["traffic"]["warmup_requests"] = 1
    return c


@pytest.fixture
def cpu():
    return torch.device("cpu")


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
