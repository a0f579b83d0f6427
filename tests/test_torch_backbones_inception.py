"""Inception-v3, the alternate perceptual backbone, of the PyTorch port
against the JAX package's on the CPU at 96×128 (test_torch_backbones.py's
tests and tolerances), and its pool branches' border rule: JAX's
``count_include_pad=False`` average, which torchvision's Inception3 does
not use, held on an input whose borders carry most of the signal."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_backbones import (case, hold_taps,  # noqa: F401
                              port_module, test_loader_matches_jax,
                              test_perceptual_loss_matches_jax,
                              test_require_pretrained_names_the_network,
                              test_taps_match_jax)
from _torch_parity import single_thread  # noqa: F401
from renderloom_torch.models import backbones as TB


@pytest.fixture(scope="module", params=["inception_v3"])
def net(request):
    return request.param


def _counting_pads(x):
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), 3, 1, 1,
                     count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def test_pool_branches_do_not_count_the_padding(case, monkeypatch):
    """A bright frame around a dark image: the port's taps equal JAX's,
    and the same module with torchvision's counting pool (the padding's
    zeros averaged in) departs from them beyond the tolerance."""
    import jax

    x = np.full((2, 96, 128, 3), -2.0, np.float32)
    x[:, :12], x[:, -12:], x[:, :, :12], x[:, :, -12:] = 3.0, 3.0, 3.0, 3.0
    x += 0.05 * np.random.default_rng(3).normal(size=x.shape).astype(
        np.float32)
    jp = case["jax_loss"]
    want = jax.tree.map(np.asarray, jax.jit(jp.model.apply)(jp.variables, x))
    model = port_module("inception_v3")
    with torch.no_grad():
        hold_taps("inception_v3", model(torch.from_numpy(x)), want)
        monkeypatch.setattr(TB, "_avgpool3s1p1", _counting_pads)
        wrong = model(torch.from_numpy(x))
    with pytest.raises(AssertionError):
        hold_taps("inception_v3", wrong, want)
