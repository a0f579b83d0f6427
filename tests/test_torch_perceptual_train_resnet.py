"""The renderer's GAN train step of the PyTorch port with the ResNet-50
perceptual backbone against the JAX package's: the tests and
tolerances of tests/test_torch_perceptual_train.py, on ResNet-50."""

import pytest

from _torch_parity import single_thread  # noqa: F401
from test_torch_perceptual_train import (steps,  # noqa: F401
                                         test_gradients_of_the_step_match_jax,
                                         test_metrics_match_jax,
                                         test_parameters_after_the_step_match_jax,
                                         trees)


@pytest.fixture(scope="module", params=["resnet50"])
def backbone(request):
    return request.param
