"""VGG-Face, the alternate perceptual backbone, of the PyTorch port
against the JAX package's on the CPU at 64×96 (test_torch_backbones.py's
tests and tolerances; its ``.pth`` is in Oxford's naming with fc6 a 4-D
7×7 conv), and its loader on the torchvision-remapped schema too."""

import numpy as np
import pytest

from test_torch_backbones import (_leaves, case,  # noqa: F401
                              test_loader_matches_jax,
                              test_perceptual_loss_matches_jax,
                              test_require_pretrained_names_the_network,
                              test_taps_match_jax)
from _torch_parity import single_thread  # noqa: F401
from renderloom_torch.models import backbones as TB


@pytest.fixture(scope="module", params=["vgg_face_dag"])
def net(request):
    return request.param


def test_loader_reads_the_torchvision_schema(case):
    """The ``.npz`` in the torchvision-remapped schema (``features.N``,
    ``classifier.{0,3,6}``, which JAX's own loader reads the same way,
    tests/test_backbones.py): the port's loader gives the variables the
    files were written from, as it does from the Oxford-named ``.pth``
    (:func:`test_loader_matches_jax`)."""
    state = TB.read_state(case["npz"])
    assert "classifier.0.weight" in state and "fc6.weight" not in state
    got = dict(_leaves(TB.load_vgg_face_state(state)))
    source = dict(_leaves(case["variables"]))
    assert got.keys() == source.keys()
    for k in source:
        np.testing.assert_array_equal(got[k], source[k], err_msg=k)
