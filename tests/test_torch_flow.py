"""Flow backgrounds and image ops of the PyTorch port against the JAX
package: ``upsample_background(levels=3, iters=1, flow_scale=4)`` as the
serving pipeline calls it, with its defaults (full-resolution flow) as
the serving CLIs call it, and the pieces it is built from.

Tolerances: 1e-5 for single ops on values in [0, 1] or pixel units;
1e-4 for the whole background synthesis (float32 cumulative sums in the
LK box filter and three pyramid levels of solves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import blobs, single_thread, t  # noqa: F401
from renderloom.ops import flow as JF
from renderloom.ops import image as JI
from renderloom_torch.ops import flow as TF
from renderloom_torch.ops import image as TI


@pytest.mark.parametrize("size", [(16, 24), (128, 192)])
def test_resize_bilinear_matches_jax_image_resize(size):
    x = blobs(2, 64, 96)
    want = jax.image.resize(jnp.asarray(x), (2,) + size + (3,), "bilinear")
    np.testing.assert_allclose(TI.resize_bilinear(t(x), *size).numpy(),
                               np.asarray(want), atol=1e-5)


def test_separable_resize_matches_jax():
    x = blobs(2, 48, 72) * 255
    want = JI.separable_resize(jnp.asarray(x), 32, 48)
    np.testing.assert_allclose(TI.separable_resize(t(x), 32, 48).numpy(),
                               np.asarray(want), atol=1e-3)   # [0, 255]


def test_warps_and_lk_match_jax():
    x = blobs(2, 32, 48)
    rng = np.random.default_rng(1)
    flow = rng.uniform(-3, 3, (32, 48, 2)).astype(np.float32)
    np.testing.assert_allclose(
        TF.backward_warp_shift(t(x[:1]), t(flow[None]), 2).numpy()[0],
        np.asarray(JF.backward_warp_shift(jnp.asarray(x[0]),
                                          jnp.asarray(flow), 2)), atol=1e-5)
    np.testing.assert_allclose(
        TF.backward_warp(t(x[:1]), t(flow[None])).numpy()[0],
        np.asarray(JF.backward_warp(jnp.asarray(x[0]), jnp.asarray(flow))),
        atol=1e-5)
    want = JF.estimate_flow(jnp.asarray(x[0]), jnp.asarray(x[1]), 3, 1)
    got = TF.estimate_flow(t(x[:1]), t(x[1:]), 3, 1)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# the serving pipeline's setting, and the JAX default the CLIs use
@pytest.mark.parametrize("flow", [dict(levels=3, iters=1, flow_scale=4), {}])
def test_upsample_background_matches_jax(flow):
    keys = blobs(3, 64, 96, seed=2)
    want = JF.upsample_background(jnp.asarray(keys), 4, **flow)
    got = TF.upsample_background(t(keys), 4, **flow)
    assert got.shape == (9, 64, 96, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(got[::4].numpy(), keys)
