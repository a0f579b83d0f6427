"""Motion upsampling of the PyTorch port against the JAX package, on the
same numpy-seeded weights: pose ops, the motion transformer and
``MotionInterpolator._run`` (batched over clips here, vmapped in JAX).

Tolerances: 1e-6 for the pose ops (the same float32 arithmetic), 1e-4
for the transformer and the interpolator (float32 matmuls through 4
layers; joints are O(1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import motion_cfg, motion_tree, single_thread, t  # noqa: F401
from renderloom.eval.motion_infer import MotionInterpolator as JInterp
from renderloom.eval.motion_infer import bucket_length
from renderloom.models.motion_transformer import (build_motion_model,
                                                  sine_position_encoding)
from renderloom.ops import pose as JP
from renderloom_torch import convert
from renderloom_torch.eval.motion_infer import MotionInterpolator
from renderloom_torch.models import motion_transformer as TM
from renderloom_torch.ops import pose as TP


@pytest.fixture(scope="module")
def params():
    return motion_tree(motion_cfg(JC))


def _model(params):
    m = TM.build_motion_model(motion_cfg(TC))
    return convert.load_flax_params(m, params).eval()


def test_pose_ops_match_jax():
    rng = np.random.default_rng(0)
    clip = rng.normal(size=(19, 2, 5)).astype(np.float32)
    conf = rng.uniform(size=(19, 1, 5)).astype(np.float32)
    mean = rng.normal(size=(19, 2)).astype(np.float32)
    std = rng.uniform(0.5, 2, (19, 2)).astype(np.float32)
    loc = TP.localize(t(clip), TP.ROOT_2D)
    np.testing.assert_allclose(
        loc.numpy(), np.asarray(JP.localize(jnp.asarray(clip), JP.ROOT_2D)),
        atol=1e-6)
    np.testing.assert_allclose(TP.globalize(loc, TP.ROOT_2D).numpy(), clip,
                               atol=1e-6)
    np.testing.assert_allclose(
        TP.normalize(t(clip), t(mean), t(std)).numpy(),
        np.asarray(JP.normalize(jnp.asarray(clip), jnp.asarray(mean),
                                jnp.asarray(std))), atol=1e-6)
    mask = np.array([0, 0, 1, 0, 1], bool)
    got = TP.interpolate_frames(t(clip), t(mask), t(conf), times=2)
    want = JP.interpolate_frames(jnp.asarray(clip), jnp.asarray(mask),
                                 jnp.asarray(conf), times=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    pad = np.arange(17) >= 13
    np.testing.assert_array_equal(
        TP.encoder_mask_from_pad(t(pad), 4).numpy(),
        np.asarray(JP.encoder_mask_from_pad(jnp.asarray(pad), 4)))


def test_sine_position_encoding_matches_jax():
    lengths = np.array([9, 13])
    got = TM.sine_position_encoding(2, 17, 32, lengths=t(lengths))
    want = sine_position_encoding(2, 17, 32, lengths=jnp.asarray(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_transformer_matches_jax(params):
    rng = np.random.default_rng(1)
    B, L, rate = 2, 17, 4
    src = rng.normal(size=(B, L, 38)).astype(np.float32)
    tgt = rng.normal(size=(B, L, 38)).astype(np.float32)
    pad = np.zeros((B, L), bool)
    pad[1, 13:] = True
    enc = (np.arange(L) % rate != 0)[None] | pad
    lengths = np.array([17, 13])
    want = build_motion_model(motion_cfg(JC)).apply(
        {"params": params}, jnp.asarray(src), jnp.asarray(enc),
        jnp.asarray(tgt), jnp.asarray(pad), rate,
        lengths=jnp.asarray(lengths))
    with torch.no_grad():
        got = _model(params)(t(src), t(enc), t(tgt), t(pad), rate,
                             lengths=t(lengths))
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_interpolator_run_matches_jax(params):
    rng = np.random.default_rng(2)
    N, K, rate = 2, 3, 4
    times = 2
    L = (K - 1) * rate + 1
    pad_to = bucket_length(L, rate)
    motion = rng.uniform(-0.4, 0.4, (N, 19, 2, K)).astype(np.float32)
    conf = rng.uniform(0.5, 1, (N, 19, 1, K)).astype(np.float32)
    mean = rng.normal(scale=0.1, size=(19, 2)).astype(np.float32)
    std = rng.uniform(0.5, 2, (19, 2)).astype(np.float32)
    jcfg = motion_cfg(JC)
    ji = JInterp(build_motion_model(jcfg), params, jcfg, mean, std)
    want = jax.vmap(lambda m, c: ji._run(params, m, c, rate, times,
                                         pad_to))(jnp.asarray(motion),
                                                  jnp.asarray(conf))
    ti = MotionInterpolator(_model(params), mean, std, "cpu")
    with torch.no_grad():
        got = ti._run(t(motion), t(conf), rate, times, pad_to)
    assert got[0].shape == (N, 19, 2, pad_to)
    assert got[2].shape == (N, 19, 1, L)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
