"""The PyTorch port's serving pipeline against the JAX pipeline on the
CPU: ``make_pipeline_fn`` at 64×96, rate 2, 3 keyframes, 2 clips, with
the same numpy-seeded motion and generator weights, in float32 and in
bfloat16 compute (both configs' ``compute_dtype: bfloat16``): the
standard configuration (the JAX ``platform="cpu"`` pipeline) and
``fastpath=True`` (the JAX ``platform="tpu"`` pipeline that
``bench.py`` serves, its Pallas norm in interpret mode).

Tolerances: float32, 1e-4 on the fused frames (values in [-1, 1]):
float32 through the motion transformer, LK flow, the raster and a
two-step generator rollout, each summed in another order than XLA's.
bf16, those of tests/test_torch_bf16.py on its models
(``_torch_parity.hold_bf16``): the fused frames' mean |port − JAX bf16|
within 2e-2 (the port as it is reads 1.51e-2 standard, 1.50e-2
fastpath), and their largest error against the JAX float32 pipeline
at most 1.5× the JAX bf16 pipeline's own plus 1e-3 (the float32
reference is the standard pipeline's: the fast path computes the same
function); keyframes pass through exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import (bf16, blobs, generator_trees,  # noqa: F401
                           hold_bf16, motion_cfg, motion_tree, renderer_cfg,
                           single_thread, t)
from renderloom.eval.pipeline import build_pipeline as jax_build_pipeline
from renderloom_torch.eval.pipeline import build_pipeline
from renderloom_torch.models.fastpath import FastInferenceGen
from renderloom_torch.ops.image import separable_resize

H, W = 64, 96
RATE, K, N = 2, 3, 2
L = (K - 1) * RATE + 1


def _jax_fused(mcfg, rcfg, weights, inputs, platform):
    fn, mp, gp = jax_build_pipeline(mcfg, rcfg, RATE, K, platform=platform,
                                    **weights)
    return np.asarray(fn(mp, gp, *map(jnp.asarray, inputs))[0])


@pytest.fixture(scope="module")
def case():
    """Weights, inputs and the JAX float32 pipeline's frames on them."""
    jm, jr = motion_cfg(JC), renderer_cfg(JC, H, W)
    m_params = motion_tree(jm, seed=3)
    g_params, g_stats = generator_trees(jr, H, W, seed=4)

    rng = np.random.default_rng(0)
    # joints in normalized units (pixel = x·256 + 256), and statistics
    # that keep the random transformer's output inside the 96×64 frame:
    # a root (the last localized row) near pixel (51, 38) and limbs within
    # a few tens of pixels of it, so the labels hold skeletons
    motion = np.stack([rng.uniform(-0.9, -0.7, (N, 19, K)),
                       rng.uniform(-0.9, -0.8, (N, 19, K))], axis=2)
    motion = motion.astype(np.float32)
    conf = np.full((N, 19, 1, K), 0.9, np.float32)
    keys = np.stack([blobs(K, H, W, seed=s) for s in range(N)])
    mean = np.zeros((19, 2), np.float32)
    mean[-1] = (-0.8, -0.85)
    std = np.full((19, 2), 0.02, np.float32)
    weights = dict(m_params=m_params, g_params=g_params, g_stats=g_stats,
                   mean=mean, std=std)
    inputs = (motion, conf, keys)
    return weights, inputs, _jax_fused(jm, jr, weights, inputs, "cpu")


def _assert_keyframes_pass(got, keys):
    """Keyframes pass through exactly, as [-1, 1] images."""
    np.testing.assert_allclose(got[:, ::RATE].numpy(), keys * 255.0 / 127.5
                               - 1.0, atol=1e-6)


def test_pipeline_matches_jax_cpu_pipeline(case):
    weights, inputs, want = case
    fn, _, _ = build_pipeline(motion_cfg(TC), renderer_cfg(TC, H, W), RATE,
                              K, device="cpu", **weights)
    got, sync = fn(*map(t, inputs))
    assert got.shape == (N, L, H, W, 3)
    assert np.isfinite(got.numpy()).all() and np.isfinite(float(sync))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    _assert_keyframes_pass(got, inputs[2])


@pytest.mark.parametrize("fastpath", [False, True],
                         ids=["standard", "fastpath"])
def test_pipeline_bf16_matches_jax(monkeypatch, case, fastpath):
    weights, inputs, want_f32 = case
    if fastpath:
        monkeypatch.setenv("RENDERLOOM_PACKED_LEVELS", "2")
        monkeypatch.setenv("RENDERLOOM_PALLAS_NORM", "1")
    want = _jax_fused(bf16(motion_cfg(JC)), bf16(renderer_cfg(JC, H, W)),
                      weights, inputs, "tpu" if fastpath else "cpu")
    fn, m_model, gen = build_pipeline(
        bf16(motion_cfg(TC)), bf16(renderer_cfg(TC, H, W)), RATE, K,
        device="cpu", fastpath=fastpath, **weights)
    assert isinstance(gen, FastInferenceGen) == fastpath
    assert gen.dtype == m_model.dtype == torch.bfloat16
    got, _ = fn(*map(t, inputs))
    assert got.shape == (N, L, H, W, 3) and np.isfinite(got.numpy()).all()
    hold_bf16("fused frames", got, want, want_f32, 2e-2)
    _assert_keyframes_pass(got, inputs[2])


def test_src_size_ingest_resizes_keyframes_once():
    """Keyframes at another resolution (``src_size``) are resized at
    ingest by the separable resize (held against JAX in
    test_torch_flow.py); the rest of the pipeline then sees model-size
    frames."""
    motion = np.full((1, 19, 2, K), -0.8, np.float32)
    conf = np.full((1, 19, 1, K), 0.9, np.float32)
    keys_src = blobs(K, 2 * H, 2 * W)[None]
    tcfg = (motion_cfg(TC), renderer_cfg(TC, H, W), RATE, K)
    fn_src, _, _ = build_pipeline(*tcfg, src_size=(2 * H, 2 * W),
                                  device="cpu")
    fn, _, _ = build_pipeline(*tcfg, device="cpu")
    got, _ = fn_src(t(motion), t(conf), t(keys_src))
    want, _ = fn(t(motion), t(conf), separable_resize(t(keys_src), H, W))
    assert got.shape == (1, (K - 1) * RATE + 1, H, W, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
