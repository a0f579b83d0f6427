"""The PyTorch port's serving pipeline against the JAX pipeline on the
CPU: ``make_pipeline_fn`` at 64×96, rate 2, 3 keyframes, 2 clips, with
the same numpy-seeded motion and generator weights.

Tolerance 1e-4 on the fused frames (values in [-1, 1]): float32 through
the motion transformer, LK flow, the raster and a two-step generator
rollout, each summed in another order than XLA's.
"""

import jax.numpy as jnp
import numpy as np
import torch

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import (blobs, generator_trees, motion_cfg,  # noqa: F401
                           motion_tree, renderer_cfg, single_thread, t)
from renderloom.eval.pipeline import build_pipeline as jax_build_pipeline
from renderloom_torch.eval.pipeline import build_pipeline
from renderloom_torch.ops.image import separable_resize

H, W = 64, 96
RATE, K, N = 2, 3, 2


def test_pipeline_matches_jax_cpu_pipeline():
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

    jfn, jm_params, jg = jax_build_pipeline(
        jm, jr, RATE, K, m_params=m_params, g_params=g_params,
        g_stats=g_stats, mean=mean, std=std, platform="cpu")
    want, _ = jfn(jm_params, jg, jnp.asarray(motion), jnp.asarray(conf),
                  jnp.asarray(keys))

    fn, _, _ = build_pipeline(motion_cfg(TC), renderer_cfg(TC, H, W), RATE,
                              K, m_params=m_params, g_params=g_params,
                              g_stats=g_stats, mean=mean, std=std,
                              device="cpu")
    got, sync = fn(t(motion), t(conf), t(keys))
    L = (K - 1) * RATE + 1
    assert got.shape == (N, L, H, W, 3)
    assert np.isfinite(got.numpy()).all() and np.isfinite(float(sync))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # keyframes pass through exactly, as [-1, 1] images
    np.testing.assert_allclose(got[:, ::RATE].numpy(), keys * 255.0 / 127.5
                               - 1.0, atol=1e-6)


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
