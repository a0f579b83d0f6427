"""The PyTorch port's inference rollouts (``renderloom_torch/train/gan.py``:
``make_rollout``, ``rollout_chunked``, ``make_segment_rollout``,
``segment_rollout_chunked``) against the JAX package's, and against
each other, on the same numpy-seeded tiny generator.

Tolerances: 1e-4 against JAX in float32 (the tiny-width generator
through up to three sequential steps, convolutions summed in another
order than XLA's, as tests/test_torch_renderer.py holds one step).
Between the port's own rollouts: 1e-5 in float32, where only the
batch the frames ride in differs (JAX documents ``make_rollout`` and
``make_segment_rollout`` as equal per frame up to reduction order);
in bfloat16 the bits, since on the CPU the twins and convolutions give
each batch element the same bits whatever the batch, and a chunk of a
clip is the same computation as the clip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import (generator_trees, renderer_cfg,  # noqa: F401
                           single_thread, t)
from renderloom.train import gan as JG
from renderloom_torch.train import gan as TG

H, W = 32, 48
RATE = 2


@pytest.fixture(scope="module")
def trees():
    return generator_trees(renderer_cfg(JC, H, W), H, W, seed=6)


def _batch(L, seed=0, B=1):
    rng = np.random.default_rng(seed)
    return {"label": rng.uniform(-1, 1, (B, L, H, W, 22)),
            "back": rng.uniform(-1, 1, (B, L, H, W, 3)),
            "key_img": rng.uniform(-1, 1, (B, L, H, W, 3))}


def _np32(batch):
    return {k: np.asarray(v, np.float32) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_gen(trees):
    """The JAX standard inference generator (the CPU's default: no fast
    path) and its folded weights."""
    return JG.make_inference_pair(renderer_cfg(JC, H, W), *trees)


def _port_gen(trees, dtype="float32", fastpath=False):
    cfg = dataclasses.replace(renderer_cfg(TC, H, W), compute_dtype=dtype)
    return TG.make_inference_pair(cfg, *trees, "cpu", fastpath=fastpath)


# a clip whose keyframes are not periodic, ending on a generated frame
IS_KEY = np.array([1, 0, 0, 1, 0, 1, 0, 0], bool)


@pytest.fixture(scope="module")
def jax_sequential(jax_gen):
    """The JAX ``make_rollout`` and ``rollout_chunked`` (chunk 3: a
    boundary inside a run of generated frames, the last chunk padded) on
    one clip."""
    gen, folded = jax_gen
    batch = _np32(_batch(len(IS_KEY), seed=1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["is_key"] = jnp.asarray(IS_KEY)
    rollout = JG.make_rollout(gen, renderer_cfg(JC, H, W))
    whole = rollout(folded, {}, jb)
    chunked = JG.rollout_chunked(rollout, folded, {}, jb, chunk=3)
    return batch, [np.asarray(a) for a in whole + chunked]


def test_make_rollout_matches_jax(trees, jax_sequential):
    batch, (want_f, want_m, _, _) = jax_sequential
    tb = {k: t(v) for k, v in batch.items()}
    tb["is_key"] = torch.from_numpy(IS_KEY)
    with torch.no_grad():
        fused, masks = TG.make_rollout(_port_gen(trees))(tb)
    assert fused.shape == (1, len(IS_KEY), H, W, 3)
    assert masks.shape == (1, len(IS_KEY), H, W, 1)
    np.testing.assert_allclose(fused.numpy(), want_f, atol=1e-4)
    np.testing.assert_allclose(masks.numpy(), want_m, atol=1e-4)
    # keyframes pass through with a zero mask
    np.testing.assert_array_equal(fused[:, IS_KEY].numpy(),
                                  batch["key_img"][:, IS_KEY])
    assert not masks[:, IS_KEY].any()


def test_rollout_chunked_matches_jax(trees, jax_sequential):
    batch, (_, _, want_f, want_m) = jax_sequential
    tb = {k: t(v) for k, v in batch.items()}
    tb["is_key"] = torch.from_numpy(IS_KEY)
    with torch.no_grad():
        fused, masks = TG.rollout_chunked(TG.make_rollout(_port_gen(trees)),
                                          tb, chunk=3)
    np.testing.assert_allclose(fused.numpy(), want_f, atol=1e-4)
    np.testing.assert_allclose(masks.numpy(), want_m, atol=1e-4)


def test_segment_rollout_chunked_matches_jax(trees, jax_gen):
    """Three segments in chunks of two: JAX pads the last chunk by the
    clip's final frame and cuts it back, the port runs it at its own
    length."""
    gen, folded = jax_gen
    S = 3
    batch = _np32(_batch(S * RATE + 1, seed=2))
    seg = JG.make_segment_rollout(gen, renderer_cfg(JC, H, W), RATE)
    want = JG.segment_rollout_chunked(
        seg, folded, {}, {k: jnp.asarray(v) for k, v in batch.items()},
        RATE, seg_chunk=2)
    with torch.no_grad():
        got = TG.segment_rollout_chunked(
            TG.make_segment_rollout(_port_gen(trees), RATE),
            {k: t(v) for k, v in batch.items()}, RATE, seg_chunk=2)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("fastpath", [False, True],
                         ids=["standard", "fastpath"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rollouts_agree_with_each_other(trees, dtype, fastpath):
    """On a clip of whole segments (keyframes every ``RATE`` frames),
    with either generator in either compute dtype: the sequential
    rollout equals the segment rollout, and each equals its chunked
    form (a chunk boundary inside a segment; a short last segment
    chunk)."""
    gen = _port_gen(trees, dtype, fastpath)
    S = 3
    L = S * RATE + 1
    tb = {k: t(v) for k, v in _np32(_batch(L, seed=3, B=2)).items()}
    is_key = torch.arange(L) % RATE == 0
    seq = TG.make_rollout(gen)
    seg = TG.make_segment_rollout(gen, RATE)
    with torch.no_grad():
        want = seg(tb)
        outs = {"sequential": seq({**tb, "is_key": is_key}),
                "sequential chunked": TG.rollout_chunked(
                    seq, {**tb, "is_key": is_key}, chunk=3),
                "segment chunked": TG.segment_rollout_chunked(
                    seg, tb, RATE, seg_chunk=2)}
    assert want[0].dtype == torch.float32      # the float32 carry
    assert want[1].dtype == getattr(torch, dtype)
    atol = 1e-5 if dtype == "float32" else 0.0
    for name, got in outs.items():
        for g, w in zip(got, want):
            assert g.dtype == w.dtype, name
            torch.testing.assert_close(g, w, rtol=0, atol=atol, msg=name)
