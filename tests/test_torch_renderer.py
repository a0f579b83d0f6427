"""Renderer of the PyTorch port against the JAX package, on the same
numpy-seeded weights: spectral-norm folding, the weight bridge, the
tiny-width Generator (with its mask net) and the segment rollout.

Tolerances: 1e-6 relative for folded kernels (the same float32 power
step), 1e-5 for single ops, 1e-4 for whole models (float32 convolutions
summed in another order, through ~20 layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import (generator_trees, renderer_cfg, single_thread,  # noqa: F401
                           t)
from renderloom.models import layers as JL
from renderloom.train import gan as JG
from renderloom_torch import convert
from renderloom_torch.models import layers as TL
from renderloom_torch.train import gan as TG

H, W = 32, 48


@pytest.fixture(scope="module")
def trees():
    return generator_trees(renderer_cfg(JC, H, W), H, W)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def test_fold_spectral_norm_matches_jax(trees):
    params, stats = trees
    want = dict(_leaves(jax.device_get(JG.fold_spectral_norm(params,
                                                             stats))))
    got = dict(_leaves(convert.fold_spectral_norm(params, stats)))
    assert want.keys() == got.keys()
    folded = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)
        folded += not np.array_equal(got[k], dict(_leaves(params))[k])
    assert folded > 20            # every spectral conv kernel changed


def test_weight_bridge_layouts(trees):
    params, _ = trees
    gen = TG.make_inference_generator(renderer_cfg(TC, H, W))
    convert.load_flax_params(gen, params)      # strict: names match 1:1
    k = params["down_0"]["conv0"]["conv"]["kernel"]          # HWIO
    np.testing.assert_array_equal(gen.down_0.conv0.conv.weight.detach(),
                                  k.transpose(3, 2, 0, 1))
    s = params["mask_net"]["res0"]["norm0"]["scale"]
    np.testing.assert_array_equal(gen.mask_net.res0.norm0.weight.detach(),
                                  s)
    with pytest.raises(RuntimeError):
        convert.load_flax_params(gen, {"extra": params["down_first"]})


def test_pool_upsample_and_stride2_conv_match_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 10, 14, 5)).astype(np.float32)
    np.testing.assert_allclose(
        TL.avg_pool_3x3s2(t(x)).numpy(),
        np.asarray(JL.avg_pool_3x3s2(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_array_equal(
        TL.upsample2x(t(x)).numpy(),
        np.asarray(JL.upsample2x(jnp.asarray(x))))
    conv = JL.SNConv(7, kernel=3, stride=2, spectral=False)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    mine = TL.SNConv(5, 7, 3, 2, spectral=False)
    convert.load_flax_params(mine, jax.device_get(v["params"]))
    with torch.no_grad():
        got = mine(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(conv.apply(v, jnp.asarray(x))),
                               atol=1e-5)


def _inputs(B, seed):
    rng = np.random.default_rng(seed)
    label = rng.uniform(-1, 1, (B, H, W, 22)).astype(np.float32)
    imgs = rng.uniform(-1, 1, (2, B, H, W, 3)).astype(np.float32)
    return label, imgs[0], imgs[1]


def test_generator_matches_jax(trees):
    params, stats = trees
    folded = JG.fold_spectral_norm(params, stats)
    jgen = JG.make_inference_generator(renderer_cfg(JC, H, W))
    label, back, prev = _inputs(2, 1)
    img_w, mask_w = jax.jit(lambda p: jgen.apply(
        {"params": p}, label, label, back, prev))(folded)

    gen = TG.make_inference_pair(renderer_cfg(TC, H, W), params, stats,
                                 "cpu")
    with torch.no_grad():
        img, mask = gen(t(label), t(label), t(back), t(prev))
    assert img.shape == (2, H, W, 3) and mask.shape == (2, H, W, 1)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_w), atol=1e-4)
    np.testing.assert_allclose(mask.numpy(), np.asarray(mask_w), atol=1e-4)


def test_segment_rollout_matches_jax(trees):
    params, stats = trees
    rate, K = 2, 3
    L = (K - 1) * rate + 1
    rng = np.random.default_rng(2)
    batch = {"label": rng.uniform(-1, 1, (1, L, H, W, 22)),
             "back": rng.uniform(-1, 1, (1, L, H, W, 3)),
             "key_img": rng.uniform(-1, 1, (1, L, H, W, 3))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    jcfg = renderer_cfg(JC, H, W)
    jroll = JG.make_segment_rollout(JG.make_inference_generator(jcfg), jcfg,
                                    rate)
    want_f, want_m = jroll(JG.fold_spectral_norm(params, stats), {},
                           {k: jnp.asarray(v) for k, v in batch.items()})

    gen = TG.make_inference_pair(renderer_cfg(TC, H, W), params, stats,
                                 "cpu")
    with torch.no_grad():
        got_f, got_m = TG.make_segment_rollout(gen, rate)(
            {k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-4)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-4)
    # keyframes pass through exactly
    np.testing.assert_array_equal(got_f[:, ::rate].numpy(),
                                  batch["key_img"][:, ::rate])
