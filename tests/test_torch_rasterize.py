"""Pose rasterizer of the PyTorch port against the JAX package: the plain
twin of the CUDA kernel ``renderloom_torch/csrc/rasterize.cu`` against
``ops/rasterize_pallas.rasterize_frames_fused`` (interpret mode, layout
"nhwc") and against ``ops/rasterize.rasterize_frames``.

Tolerances: labels 1e-5 absolute in float32 and 8e-3 in bfloat16 (one
bf16 ulp of a value in [-1, 1]); masks exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import single_thread, t  # noqa: F401
from renderloom.ops import rasterize as R
from renderloom.ops import rasterize_pallas as RP
from renderloom_torch.ops import rasterize as TR
from renderloom_torch.ops import rasterize_kernel as K

H, W = 48, 64


def _frames(n=3, seed=0):
    """Joints spread over and just outside the frame, some below the
    confidence threshold."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform([-4, -4], [W + 4, H + 4], (n, 19, 2))
    conf = np.where(rng.uniform(size=(n, 19)) > 0.2, 0.9, 0.0)
    return coords.astype(np.float32), conf.astype(np.float32)


@pytest.mark.parametrize("emit_masks", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_pallas_nhwc(emit_masks, dtype):
    coords, conf = _frames()
    want = RP.rasterize_frames_fused(
        None, jnp.asarray(coords), jnp.asarray(conf), H, W, train=False,
        interpret=True, layout="nhwc", emit_masks=emit_masks,
        out_dtype=getattr(jnp, dtype))
    got = K.rasterize_frames_fused(t(coords), t(conf), H, W,
                                   out_dtype=getattr(torch, dtype),
                                   emit_masks=emit_masks)
    assert set(got) == set(want)
    assert got["label"].shape == (3, H, W, 22)
    assert got["label"].dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got["label"].float().numpy(),
                               np.asarray(want["label"], np.float32),
                               atol=tol)
    if emit_masks:
        for k in ("mask", "part_mask"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_tables_match_jax_build_tables():
    coords, conf = _frames(seed=1)
    sigma = jnp.full((19,), 5.0, jnp.float32)
    want = jax.vmap(lambda c, cf: RP._build_tables(
        c, cf, sigma, None, None, None, H, W, 0.001, 0.001))(
            jnp.asarray(coords), jnp.asarray(conf))
    got = K.build_tables(t(coords), t(conf), H, W)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_twin_on_injected_train_tables():
    """Train-mode tables (jittered σ, joint/limb dropout, part limbs)
    come from jax.random; the twin takes them as they are and agrees
    with the Pallas kernel that drew them."""
    coords, conf = _frames(seed=2)
    key = jax.random.PRNGKey(7)
    want = RP.rasterize_frames_fused(
        key, jnp.asarray(coords), jnp.asarray(conf), H, W, train=True,
        interpret=True, layout="nhwc", emit_masks=True,
        random_drop_prob=0.3, random_blur_rate=0.5)

    def tables_one(k, c, cf):
        k_sig, k_drop, k_edge, k_blur = jax.random.split(k, 4)
        sigma = jax.random.randint(k_sig, (19,), 4, 6).astype(jnp.float32)
        keep_j = jax.random.uniform(k_drop, (19,)) > 0.3
        keep_e = jax.random.uniform(k_edge, (RP.E_SKEL,)) > 0.3
        part = jax.random.uniform(k_blur, (RP.E_MASK,)) < 0.5
        return RP._build_tables(c, cf, sigma, keep_j, keep_e, part, H, W,
                                0.001, 0.001)

    tables = jax.vmap(tables_one)(jax.random.split(key, 3),
                                  jnp.asarray(coords), jnp.asarray(conf))
    got = K.rasterize_tables(*(t(x) for x in tables), H, W,
                             emit_masks=True)
    assert np.asarray(want["part_mask"]).any()
    np.testing.assert_allclose(got["label"].numpy(),
                               np.asarray(want["label"]), atol=1e-5)
    for k in ("mask", "part_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_plain_rasterizer_matches_jax_rasterize_frames():
    coords, conf = _frames(seed=3)
    want = R.rasterize_frames(None, jnp.asarray(coords), jnp.asarray(conf),
                              H, W, train=False)
    got = TR.rasterize_frames(t(coords), t(conf), H, W)
    for k in ("heatmaps", "skeleton"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5)
    for k in ("mask", "part_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the kernel's twin assembles the same label and masks
    lbl = K.rasterize_frames_fused(t(coords), t(conf), H, W,
                                   emit_masks=True)
    skel = got["skeleton"].permute(0, 2, 3, 1) * 2.0 - 1.0
    heat = got["heatmaps"].permute(0, 2, 3, 1)
    np.testing.assert_allclose(lbl["label"].numpy(),
                               torch.cat([skel, heat], -1).numpy(),
                               atol=1e-5)
    np.testing.assert_array_equal(lbl["mask"].numpy() > 0.5,
                                  got["mask"].numpy())


def test_cuda_wrapper_refuses_cpu_tables():
    coords, conf = _frames(1)
    tables = K.build_tables(t(coords), t(conf), H, W)
    before = dict(K.rasterize_tables_cuda.layout_launches)
    with pytest.raises(ValueError):
        K.rasterize_tables_cuda(*tables, H, W)
    assert K.rasterize_tables_cuda.layout_launches == before
