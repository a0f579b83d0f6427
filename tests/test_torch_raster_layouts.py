"""The rasterizer's packed and cfhw layouts in the PyTorch port (the plain
twin of ``renderloom_torch/csrc/rasterize.cu``) against the JAX
package's ``ops/rasterize_pallas.rasterize_frames_fused`` in interpret
mode, and the packed, bf16 label stream of ``data/hsm.prepare_batch``
against the JAX ``prepare_batch(fused_raster=True, packed_label=True,
label_dtype=bfloat16)``.

Tolerances as tests/test_rasterize_pallas.py: labels 1e-5 in float32
and 8e-3 in bfloat16 (one bf16 ulp of a value in [-1, 1]), masks exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import single_thread, t  # noqa: F401
from renderloom.data.hsm import prepare_batch as jax_prepare_batch
from renderloom.ops import rasterize_pallas as RP
from renderloom_torch.data.hsm import prepare_batch
from renderloom_torch.models.fastpath import space_to_depth
from renderloom_torch.ops import rasterize_kernel as K

H, W = 48, 64


def _frames(n=3, seed=0):
    """Joints spread over and just outside the frame, some below the
    confidence threshold."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform([-4, -4], [W + 4, H + 4], (n, 19, 2))
    conf = np.where(rng.uniform(size=(n, 19)) > 0.2, 0.9, 0.0)
    return coords.astype(np.float32), conf.astype(np.float32)


def _assert_layout_matches(got, want, dtype):
    assert set(got) == set(want)
    tol = 1e-5 if dtype == "float32" else 8e-3
    for k in ("label", "heatmaps", "skeleton"):
        if k in want:
            assert got[k].shape == want[k].shape
            assert got[k].dtype == getattr(torch, dtype)
            np.testing.assert_allclose(got[k].float().numpy(),
                                       np.asarray(want[k], np.float32),
                                       atol=tol)
    for k in ("mask", "part_mask"):
        if k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# masks on and off for packed (serving runs it without), always for cfhw;
# each layout in both label types
@pytest.mark.parametrize("layout,emit_masks,dtype", [
    ("packed", True, "float32"), ("packed", False, "bfloat16"),
    ("cfhw", True, "float32"), ("cfhw", True, "bfloat16")])
def test_twin_matches_pallas_layout(layout, emit_masks, dtype):
    coords, conf = _frames()
    want = RP.rasterize_frames_fused(
        None, jnp.asarray(coords), jnp.asarray(conf), H, W, train=False,
        interpret=True, layout=layout, emit_masks=emit_masks,
        out_dtype=getattr(jnp, dtype))
    got = K.rasterize_frames_fused(t(coords), t(conf), H, W,
                                   out_dtype=getattr(torch, dtype),
                                   emit_masks=emit_masks, layout=layout)
    _assert_layout_matches(got, want, dtype)
    if layout == "packed":
        assert got["label"].shape == (3, H // 2, W // 2, 88)
    else:
        assert got["heatmaps"].shape == (3, 19, H, W)
        assert got["skeleton"].shape == (3, 3, H, W)


def test_twin_on_injected_train_tables():
    """Train-mode tables drawn by jax.random, handed to the twin as they
    are, against the Pallas kernel that drew them (packed layout; the
    layouts share the tables, test_packed_twin_is_space_to_depth_of_nhwc)."""
    layout = "packed"
    coords, conf = _frames(seed=2)
    key = jax.random.PRNGKey(7)
    want = RP.rasterize_frames_fused(
        key, jnp.asarray(coords), jnp.asarray(conf), H, W, train=True,
        interpret=True, layout=layout, emit_masks=True,
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
                             emit_masks=True, layout=layout)
    assert np.asarray(want["part_mask"]).any()
    _assert_layout_matches(got, want, "float32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_twin_is_space_to_depth_of_nhwc(dtype):
    """The packed label is exactly space_to_depth of the nhwc label, and
    the cfhw planes are the nhwc channels before the skeleton's scaling;
    the masks are the same in every layout."""
    coords, conf = _frames(seed=4)
    tables = K.build_tables(t(coords), t(conf), H, W)
    nhwc = K.rasterize_tables(*tables, H, W, dtype, emit_masks=True)
    packed = K.rasterize_tables(*tables, H, W, dtype, emit_masks=True,
                                layout="packed")
    cfhw = K.rasterize_tables(*tables, H, W, dtype, emit_masks=True,
                              layout="cfhw")
    assert torch.equal(packed["label"], space_to_depth(nhwc["label"]))
    assert torch.equal(cfhw["heatmaps"],
                       nhwc["label"][..., 3:].permute(0, 3, 1, 2))
    if dtype == torch.float32:
        torch.testing.assert_close(
            cfhw["skeleton"] * 2.0 - 1.0,
            nhwc["label"][..., :3].permute(0, 3, 1, 2), rtol=0, atol=0)
    for k in ("mask", "part_mask"):
        assert torch.equal(packed[k], nhwc[k])
        assert torch.equal(cfhw[k], nhwc[k])


def test_layout_arguments_are_checked():
    coords, conf = _frames(1)
    tables = K.build_tables(t(coords), t(conf), H, W)
    with pytest.raises(ValueError, match="masks"):
        K.rasterize_tables(*tables, H, W, layout="cfhw")
    with pytest.raises(ValueError, match="even"):
        K.rasterize_tables(*tables, H, W - 1, layout="packed")
    with pytest.raises(ValueError, match="unknown layout"):
        K.rasterize_tables(*tables, H, W, layout="cmaj")
    # a CPU table never reaches the kernel, whatever the layout
    before = dict(K.rasterize_tables_cuda.layout_launches)
    for layout in ("packed", "cfhw"):
        with pytest.raises(ValueError):
            K.rasterize_tables_cuda(*tables, H, W, emit_masks=True,
                                    layout=layout)
    assert K.rasterize_tables_cuda.layout_launches == before


def test_prepare_batch_packed_bf16_label_matches_jax():
    """The serving preparation with the label stream parity-packed and in
    bf16, as the JAX pipeline's TPU configuration asks for it."""
    rng = np.random.default_rng(5)
    B, F_ = 1, 3
    images = rng.uniform(0, 255, (B, F_, H, W, 3)).astype(np.float32)
    dain = rng.uniform(0, 255, (B, F_, H, W, 3)).astype(np.float32)
    coords, conf = _frames(B * F_, seed=6)
    poses = np.concatenate([coords, conf[..., None]], -1).reshape(
        B, F_, 19, 3)
    jcfg = JC.RendererDataConfig(model_width=W, model_height=H,
                                 load_width=W, load_height=H)
    want = jax_prepare_batch(
        None, {"images": jnp.asarray(images), "dain": jnp.asarray(dain),
               "poses": jnp.asarray(poses)}, jcfg, train=False,
        fused_raster=True, label_dtype=jnp.bfloat16, packed_label=True,
        want_masks=False)
    tcfg = TC.RendererDataConfig(model_width=W, model_height=H,
                                 load_width=W, load_height=H)
    got = prepare_batch({"images": t(images), "dain": t(dain),
                         "poses": t(poses)}, tcfg,
                        label_dtype=torch.bfloat16, packed_label=True)
    assert got["label"].shape == (B, F_, H // 2, W // 2, 88)
    assert got["label"].dtype == torch.bfloat16
    np.testing.assert_allclose(got["label"].float().numpy(),
                               np.asarray(want["label"], np.float32),
                               atol=8e-3)
    for k in ("image", "back"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6)
