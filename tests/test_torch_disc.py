"""Discriminator side of the PyTorch port against the JAX package: face
and hand crops (with the no-face fallback and a missing hand), the
tiny-width ``DiscriminatorSet`` forward with its spectral-norm updates
in call order, and the VGG19 perceptual loss on the JAX package's
random VGG tree.

Tolerances: crops 1e-5 (the same triangle weights, an einsum in
another order), their gradient 1e-5; D outputs and features 1e-4 and
``u`` 1e-5 relative after its four calls per net; the perceptual loss
1e-5 relative (float32 convolutions through 13 layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import fill_tree, single_thread, t  # noqa: F401
from renderloom.models.discriminator import DiscriminatorSet as JDis
from renderloom.models.perceptual import PerceptualLoss as JPerceptual
from renderloom.ops import crops as JCrops
from renderloom_torch import convert
from renderloom_torch.models.discriminator import DiscriminatorSet
from renderloom_torch.models.layers import enable_spectral_norm
from renderloom_torch.ops import crops as TCrops
from renderloom_torch.train.gan import make_perceptual

H, W = 64, 96


def dis_cfg(C):
    tiny = lambda n: C.PatchDiscConfig(num_filters=4, max_num_filters=32,
                                       num_discriminators=n, num_layers=2)
    return C.DiscriminatorConfig(image=tiny(2), face=tiny(1), hand=tiny(1))


def _blob(cy, cx, sigma=3.0):
    yy, xx = np.mgrid[0:H, 0:W]
    return np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma ** 2))


def label_with_parts(seed=0):
    """(3, H, W, 22) labels: sample 0 has a face and both hands, sample 1
    a wide face near the edge and no left hand, sample 2 no face (the
    fallback box) and a hand at the border."""
    rng = np.random.default_rng(seed)
    lbl = rng.uniform(-1, 1, (3, H, W, 22)).astype(np.float32)
    lbl[..., 3:] = 0.0
    lbl[0, ..., 3] = _blob(20, 40)
    lbl[0, ..., 20] = _blob(40, 20)
    lbl[0, ..., 21] = _blob(45, 70)
    lbl[1, ..., 3] = _blob(8, 85, sigma=6.0)
    lbl[1, ..., 20] = _blob(50, 50)
    lbl[2, ..., 21] = _blob(62, 2)
    return lbl


def test_face_crop_matches_jax_with_gradient():
    lbl = label_with_parts()
    img = np.random.default_rng(1).uniform(-1, 1, (3, H, W, 5)).astype(
        np.float32)
    wts = np.random.default_rng(2).normal(size=(3, 16, 16, 3)).astype(
        np.float32)
    want = JCrops.face_crop(jnp.asarray(img), jnp.asarray(lbl))
    want_g = jax.grad(lambda x: jnp.sum(JCrops.face_crop(
        x, jnp.asarray(lbl)) * wts))(jnp.asarray(img))
    x = t(img).requires_grad_()
    got = TCrops.face_crop(x, t(lbl))
    assert got.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    (got * t(wts)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-5)


def test_hand_crops_match_jax():
    lbl = label_with_parts()
    img = np.random.default_rng(3).uniform(-1, 1, (3, H, W, 3)).astype(
        np.float32)
    want, want_v = JCrops.hand_crops(jnp.asarray(img), jnp.asarray(lbl))
    got, got_v = TCrops.hand_crops(t(img), t(lbl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.tolist() == [[True, True], [True, False], [False, True]]


def test_crops_of_bf16_images_match_jax():
    """bf16 images and labels, as the bf16 train step passes them: both
    sides crop in bf16 (JAX's ``scale_and_translate`` rounds its weights
    to the image's dtype, as the port's einsum does) and agree bit for
    bit here; the face crop lies 0.40 from its float32 one."""
    lbl = t(label_with_parts()).bfloat16()
    img = t(np.random.default_rng(1).uniform(-1, 1, (3, H, W, 5)).astype(
        np.float32)).bfloat16()
    jnp16 = lambda v: jnp.asarray(v.float().numpy(), jnp.bfloat16)
    want = JCrops.face_crop(jnp16(img), jnp16(lbl))
    got = TCrops.face_crop(img, lbl)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    (want_h, want_v), (got_h, got_v) = (
        JCrops.hand_crops(jnp16(img[..., :3]), jnp16(lbl)),
        TCrops.hand_crops(img[..., :3], lbl))
    assert got_h.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_h.float().numpy(),
                                  np.asarray(want_h, np.float32))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.fixture(scope="module")
def dis_trees():
    lbl = jnp.zeros((1, H, W, 22))
    img = jnp.zeros((1, H, W, 3))
    fg = jnp.zeros((1, H, W, 1))
    shapes = jax.eval_shape(JDis(dis_cfg(JC)).init, jax.random.PRNGKey(0),
                            lbl, img, img, img, fg)
    rng = np.random.default_rng(4)
    return fill_tree(shapes["params"], rng), fill_tree(shapes["batch_stats"],
                                                       rng)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_discriminator_set_matches_jax_and_updates_u_in_call_order(dis_trees):
    params, stats = dis_trees
    lbl = label_with_parts()
    rng = np.random.default_rng(5)
    real, fake, raw = (rng.uniform(-1, 1, (3, H, W, 3)).astype(np.float32)
                       for _ in range(3))
    fg = (rng.uniform(size=(3, H, W, 1)) > 0.4).astype(np.float32)
    args = (lbl, real, fake, raw, fg)
    want, new = JDis(dis_cfg(JC)).apply(
        {"params": params, "batch_stats": stats},
        *(jnp.asarray(a) for a in args), update_stats=True,
        mutable=["batch_stats"])
    dis = enable_spectral_norm(DiscriminatorSet(dis_cfg(TC)))
    convert.load_flax_params(dis, params, stats)
    with torch.no_grad():
        got = dis(*(t(a) for a in args), update_stats=True)
    assert got.keys() == want.keys() == {"fuse", "raw", "face", "hand"}
    g, w = _flat(jax.tree.map(lambda x: x.numpy(), got)), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=1e-4, err_msg=k)
    got_s, want_s = _flat(convert.flax_trees(dis)[1]), _flat(
        new["batch_stats"])
    assert got_s.keys() == want_s.keys()
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # net_d ran four power steps, the crop nets two each: a port that
    # called a net fewer times, or updated from a stale u, differs here
    assert any("net_d_hand" in k for k in want_s)


def test_perceptual_loss_matches_jax():
    jloss = JPerceptual()
    params = jax.device_get(jloss.variables["params"])
    rng = np.random.default_rng(6)
    pred, target = (rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
                    for _ in range(2))
    want = float(jloss(jnp.asarray(pred), jnp.asarray(target)))
    cfg = TC.RendererConfig()
    vgg = make_perceptual(cfg, "cpu", params=params)
    got = vgg(t(pred), t(target))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    # every conv of the tree loads, conv_5_2..conv_5_4 included, though
    # the trunk stops at relu_5_1
    assert set(convert.flax_trees(vgg.model)[0]) == set(params)
