"""Train-mode preparation of the PyTorch port against the JAX package:
the window-affine and blur ops, the rasterizer tables built from
JAX-drawn σ, keep and part values (label and masks against the Pallas
kernel in interpret mode, as tests/test_rasterize_pallas.py runs it),
and the train branch of ``prepare_batch`` with every JAX-drawn value
injected.

JAX's random streams cannot be reproduced in torch, so each test draws
with ``jax.random`` along the JAX code's own key splits and hands the
values to the port.

Tolerances: matrices and keypoints 1e-5 relative, warped and blurred
images 1e-5, labels 1e-5, masks exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import single_thread, t  # noqa: F401
from renderloom.data import hsm as JH
from renderloom.ops import image as JI
from renderloom.ops import rasterize_pallas as RP
from renderloom_torch.data import hsm as TH
from renderloom_torch.ops import image as TI
from renderloom_torch.ops import rasterize_kernel as K

H, W = 64, 96          # model and load size
H0, W0 = 80, 120       # source size of the raw windows


def data_cfg(C):
    return C.RendererDataConfig(model_height=H, model_width=W,
                                load_height=H, load_width=W,
                                random_drop_prob=0.2, random_blur_rate=0.3)


def test_affine_matrices_and_keypoints_match_jax():
    args = (0.03, 0.03, -0.07, 7.5)
    want = JI.compose_affine(JI.shift_scale_rotate_matrix(H, W, *args),
                             JI.resize_matrix(H0, W0, H, W))
    ssr = TI.shift_scale_rotate_matrix(
        H, W, *(torch.tensor(a, dtype=torch.float32) for a in args))
    got = TI.compose_affine(ssr, TI.resize_matrix(H0, W0, H, W))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(TI.invert_affine(got).numpy(),
                               np.asarray(JI.invert_affine(want)),
                               rtol=1e-5, atol=1e-5)
    kps = np.random.default_rng(0).uniform(0, 100, (19, 2)).astype(
        np.float32)
    np.testing.assert_allclose(
        TI.transform_keypoints(t(kps), got).numpy(),
        np.asarray(JI.transform_keypoints(jnp.asarray(kps), want)),
        rtol=1e-5, atol=1e-4)


def test_affine_warp_and_blur_match_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (2, H0, W0, 3)).astype(np.float32)
    ms = [JI.compose_affine(JI.shift_scale_rotate_matrix(H, W, s, s, sc, a),
                            JI.resize_matrix(H0, W0, H, W))
          for s, sc, a in ((0.05, 0.08, -9.0), (-0.06, -0.1, 3.0))]
    want = np.stack([np.asarray(JI.affine_warp(jnp.asarray(im), m, H, W))
                     for im, m in zip(img, ms)])
    got = TI.affine_warp(t(img), t(np.stack(ms)), H, W)
    assert got.shape == (2, H, W, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # zero outside the source, as BORDER_CONSTANT
    assert (np.abs(want) < 1e-12).any()
    blur = JI.gaussian_blur(jnp.asarray(img[0]), 10.0)
    np.testing.assert_allclose(TI.gaussian_blur(t(img[:1]), 10.0)[0].numpy(),
                               np.asarray(blur), atol=1e-5)


def jax_raster_draws(k_ras, n_frames, cfg):
    """rasterize_frames_fused's per-frame draws (:313-335) for key
    ``k_ras``, along its key splits."""
    g = int(cfg.gauss_sigma)

    def one(k):
        k_sig, k_drop, k_edge, k_blur = jax.random.split(k, 4)
        return {"sigma": jax.random.randint(k_sig, (RP.J,), g - 1, g + 1
                                            ).astype(jnp.float32),
                "keep_j": jax.random.uniform(k_drop, (RP.J,))
                > cfg.random_drop_prob,
                "keep_e": jax.random.uniform(k_edge, (RP.E_SKEL,))
                > cfg.random_drop_prob,
                "part": jax.random.uniform(k_blur, (RP.E_MASK,))
                < cfg.random_blur_rate}

    draws = jax.vmap(one)(jax.random.split(k_ras, n_frames))
    return {k: t(v) for k, v in draws.items()}


def jax_prepare_draws(key, B, F, cfg):
    """Every draw of JAX ``prepare_batch(key, ..., train=True,
    fused_raster=True)``, along its key splits."""
    k_geo, k_ras, _ = jax.random.split(key, 3)
    out = {"shift": [], "angle": [], "scale": []}
    for k in jax.random.split(k_geo, B):
        k_aff, _ = jax.random.split(k)
        k1, k2, k3 = jax.random.split(k_aff, 3)
        out["shift"].append(jax.random.uniform(k1, (), minval=-0.0625,
                                               maxval=0.0625))
        out["angle"].append(jax.random.uniform(k2, (), minval=-10.0,
                                               maxval=10.0))
        out["scale"].append(jax.random.uniform(k3, (), minval=-0.1,
                                               maxval=0.1))
    draws = {k: t(np.stack(v)) for k, v in out.items()}
    draws.update(jax_raster_draws(k_ras, B * F, cfg))
    return draws


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    coords = rng.uniform([4, 4], [W0 - 4, H0 - 4], (n, 19, 2))
    conf = np.where(rng.uniform(size=(n, 19)) > 0.1, 0.9, 0.0)
    return np.concatenate([coords, conf[..., None]], -1).astype(np.float32)


def test_train_tables_with_jax_draws_match_pallas():
    cfg = data_cfg(JC)
    poses = _poses(3, 2)
    coords, conf = poses[..., :2] * (H / H0), poses[..., 2]
    key = jax.random.PRNGKey(3)
    want = RP.rasterize_frames_fused(
        key, jnp.asarray(coords), jnp.asarray(conf), H, W, train=True,
        interpret=True, layout="nhwc", emit_masks=True,
        random_drop_prob=cfg.random_drop_prob,
        random_blur_rate=cfg.random_blur_rate)
    draws = jax_raster_draws(key, 3, cfg)
    tables = K.build_tables(t(coords), t(conf), H, W, draws=draws)
    got = K.rasterize_tables(*tables, H, W, emit_masks=True)
    assert bool(draws["part"].any()) and not bool(draws["keep_j"].all())
    assert np.asarray(want["part_mask"]).any()
    np.testing.assert_allclose(got["label"].numpy(), np.asarray(want["label"]),
                               atol=1e-5)
    for k in ("mask", "part_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_draw_train_tables_ranges():
    g = torch.Generator().manual_seed(0)
    d = K.draw_train_tables(g, 400, 5.0, 0.2, 0.3)
    assert set(d["sigma"].unique().tolist()) == {4.0, 5.0}
    assert d["keep_j"].shape == (400, 19) and d["keep_e"].shape == (400, 18)
    assert d["part"].shape == (400, 20)
    assert 0.7 < d["keep_j"].float().mean() < 0.9
    assert 0.2 < d["part"].float().mean() < 0.4


@pytest.mark.parametrize("zero_first_dain", [True, False])
def test_prepare_batch_train_matches_jax(zero_first_dain):
    B, F = 2, 3
    rng = np.random.default_rng(4)
    batch = {"images": rng.integers(0, 255, (B, F, H0, W0, 3), np.uint8),
             "dain": rng.integers(0, 255, (B, F, H0, W0, 3), np.uint8),
             "poses": _poses(B * F, 5).reshape(B, F, 19, 3)}
    if zero_first_dain:
        batch["dain"][:, 0] = 0
    key = jax.random.PRNGKey(6)
    want = JH.prepare_batch(key, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, data_cfg(JC), train=True,
                            fused_raster=True)
    draws = jax_prepare_draws(key, B, F, data_cfg(JC))
    got = TH.prepare_batch({k: t(v) for k, v in batch.items()},
                           data_cfg(TC), draws)
    assert got.keys() == want.keys()
    for k in ("label", "image", "back"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["fg_mask"].numpy(),
                                  np.asarray(want["fg_mask"]))
    assert (got["back"][:, 0] == 0).all() == zero_first_dain
    # the part-mask blur reached the backgrounds
    assert bool(draws["part"].any())


def test_draw_train_randomness_shapes_and_ranges():
    g = torch.Generator().manual_seed(1)
    d = TH.draw_train_randomness(g, 3, 4, data_cfg(TC))
    assert d["shift"].shape == (3,) and d["sigma"].shape == (12, 19)
    assert (d["shift"].abs() <= 0.0625).all()
    assert (d["angle"].abs() <= 10).all() and (d["scale"].abs() <= 0.1).all()
