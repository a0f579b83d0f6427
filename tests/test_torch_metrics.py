"""The image metrics and the ``ssim_w`` loss term of the PyTorch port
against the JAX package on the CPU, on the same numpy inputs:
``psnr``, ``ssim``, ``denorm_to_unit`` and ``masked_metrics``
(``renderloom/ops/image.py``), ``PerceptualLoss.lpips``
(``renderloom/models/perceptual.py``, on the JAX package's random VGG19
tree), and the ``g/ssim`` term of one port train step against the JAX
expression of ``renderloom/train/gan.py`` on the fused, real and fg
tensors that step used (in float32 and in bf16 compute; no JAX step is
compiled).

Tolerance 1e-5, relative and absolute: the same float32 arithmetic,
summed in another order (PSNR's log of a mean, SSIM's filtered moments,
LPIPS's per-pixel channel norms).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderloom.ops.image as JI
import renderloom_torch.core.config as TC
from _torch_parity import single_thread, t  # noqa: F401
from renderloom.models.perceptual import PerceptualLoss as JPerceptual
from renderloom_torch import convert
from renderloom_torch.models.perceptual import PerceptualLoss
from renderloom_torch.ops import image as TI
from renderloom_torch.train import gan as TG
from test_torch_train_step import cfg as train_cfg
from test_torch_train_step import make_batch

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPE = (2, 32, 48, 3)


def _images(seed=0):
    """pred and target in [0, 1] (target a perturbed pred, so PSNR and
    SSIM are away from their extremes) and a foreground mask."""
    rng = np.random.default_rng(seed)
    target = rng.uniform(0, 1, SHAPE).astype(np.float32)
    pred = np.clip(target + 0.1 * rng.normal(size=SHAPE), 0, 1).astype(
        np.float32)
    fg = np.zeros(SHAPE[:3] + (1,), np.float32)
    fg[:, 6:26, 10:40] = 1.0
    return pred, target, fg


@pytest.mark.parametrize("masked", [False, True])
def test_psnr_ssim_match_jax(masked):
    pred, target, fg = _images()
    if masked:
        pred, target = pred * fg, target * fg
    for name in ("psnr", "ssim"):
        got = getattr(TI, name)(t(pred), t(target))
        want = getattr(JI, name)(jnp.asarray(pred), jnp.asarray(target))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **TOL)
    # one HWC image
    np.testing.assert_allclose(
        TI.ssim(t(pred[0]), t(target[0])).numpy(),
        np.asarray(JI.ssim(jnp.asarray(pred[0]), jnp.asarray(target[0]))),
        **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_masked_metrics_match_jax(masked):
    """The protocol on [-1, 1] inputs (clamped past the range)."""
    pred, target, fg = _images(1)
    pred, target = 2.2 * pred - 1.1, 2 * target - 1
    mask = fg if masked else None
    got = TI.masked_metrics(t(pred), t(target),
                            None if mask is None else t(mask))
    want = JI.masked_metrics(jnp.asarray(pred), jnp.asarray(target),
                             None if mask is None else jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_array_equal(TI.denorm_to_unit(t(pred)).numpy(),
                                  np.asarray(JI.denorm_to_unit(
                                      jnp.asarray(pred))))


def test_lpips_matches_jax():
    jvgg = JPerceptual()
    vgg = PerceptualLoss()
    convert.load_flax_params(vgg.model, jax.device_get(
        jvgg.variables["params"]))
    pred, target, _ = _images(2)
    pred, target = 2 * pred - 1, 2 * target - 1
    want = jax.jit(jvgg.lpips)(jnp.asarray(pred), jnp.asarray(target))
    with torch.no_grad():
        got = vgg.lpips(t(pred), t(target))
    assert got.shape == (SHAPE[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_ssim_term_of_the_train_step_matches_jax(monkeypatch,
                                                 compute_dtype):
    """A port train step with ``ssim_w`` reports ``g/ssim``: JAX's
    ``(1 − ssim((denorm_to_unit(fused)·fg).astype(f32),
    (denorm_to_unit(real)·fg).astype(f32)))·ssim_w`` on the tensors the
    step passed (L = 3: one trained frame, so the metric is that frame's
    term)."""
    cfg = dataclasses.replace(train_cfg(TC), compute_dtype=compute_dtype,
                              ssim_w=2.0)
    seen = []
    inner = TG.ssim_loss

    def record(fused, real, fg):
        seen.append([np.asarray(v.detach().float()) for v in (fused, real,
                                                              fg)])
        return inner(fused, real, fg)
    monkeypatch.setattr(TG, "ssim_loss", record)
    state = TG.create_gan_state(cfg, "cpu", seed=0)
    metrics = TG.make_gan_train_step(cfg, TG.make_perceptual(cfg, "cpu"))(
        state, {k: t(v) for k, v in make_batch().items()})
    assert len(seen) == 1
    jdt = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    fused, real, fg = (jnp.asarray(v, jdt) for v in seen[0])
    want = (1.0 - JI.ssim(
        (JI.denorm_to_unit(fused) * fg).astype(jnp.float32),
        (JI.denorm_to_unit(real) * fg).astype(jnp.float32))) * cfg.ssim_w
    np.testing.assert_allclose(float(metrics["g/ssim"]), float(want),
                               **TOL)
    assert float(metrics["g/ssim"]) > 0
