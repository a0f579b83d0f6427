"""GAN losses, learning-rate schedules and the optimizer of the PyTorch
port against the JAX package and optax.

Tolerances: losses 1e-6 relative (the same float32 reductions in
another order); schedules equal to float32 rounding; the hand-written
AMSGrad + apply_if_finite 1e-6 relative on the parameters over five
updates (``b2 ** count`` may round one ulp apart between XLA's and
torch's ``pow``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import single_thread, t  # noqa: F401
from renderloom.train import gan_losses as JL
from renderloom.train import schedules as JS
from renderloom_torch.train import gan as TG
from renderloom_torch.train import gan_losses as TL
from renderloom_torch.train import schedules as TS

MODES = ["hinge", "least_square", "non_saturated", "wasserstein"]


def _rand(shape, seed, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("weighted", [False, True])
def test_gan_loss_matches_jax(mode, weighted):
    outs = [_rand((4, 5, 6, 1), 0), _rand((4, 3, 3, 1), 1)]
    w = np.array([1.0, 0.0, 1.0, 1.0], np.float32) if weighted else None
    for t_real in (False, True):
        for dis_update in (False, True):
            want = JL.gan_loss([jnp.asarray(o) for o in outs], t_real,
                               dis_update, mode,
                               None if w is None else jnp.asarray(w))
            got = TL.gan_loss([t(o) for o in outs], t_real, dis_update,
                              mode, None if w is None else t(w))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
def test_feature_matching_matches_jax(weighted):
    fake = [[_rand((4, 6, 6, 3), i), _rand((4, 3, 3, 5), i + 1)]
            for i in (0, 2)]
    real = [[_rand((4, 6, 6, 3), i), _rand((4, 3, 3, 5), i + 1)]
            for i in (10, 12)]
    w = np.array([1.0, 0.0, 0.0, 1.0], np.float32) if weighted else None
    jt = lambda ll: [[jnp.asarray(x) for x in lst] for lst in ll]
    tt = lambda ll: [[t(x) for x in lst] for lst in ll]
    want = JL.feature_matching_loss(jt(fake), jt(real),
                                    None if w is None else jnp.asarray(w))
    got = TL.feature_matching_loss(tt(fake), tt(real),
                                   None if w is None else t(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("empty_mask", [False, True])
def test_masked_l1_and_mask_regulation_match_jax(empty_mask):
    pred, target = _rand((2, 8, 10, 3), 0), _rand((2, 8, 10, 3), 1)
    fg = (_rand((2, 8, 10, 1), 2, 0, 1) > 0.5).astype(np.float32)
    if empty_mask:
        fg[:] = 0
    np.testing.assert_allclose(
        float(TL.masked_l1_image(t(pred), t(fg), t(target))),
        float(JL.masked_l1_image(jnp.asarray(pred), jnp.asarray(fg),
                                 jnp.asarray(target))), rtol=1e-6)
    mask = _rand((2, 8, 10, 1), 3, 0, 1)
    np.testing.assert_allclose(
        float(TL.mask_regulation_loss(t(mask))),
        float(JL.mask_regulation_loss(jnp.asarray(mask))), rtol=1e-6)


@pytest.mark.parametrize("policy", ["constant", "lambda", "step",
                                    "multistep"])
def test_step_schedule_matches_jax(policy):
    want = JS.step_schedule(1e-4, policy, 3, gamma=0.5, step_size=2)
    got = TS.step_schedule(1e-4, policy, 3, gamma=0.5, step_size=2)
    for count in range(0, 40, 2):
        w = float(want(jnp.asarray(count, jnp.int32)))
        np.testing.assert_allclose(float(got(count)), w, rtol=1e-7)
        np.testing.assert_allclose(
            float(got(torch.tensor(count, dtype=torch.int32))), w, rtol=1e-7)


def test_reduce_on_plateau_matches_jax():
    a, b = JS.ReduceOnPlateau(patience=2), TS.ReduceOnPlateau(patience=2)
    for m in [1.0, 0.9, 0.95, 0.95, 0.95, 0.5, 0.6, 0.6, 0.6, 0.6]:
        assert a.update(m) == b.update(m)


def test_amsgrad_if_finite_matches_optax():
    """Five updates of two parameters on a step schedule, the third
    with a NaN gradient: skipped and counted by both."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    grads[2]["b"][1] = np.nan
    sched = JS.step_schedule(1e-2, "step", 1, gamma=0.5, step_size=2)
    tx = optax.apply_if_finite(optax.amsgrad(sched, b1=0.0, b2=0.999),
                               max_consecutive_errors=10)
    params = jax.tree.map(jnp.asarray, p0)
    opt_state = tx.init(params)
    tparams = [torch.nn.Parameter(t(p0["a"])), torch.nn.Parameter(t(p0["b"]))]
    opt = TG.AmsgradIfFinite(
        tparams, TS.step_schedule(1e-2, "step", 1, gamma=0.5, step_size=2),
        b1=0.0, b2=0.999, max_consecutive_errors=10)
    for g in grads:
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state,
                                   params)
        params = optax.apply_updates(params, upd)
        opt.step([t(g["a"]), t(g["b"])])
        assert int(opt.notfinite_count) == int(opt_state.notfinite_count)
        for k, p in zip(("a", "b"), tparams):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-8)
    assert int(opt.count) == 4 and int(opt.total_notfinite) == 1
    assert int(opt_state.inner_state[0].count) == 4


def test_apply_if_finite_gives_up_after_max_errors():
    """Past max_consecutive_errors the non-finite update is applied, as
    optax does (and the parameter becomes NaN)."""
    p = torch.nn.Parameter(torch.ones(2))
    opt = TG.AmsgradIfFinite([p], lambda c: torch.tensor(0.1), b1=0.0,
                             max_consecutive_errors=2)
    bad = torch.tensor([float("nan"), 1.0])
    for i in range(2):
        opt.step([bad])
        assert torch.equal(p.detach(), torch.ones(2)), i
    opt.step([bad])
    assert int(opt.notfinite_count) == 3
    assert torch.isnan(p.detach()[0])
