"""The learned flow interpolator of the PyTorch port against the JAX
package: ``FlowUNet`` (base 4, 2 levels, 32×48), ``time_warp`` with both
warps, the LK and learned ``interpolate_pair`` / ``frame_double_pairs``
/ ``train_background``, the learned ``upsample_background`` at rate 4,
``flow_loss`` and its gradients, two train steps, the initialisers and
``FlowConfig``.  Weights: the JAX UNet's tree filled from a numpy seed,
loaded into the port by ``convert.load_flax_params``.

Tolerances (float32): outputs and losses 1e-5; the LK pieces 1e-4 (as
tests/test_torch_flow.py); gradients 1e-4 of each leaf's largest;
parameters 1e-6, and 2·lr where Adam's update turns a gradient at
rounding level into ±lr (each step from the same state: the port's
second step starts from JAX's state after the first).  bf16: the mean
|port − JAX bf16| within about 1.35× the reading, with the distance to
float32 at most 1.5× JAX bf16's own (``hold_bf16``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (blobs, fill_tree, hold_bf16,  # noqa: F401
                           host_copy, load_adam_state, single_thread, t)
from renderloom.core import config as JC
from renderloom.models import flownet as JN
from renderloom.ops import flow as JF
from renderloom.train import flow as JT
from renderloom_torch import convert
from renderloom_torch.core import config as TC
from renderloom_torch.models import flownet as TN
from renderloom_torch.ops import flow as TF
from renderloom_torch.train import flow as TT

H, W = 32, 48
BASE, LEVELS = 4, 2
LR = TC.FlowConfig().lr
UNET_BF16_MEAN_TOL = 8.5e-4     # readings 4.4e-4, 6.3e-4


def cfgs(**kw):
    return (JC.FlowConfig(base_filters=BASE, levels=LEVELS, **kw),
            TC.FlowConfig(base_filters=BASE, levels=LEVELS, **kw))


@pytest.fixture(scope="module")
def tree():
    z = jnp.zeros((1, H, W, 3))
    shapes = jax.eval_shape(JN.FlowUNet(BASE, LEVELS).init,
                            jax.random.PRNGKey(0), z, z)
    return fill_tree(shapes["params"], np.random.default_rng(0))


def port_unet(tree, dtype=torch.float32):
    return convert.load_flax_params(TN.FlowUNet(BASE, LEVELS, dtype), tree)


def pairs(B=2, seed=0):
    """(B, H, W, 3) keyframe pairs with a blob moving between them."""
    fr = np.stack([blobs(2, H, W, seed=seed + b) for b in range(B)])
    return fr[:, 0], fr[:, 1]


def jax_unet(tree, dtype=jnp.float32):
    model = JN.FlowUNet(BASE, LEVELS, dtype)
    return jax.jit(lambda a, b: model.apply({"params": tree}, a, b))


def test_flow_unet_matches_jax_and_converts_both_ways(tree):
    a, b = pairs()
    want = jax_unet(tree)(jnp.asarray(a), jnp.asarray(b))
    model = port_unet(tree)
    with torch.no_grad():
        got = model(t(a), t(b))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (2, H, W, 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    back, stats = convert.flax_trees(model)
    assert stats == {}
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(x, y)


def test_flow_unet_bf16_matches_jax(tree):
    """At this width the port's float32 flows lie as close to JAX's bf16
    ones as the port's bf16 flows do, so the mean limit cannot tell the
    two apart; the port's own distance from its float32 flows must be
    at least half JAX bf16's from JAX float32 (readings 1.3× and 0.92×;
    a float32 port reads 0)."""
    a, b = pairs(seed=3)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want16 = jax_unet(tree, jnp.bfloat16)(ja, jb)
    want32 = jax_unet(tree)(ja, jb)
    with torch.no_grad():
        got = port_unet(tree, torch.bfloat16)(t(a), t(b))
        own32 = port_unet(tree)(t(a), t(b))
    for name, g, g32, w16, w32 in zip(("f01", "f10"), got, own32, want16,
                                      want32):
        assert g.dtype == torch.float32
        hold_bf16(name, g.numpy(), w16, w32, UNET_BF16_MEAN_TOL)
        own = np.abs(g.numpy() - g32.numpy()).mean()
        assert own >= 0.5 * np.abs(np.asarray(w16) - np.asarray(w32)).mean()


@pytest.mark.parametrize("exact", [True, False])
def test_time_warp_matches_jax(tree, exact):
    a, b = pairs(seed=5)
    f01, f10 = (3.0 * np.asarray(f) for f in
                jax_unet(tree)(jnp.asarray(a), jnp.asarray(b)))
    tw = jax.jit(jax.vmap(JN.time_warp, in_axes=(0, 0, 0, 0, None, None,
                                                   None)),
                 static_argnums=(5, 6))
    for tt in (0.25, 0.5):
        want = tw(*map(jnp.asarray, (a, b, f01, f10)), jnp.float32(tt), 2,
                  exact)
        got = TN.time_warp(*map(t, (a, b, f01, f10)), tt, max_disp=2,
                           exact=exact)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_lk_pair_ops_match_jax():
    keys = blobs(4, H, W, seed=7)
    jk = jnp.asarray(keys)
    want = JF.interpolate_pair(jk[0], jk[1], jnp.float32(0.3), 3, 1)
    got = TF.interpolate_pair(t(keys[:1]), t(keys[1:2]), 0.3, 3, 1)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    want = JF.frame_double_pairs(jk[:3], 3, 1)
    got = TF.frame_double_pairs(t(keys[:3]), 3, 1)
    assert got.shape == (5, H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(got[::2].numpy(), keys[:3])
    want = JF.train_background(jk, 3, 1)
    got = TF.train_background(t(keys), 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_learned_backgrounds_match_jax(tree):
    keys = blobs(3, H, W, seed=9)
    jk = jnp.asarray(keys)
    j_interp = JN.make_learned_interp(JN.FlowUNet(BASE, LEVELS), tree,
                                      max_disp=4)
    t_interp = TN.make_learned_interp(port_unet(tree), max_disp=4)
    want = JF.upsample_background(jk, 4, interp_fn=j_interp)
    got = TF.upsample_background(t(keys), 4, interp_fn=t_interp)
    assert got.shape == (9, H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(got[::4].numpy(), keys)
    # one doubling pass is the rate-4 result's odd half-way frames' source
    np.testing.assert_allclose(
        TF.frame_double_pairs(t(keys), interp_fn=t_interp).numpy(),
        np.asarray(want)[::2], atol=1e-5)
    want = JF.train_background(jk, interp_fn=j_interp)
    got = TF.train_background(t(keys), interp_fn=t_interp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="power of two"):
        TF.upsample_background(t(keys), 3, interp_fn=t_interp)


def triplet_batch(B=2, seed=11):
    """(B, 3, H, W, 3) uint8 triplets: a blob moving over a texture."""
    fr = np.stack([blobs(3, H, W, seed=seed + b) for b in range(B)])
    return np.round(np.clip(fr, 0, 1) * 255).astype(np.uint8)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def test_flow_loss_and_gradients_match_jax(tree):
    jcfg, tcfg = cfgs()
    trip = triplet_batch().astype(np.float32) / 255.0
    model = JN.FlowUNet(BASE, LEVELS)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.flow_loss(model, p, jnp.asarray(trip), jcfg),
        has_aux=True))(tree)
    port = port_unet(tree)
    loss, metrics = TT.flow_loss(port, t(trip), tcfg)
    for k, v in jm.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    grads = torch.autograd.grad(loss, list(port.parameters()))
    names = [n for n, _ in port.named_parameters()]
    got = dict(_leaves(convert.flax_trees(dict(zip(names, grads)))[0]))
    want = dict(_leaves(jax.device_get(jgrads)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (k, err, np.abs(w).max())


@pytest.fixture(scope="module")
def steps(tree):
    """Two train steps of JAX's ``make_flow_train_step`` and the port's
    on uint8 triplets, the port's second step started from JAX's state
    after the first: metrics, parameters after each step, and JAX's
    gradients before each."""
    jcfg, tcfg = cfgs()
    batches = [triplet_batch(seed=13), triplet_batch(seed=17)]
    model = JN.FlowUNet(BASE, LEVELS)
    tx = JT.make_flow_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, host_copy(tree))
    state = JT.FlowTrainState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros((), jnp.int32),
                              key=jax.random.PRNGKey(0))
    step_fn = JT.make_flow_train_step(model, tx, jcfg)
    grad_fn = jax.jit(jax.grad(lambda p, x: JT.flow_loss(
        model, p, x.astype(jnp.float32) / 255.0, jcfg)[0]))
    pstate = TT.create_flow_state(tcfg, "cpu", params=tree)
    pstep = TT.make_flow_train_step(tcfg)
    want = {"metrics": [], "params": [], "grads": []}
    got = {"metrics": [], "params": []}
    for i, raw in enumerate(batches):
        before = host_copy((state.params, state.opt_state))
        want["grads"].append(dict(_leaves(jax.device_get(
            grad_fn(state.params, jnp.asarray(raw))))))
        state, m = step_fn(state, {"frames": jnp.asarray(raw)})
        want["metrics"].append({k: float(v) for k, v in m.items()})
        want["params"].append(dict(_leaves(host_copy(state.params))))
        if i:
            load_adam_state(pstate.opt, pstate.model, *before)
        m = pstep(pstate, {"frames": t(raw)})
        got["metrics"].append({k: float(v) for k, v in m.items()})
        # copies: a CPU tensor's numpy view follows the next update
        got["params"].append({k: v.copy() for k, v in _leaves(
            convert.flax_trees(pstate.model)[0])})
    assert pstate.step == 2 and int(pstate.opt.count) == 2
    return want, got


@pytest.mark.parametrize("step", [0, 1])
def test_train_steps_match_jax(steps, step):
    want, got = steps
    w, g = want["metrics"][step], got["metrics"][step]
    assert sorted(w) == sorted(g)
    for k in w:
        # grad_norm is held as the gradients are
        rtol = 1e-4 if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-7,
                                   err_msg=k)
    assert g["notfinite"] == 0.0
    for k, p in want["params"][step].items():
        # Adam's update lr·mu/(√nu + eps) turns a gradient error within
        # the 1e-4-of-the-leaf tolerance into up to lr where |g| lies
        # below that tolerance or within 100·eps (1e-6)
        gr = want["grads"][step][k]
        near = np.abs(gr) < max(1e-4 * np.abs(gr).max(), 1e-6)
        err = np.abs(got["params"][step][k] - p)
        assert err[~near].max(initial=0) <= 1e-6, (k, err[~near].max())
        assert err[near].max(initial=0) <= 2 * LR, k


def test_initialisation_is_flax_s():
    _, tcfg = cfgs()
    model = TT.create_flow_state(tcfg, "cpu", seed=4).model
    again = TT.create_flow_state(tcfg, "cpu", seed=4).model
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias") or name.startswith("flow_head"):
            assert not p.any(), name
        else:
            std = (1.0 / p[0].numel()) ** 0.5
            assert p.abs().max() <= 2 * std / 0.8796 + 1e-6, name
            assert abs(p.std().item() / std - 1) < 0.25, name


def test_flow_config_loads_like_jax():
    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "flow.yaml")
    assert dataclasses.asdict(TC.load_flow_config(path)) == \
        dataclasses.asdict(JC.load_flow_config(path))
    assert dataclasses.asdict(TC.FlowConfig()) == \
        dataclasses.asdict(JC.FlowConfig())
