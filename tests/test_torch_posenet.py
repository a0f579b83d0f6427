"""The pose head of the PyTorch port against the JAX package: ``PoseNet``
(base 8, 1 block) at an even and an odd size (flax's asymmetric SAME
pads at stride 2), a residual block that changes width, the weight
mapping both ways, ``decode_heatmaps``, ``pose_loss`` and its
gradients, ``random_erase`` on JAX's draws, two train steps with
occlusion, ``extract_folder``'s JSONs and ``PoseNetConfig``.  Weights:
the JAX head's tree filled from a numpy seed, loaded into the port by
``convert.load_flax_params``.

Tolerances (float32): logits and losses 1e-5; gradients 1e-4 of each
leaf's largest; parameters 1e-6, and 2·lr where Adam's update turns a
gradient at rounding level into ±lr (each step from the same state);
keypoints 1e-3 px; the erased images bit for bit.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (fill_tree, host_copy, load_adam_state,  # noqa: F401
                           single_thread, t)
from renderloom.cli import extract_pose as JX
from renderloom.core import config as JC
from renderloom.models import posenet as JN
from renderloom.train import pose as JT
from renderloom_torch import convert
from renderloom_torch.cli import extract_pose as TX
from renderloom_torch.core import config as TC
from renderloom_torch.data import openpose
from renderloom_torch.models import posenet as TN
from renderloom_torch.train import pose as TT

H, W = 32, 48
BASE, BLOCKS = 8, 1
LR = TC.PoseNetConfig().lr


def cfgs(**kw):
    return (JC.PoseNetConfig(base_filters=BASE, blocks=BLOCKS, **kw),
            TC.PoseNetConfig(base_filters=BASE, blocks=BLOCKS, **kw))


@pytest.fixture(scope="module")
def tree():
    shapes = jax.eval_shape(JN.PoseNet(BASE, BLOCKS).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    return fill_tree(shapes["params"], np.random.default_rng(0))


def port_head(tree):
    return convert.load_flax_params(TN.PoseNet(BASE, BLOCKS), tree)


def images(B, h, w, seed):
    return np.random.default_rng(seed).random((B, h, w, 3), np.float32)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.mark.parametrize("size", [(H, W), (33, 47)])
def test_logits_match_jax(tree, size):
    x = images(2, *size, seed=1)
    want = jax.jit(lambda v: JN.PoseNet(BASE, BLOCKS).apply(
        {"params": tree}, v))(jnp.asarray(x))
    model = port_head(tree)
    with torch.no_grad():
        got = model(t(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    back, _ = convert.flax_trees(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_widening_block_matches_jax():
    x = images(1, 16, 24, seed=2)[..., :3]
    block = JN._ResBlock(8)
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    tree = fill_tree(shapes["params"], np.random.default_rng(3))
    assert sorted(tree) == ["Conv_0", "Conv_1", "Conv_2"]
    want = block.apply({"params": tree}, jnp.asarray(x))
    got = convert.load_flax_params(TN._ResBlock(3, 8), tree)(t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def test_decode_heatmaps_matches_jax():
    logits = np.random.default_rng(4).normal(
        scale=0.3, size=(2, 8, 12, TN.N_JOINTS)).astype(np.float32)
    jk, jc = JN.decode_heatmaps(jnp.asarray(logits))
    tk, tc = TN.decode_heatmaps(t(logits))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-3)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)


def poses(B, seed):
    """(B, 19, 3) image-pixel joints inside the frame, some below the
    confidence threshold."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform((4, 4), (W - 4, H - 4), (B, TN.N_JOINTS, 2))
    conf = rng.uniform(0.0, 1.0, (B, TN.N_JOINTS, 1))
    return np.concatenate([xy, conf], -1).astype(np.float32)


def test_pose_loss_and_gradients_match_jax(tree):
    jcfg, tcfg = cfgs()
    x, p = images(2, H, W, seed=5), poses(2, seed=6)
    model = JN.PoseNet(BASE, BLOCKS)
    (_, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda prm: JT.pose_loss(model, prm, jnp.asarray(x), jnp.asarray(p),
                                 jcfg), has_aux=True))(tree)
    port = port_head(tree)
    loss, metrics = TT.pose_loss(port, t(x), t(p), tcfg)
    for k, v in jm.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-5,
                                   err_msg=k)
    grads = torch.autograd.grad(loss, list(port.parameters()))
    names = [n for n, _ in port.named_parameters()]
    got = dict(_leaves(convert.flax_trees(dict(zip(names, grads)))[0]))
    for k, w in _leaves(jax.device_get(jgrads)):
        err = np.abs(got[k] - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (k, err)


def jax_erase_draws(key, B, count, frac):
    """The draws ``renderloom.train.pose.random_erase`` makes from
    ``key``, in the port's layout (``draw_erase``)."""
    out = {"wh": [], "cyx": [], "u": [], "color": []}
    for _ in range(count):
        key, k1, k2, k3, k4 = jax.random.split(key, 5)
        out["wh"].append(jax.random.uniform(k1, (B, 2), minval=0.1,
                                            maxval=max(frac, 0.1)))
        out["cyx"].append(jax.random.uniform(k2, (B, 2)))
        out["u"].append(jax.random.uniform(k3, (B,)))
        out["color"].append(jax.random.uniform(k4, (B, 1, 1, 3))
                            .reshape(B, 3))
    return {k: t(np.stack(v)) for k, v in out.items()}


def test_random_erase_matches_jax_on_its_draws():
    x = images(4, H, W, seed=7)
    key = jax.random.PRNGKey(3)
    want = JT.random_erase(key, jnp.asarray(x), 3, 0.6, 0.4)
    got = TT.apply_erase(t(x), jax_erase_draws(key, 4, 3, 0.4), 0.6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != x).any()
    d = TT.draw_erase(TT.erase_generator(1, 5), 4, 3, 0.4)
    assert {k: tuple(v.shape) for k, v in d.items()} == {
        "wh": (3, 4, 2), "cyx": (3, 4, 2), "u": (3, 4), "color": (3, 4, 3)}
    assert 0.1 <= d["wh"].min() and d["wh"].max() < 0.4
    again = TT.draw_erase(TT.erase_generator(1, 5), 4, 3, 0.4)
    assert all(torch.equal(d[k], again[k]) for k in d)


@pytest.fixture(scope="module")
def steps(tree):
    """Two train steps with occlusion (rate 0.5) of JAX's
    ``make_pose_train_step`` and the port's on uint8 images, the port
    fed JAX's per-step draws (``fold_in(key, step)``) and its second
    step started from JAX's state after the first."""
    jcfg, tcfg = cfgs(occlude_rate=0.5)
    rng = np.random.default_rng(8)
    batches = [{"images": (255 * images(2, H, W, seed=9 + i)).astype(
        np.uint8), "poses": poses(2, seed=11 + i)} for i in range(2)]
    model = JN.PoseNet(BASE, BLOCKS)
    tx = JT.make_pose_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, host_copy(tree))
    key = np.asarray(jax.random.PRNGKey(int(rng.integers(1 << 30))))
    state = JT.PoseTrainState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros((), jnp.int32),
                              key=jnp.array(key))     # the step donates it
    step_fn = JT.make_pose_train_step(model, tx, jcfg)

    def grad_fn(prm, batch, k_aug):
        x = JT.random_erase(k_aug, batch["images"] / 255.0, 2, 0.5, 0.3)
        return JT.pose_loss(model, prm, x, batch["poses"], jcfg)[0]

    grad_fn = jax.jit(jax.grad(grad_fn))
    pstate = TT.create_pose_state(tcfg, "cpu", params=tree)
    pstep = TT.make_pose_train_step(tcfg)
    want = {"metrics": [], "params": [], "grads": []}
    got = {"metrics": [], "params": []}
    for i, raw in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in raw.items()}
        k_aug = jax.random.fold_in(jnp.asarray(key), i)
        before = host_copy((state.params, state.opt_state))
        want["grads"].append(dict(_leaves(jax.device_get(
            grad_fn(state.params, jb, k_aug)))))
        state, m = step_fn(state, jb)
        want["metrics"].append({k: float(v) for k, v in m.items()})
        want["params"].append(dict(_leaves(host_copy(state.params))))
        if i:
            load_adam_state(pstate.opt, pstate.model, *before)
        m = pstep(pstate, {k: t(v) for k, v in raw.items()},
                  jax_erase_draws(k_aug, 2, 2, 0.3))
        got["metrics"].append({k: float(v) for k, v in m.items()})
        got["params"].append({k: v.copy() for k, v in _leaves(
            convert.flax_trees(pstate.model)[0])})
    assert pstate.step == 2
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


def test_extract_folder_matches_jax(tree, tmp_path):
    from PIL import Image

    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(12)
    for i, (h, w) in enumerate([(40, 60), (40, 60), (45, 70)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(frames / f"{i:03d}.png")
    params = jax.tree.map(jnp.asarray, tree)
    n = JX.extract_folder(JN.PoseNet(BASE, BLOCKS), params, str(frames),
                          str(tmp_path / "jax"), H, W, batch=2)
    m = TX.extract_folder(port_head(tree).eval(), str(frames),
                          str(tmp_path / "port"), H, W, batch=2)
    assert n == m == 3
    for f in sorted(os.listdir(tmp_path / "jax")):
        a, b = (json.load(open(tmp_path / d / f))["people"][0]
                for d in ("jax", "port"))
        assert sorted(a) == sorted(b)
        for k in a:
            x, y = np.reshape(a[k], (-1, 3)), np.reshape(b[k], (-1, 3))
            np.testing.assert_allclose(y[:, :2], x[:, :2], atol=1e-3)
            np.testing.assert_allclose(y[:, 2], x[:, 2], atol=1e-5)
    jm, jc, _ = openpose.read_openpose_dir(str(tmp_path / "jax"))
    tm, tc, _ = openpose.read_openpose_dir(str(tmp_path / "port"))
    np.testing.assert_allclose(tm, jm, atol=1e-3 / openpose.DEFAULT_SCALE)
    np.testing.assert_allclose(tc, jc, atol=1e-5)


def test_pose_config_is_jax_s():
    assert dataclasses.asdict(TC.PoseNetConfig()) == \
        dataclasses.asdict(JC.PoseNetConfig())
