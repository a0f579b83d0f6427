"""Training-mode layers of the PyTorch port against the JAX package:
spectral norm's power step and ``u`` update against flax
``SpectralNorm``, the instance norm's gradient (the plain twin of the
CUDA backward ``csrc/instance_norm.cu`` and the ``autograd.Function``
that carries it) against ``jax.vjp`` of ``layers.instance_norm``, and
the tiny-width generator's train-mode forward with its ``batch_stats``
update.

Tolerances: 1e-5 per op in float32, 1e-4 for the whole generator
(float32 convolutions summed in another order through ~20 layers);
gradients of sums over a few thousand elements 1e-4 relative; the
mean-4096/std-1e-2 gradient 2e-3 absolute, the same allowance as its
forward in tests/test_layers_extra.py.
"""

import dataclasses

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
from renderloom.models.renderer import Generator as JGenerator
from renderloom_torch import convert
from renderloom_torch.models import layers as TL
from renderloom_torch.models.renderer import Generator
from renderloom_torch.ops import norm_kernel

H, W = 32, 48


def _x(shape, seed, loc=0.0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (loc + scale * rng.normal(size=shape)).astype(np.float32)


# ---------------------------------------------------------------- spectral


@pytest.mark.parametrize("kernel,stride", [(3, 1), (4, 2), (1, 1)])
def test_spectral_norm_two_calls_match_flax(kernel, stride):
    """Two consecutive update_stats calls: outputs, u and σ after each."""
    x = _x((2, 9, 11, 5), 0)
    jconv = JL.SNConv(7, kernel=kernel, stride=stride, spectral=True)
    variables = jconv.init(jax.random.PRNGKey(1), jnp.asarray(x))
    conv = TL.enable_spectral_norm(TL.SNConv(5, 7, kernel, stride))
    convert.load_flax_params(conv, jax.device_get(variables["params"]),
                             jax.device_get(variables["batch_stats"]))
    stats = variables["batch_stats"]
    for call in range(2):
        want, new = jconv.apply({"params": variables["params"],
                                 "batch_stats": stats}, jnp.asarray(x),
                                update_stats=True, mutable=["batch_stats"])
        stats = new["batch_stats"]
        with torch.no_grad():
            got = conv(t(x), update_stats=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   err_msg=f"call {call}")
        sn = stats["sn"]
        np.testing.assert_allclose(conv.sn_u.numpy(),
                                   np.asarray(sn["conv/kernel/u"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(conv.sn_sigma.numpy(),
                                   np.asarray(sn["conv/kernel/sigma"]),
                                   rtol=1e-5)
    # without update_stats the state stays, the output still divides by σ
    u = conv.sn_u.clone()
    conv(t(x))
    assert torch.equal(conv.sn_u, u)


def test_spectral_norm_gradient_matches_flax():
    """σ carries the gradient into the kernel; u and v do not."""
    x = _x((2, 6, 8, 3), 2)
    jconv = JL.SNConv(4, kernel=3, spectral=True)
    variables = jconv.init(jax.random.PRNGKey(3), jnp.asarray(x))

    def loss(p):
        y = jconv.apply({"params": p, "batch_stats":
                         variables["batch_stats"]}, jnp.asarray(x),
                        update_stats=False)
        return jnp.sum(jnp.sin(y))

    want = jax.grad(loss)(variables["params"])["conv"]["kernel"]
    conv = TL.enable_spectral_norm(TL.SNConv(3, 4, 3))
    convert.load_flax_params(conv, jax.device_get(variables["params"]),
                             jax.device_get(variables["batch_stats"]))
    torch.sin(conv(t(x))).sum().backward()
    np.testing.assert_allclose(
        conv.conv.weight.grad.numpy().transpose(2, 3, 1, 0),
        np.asarray(want), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------- instance norm grad


def _jax_norm_vjp(x, dy, scale, bias, leaky):
    def f(x, s, b):
        y = JL.instance_norm(x, scale=s, bias=b)
        return JL.leaky(y) if leaky else y

    args = (jnp.asarray(x), None if scale is None else jnp.asarray(scale),
            None if bias is None else jnp.asarray(bias))
    _, vjp = jax.vjp(f, *args)
    return [None if g is None else np.asarray(g)
            for g in vjp(jnp.asarray(dy))]


@pytest.mark.parametrize("affine,leaky", [(False, False), (True, False),
                                          (True, True), (False, True)])
def test_bwd_twin_matches_jax_vjp(affine, leaky):
    x = _x((2, 8, 12, 6), 0, loc=1.5)
    dy = _x((2, 8, 12, 6), 1)
    rng = np.random.default_rng(2)
    s = (1.0 + 0.5 * rng.normal(size=6)).astype(np.float32) if affine \
        else None
    b = rng.normal(size=6).astype(np.float32) if affine else None
    slope = JL.LEAKY_SLOPE if leaky else None
    want = _jax_norm_vjp(x, dy, s, b, leaky)
    ts, tb = (t(s), t(b)) if affine else (None, None)
    _, stats = norm_kernel._plain_forward(t(x), ts, tb, slope, 1e-5)
    got = norm_kernel.instance_norm_bwd_plain(t(x), t(dy), stats, ts, tb,
                                              slope)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-5)
    if affine:
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)
    else:
        assert got[1] is None and got[2] is None


def test_bwd_twin_large_mean():
    """mean 4096, std 1e-2 (the forward case of
    tests/test_layers_extra.py): the shifted residuals keep x̂ exact
    enough for the gradient too."""
    x = _x((2, 24, 32, 8), 0, loc=4096.0, scale=1e-2)
    dy = _x((2, 24, 32, 8), 1)
    want = _jax_norm_vjp(x, dy, None, None, False)[0]
    _, stats = norm_kernel._plain_forward(t(x), None, None, None, 1e-5)
    got = norm_kernel.instance_norm_bwd_plain(t(x), t(dy), stats)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("slope", [None, JL.LEAKY_SLOPE])
def test_instance_norm_module_gradient_goes_through_the_function(slope):
    """The port's InstanceNorm records InstanceNormFunction, whose
    backward is the K2b twin here (K2b on the card), and its gradients
    reach x, γ and β with autograd's values through the plain forward."""
    x = t(_x((2, 6, 7, 5), 3, loc=0.5)).requires_grad_()
    dy = t(_x((2, 6, 7, 5), 4))
    norm = TL.InstanceNorm(5)
    with torch.no_grad():
        norm.weight.add_(t(_x((5,), 5, scale=0.3)))
        norm.bias.add_(t(_x((5,), 6)))
    y = norm(x, slope)
    assert type(y.grad_fn).__name__ == "InstanceNormFunctionBackward"
    got = torch.autograd.grad(y, (x, norm.weight, norm.bias), dy)
    x2 = x.detach().clone().requires_grad_()
    w2 = norm.weight.detach().clone().requires_grad_()
    b2 = norm.bias.detach().clone().requires_grad_()
    want = torch.autograd.grad(
        norm_kernel.instance_norm_plain(x2, w2, b2, slope), (x2, w2, b2), dy)
    for g, w in zip(got, want):
        assert g is not None
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("affine,slope", [(False, None), (True, None),
                                          (True, 0.2)])
def test_function_gradcheck_float64(affine, slope):
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(size=(2, 4, 5, 3)), requires_grad=True)
    s = torch.tensor(1 + 0.3 * rng.normal(size=3), requires_grad=True) \
        if affine else None
    b = torch.tensor(rng.normal(size=3), requires_grad=True) \
        if affine else None
    assert torch.autograd.gradcheck(
        lambda *a: norm_kernel.InstanceNormFunction.apply(*a, slope, 1e-5),
        (x, s, b))


def test_bwd_cuda_wrapper_refuses_cpu_tensors():
    x = t(_x((1, 4, 4, 3), 8))
    _, stats = norm_kernel._plain_forward(x, None, None, None, 1e-5)
    before = norm_kernel.instance_norm_bwd_cuda.launches
    with pytest.raises(ValueError):
        norm_kernel.instance_norm_bwd_cuda(x, x, stats)
    assert norm_kernel.instance_norm_bwd_cuda.launches == before


# ------------------------------------------------------------- generator


@pytest.fixture(scope="module")
def trees():
    return generator_trees(renderer_cfg(JC, H, W), H, W)


def _gen_inputs(B, seed):
    rng = np.random.default_rng(seed)
    label = rng.uniform(-1, 1, (B, H, W, 22)).astype(np.float32)
    imgs = rng.uniform(-1, 1, (2, B, H, W, 3)).astype(np.float32)
    return label, imgs[0], imgs[1]


def _train_generator(trees, remat: bool, dtype=torch.float32):
    cfg = renderer_cfg(TC, H, W)
    gen = Generator(dataclasses.replace(cfg.gen, do_checkpoint=remat),
                    dtype)
    TL.enable_spectral_norm(gen)
    return convert.load_flax_params(gen, *trees)


def test_generator_train_forward_and_stats_match_jax(trees):
    params, stats = trees
    jcfg = renderer_cfg(JC, H, W)
    label, back, prev = _gen_inputs(2, 1)
    (img_w, mask_w), new = jax.jit(lambda p, s: JGenerator(jcfg.gen).apply(
        {"params": p, "batch_stats": s}, label, label, back, prev,
        update_stats=True, mutable=["batch_stats"]))(params, stats)
    gen = _train_generator(trees, remat=False)
    with torch.no_grad():
        img, mask = gen(t(label), t(label), t(back), t(prev),
                        update_stats=True)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_w), atol=1e-4)
    np.testing.assert_allclose(mask.numpy(), np.asarray(mask_w), atol=1e-4)
    got_p, got_s = convert.flax_trees(gen)
    want_s = dict(jax.tree_util.tree_flatten_with_path(
        jax.device_get(new["batch_stats"]))[0])
    got_s = dict(jax.tree_util.tree_flatten_with_path(got_s)[0])
    assert want_s.keys() == got_s.keys() and len(got_s) > 40
    moved = 0
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=1e-4,
                                   atol=1e-5, err_msg=str(k))
        flat_in = dict(jax.tree_util.tree_flatten_with_path(stats)[0])
        moved += not np.allclose(got_s[k], flat_in[k])
    assert moved > 20
    # the reverse bridge gives back the tree that was loaded
    for (kp, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got_p)[0],
            jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(kp))


def test_remat_generator_same_gradients_and_one_u_update(trees):
    """do_checkpoint recomputes the SPADE branches in the backward: the
    gradients equal the plain run's and every u moved exactly once."""
    label, back, prev = (t(a) for a in _gen_inputs(1, 2))
    runs = []
    for remat in (False, True):
        gen = _train_generator(trees, remat)
        img, mask = gen(label, label, back, prev, update_stats=True)
        (img.square().mean() + mask.mean()).backward()
        grads = {n: p.grad.clone() for n, p in gen.named_parameters()}
        us = {n: b.clone() for n, b in gen.named_buffers()}
        runs.append((grads, us))
    (g0, u0), (g1, u1) = runs
    assert g0.keys() == g1.keys() and u0.keys() == u1.keys()
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=n)
    for n in u0:
        assert torch.equal(u0[n], u1[n]), n


def test_remat_generator_bf16_same_gradients_and_one_u_update(trees):
    """In bf16 compute the recomputed SPADE branches give the forward's
    bits (the r3centered norm's sums have one order), so do_checkpoint
    gives the plain run's gradients bit for bit, in float32 on the
    float32 parameters, and moves every u exactly once."""
    label, back, prev = (t(a).bfloat16() for a in _gen_inputs(1, 2))
    runs = []
    for remat in (False, True):
        gen = _train_generator(trees, remat, torch.bfloat16)
        img, mask = gen(label, label, back, prev, update_stats=True)
        assert img.dtype == mask.dtype == torch.bfloat16
        (img.float().square().mean() + mask.float().mean()).backward()
        grads = {n: p.grad.clone() for n, p in gen.named_parameters()}
        assert all(g.dtype == torch.float32 for g in grads.values())
        runs.append((grads, {n: b.clone() for n, b in gen.named_buffers()}))
    (g0, u0), (g1, u1) = runs
    assert g0.keys() == g1.keys() and u0.keys() == u1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for n in u0:
        assert torch.equal(u0[n], u1[n]), n
