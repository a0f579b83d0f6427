"""The layer variants of the PyTorch port (``renderloom_torch/models/
layers.py``: ``NonLocalBlock``, ``PartialConv``, ``ApplyNoise``,
``hyper_conv2d``, ``weight_demodulated_conv2d``, ``LayerNorm2d``,
``HyperSpade``, ``PartialConvBlock``, ``PartialResBlock``,
``PartialConv3d``) against the JAX package's ``renderloom/models/
layers.py:433-726`` on the CPU, forward and backward: stride 1 and 2 on
odd sides, masks with holes, JAX's noise injected, per-sample hyper
weights, masked conditions at another resolution.

Each case runs one jitted JAX ``value_and_grad`` of Σ out·c (c a fixed
random cotangent of the first output) over the parameters and the
differentiable inputs, and the port's backward of the same sum.
Tolerances, float32: every output 1e-5 of its largest magnitude; every
gradient leaf 1e-4 of its largest, but a leaf whose gradient vanishes in
exact arithmetic (a partial conv's bias ahead of an instance norm, once
the mask covers the image), whose JAX gradient lies below 1e-4 of the
module's largest: held below that on both sides.  The variants' instance norms go
through ``InstanceNormFunction`` (K2 and K2b on the card, their twins
here), which the norm cases count.
"""

from typing import Callable, Dict, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import fill_tree, single_thread  # noqa: F401
from renderloom.models import layers as JL
from renderloom_torch import convert
from renderloom_torch.models import layers as TL
from renderloom_torch.ops import norm_kernel as NK

OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _a(shape, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _holes(shape, seed):
    """A single-channel mask, mostly valid, with a few rectangular holes
    (one at a border, one wide enough that a window sees no valid
    pixel)."""
    m = np.ones(shape, np.float32)
    rng = np.random.default_rng(seed)
    sp = shape[1:-1]
    m[(slice(None),) + tuple(slice(0, 2) for _ in sp)] = 0.0
    m[(slice(None),) + tuple(slice(n // 3, n // 3 + 4) for n in sp)] = 0.0
    m *= rng.uniform(size=shape) > 0.1
    return m


def _variables(module, args, kwargs=None, seed=0):
    """The flax module's variables: ``eval_shape`` of its ``init`` filled
    from a numpy seed (``_torch_parity.fill_tree``), the layer norm's γ
    in [0, 1) and β, and the residual scales nonzero."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args, **(kwargs or {})))
    rng = np.random.default_rng(seed)
    out = {k: fill_tree(v, rng) for k, v in shapes.items()}
    p = out.get("params", {})
    for k, v in list(p.items()):
        if k == "gamma":
            p[k] = rng.uniform(0.2, 1.0, v.shape).astype(np.float32)
        elif k == "beta":
            p[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    return out


def _jax_run(fn: Callable, params, inputs: Sequence, ct: np.ndarray):
    """(outputs, grads of params, grads of inputs) of Σ fn(params,
    *inputs)[0]·ct, jitted."""

    def loss(p, xs):
        out = fn(p, *xs)
        outs = out if isinstance(out, tuple) else (out,)
        return jnp.sum(outs[0] * ct), outs

    (_, outs), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, tuple(inputs))
    return jax.tree.map(np.asarray, (outs, gp, gx))


def _port_run(fn: Callable, module, inputs: Sequence, ct: np.ndarray,
              grad_inputs: Sequence[bool]):
    xs = [torch.from_numpy(np.array(x)).requires_grad_(g)
          for x, g in zip(inputs, grad_inputs)]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    (outs[0] * torch.from_numpy(ct)).sum().backward()
    gp = ({n: p.grad for n, p in module.named_parameters()}
          if module is not None else {})
    return ([o.detach().numpy() for o in outs], gp,
            [x.grad.numpy() if g else None
             for x, g in zip(xs, grad_inputs)])


def _close(name, got, want, tol):
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0, name
    err = np.abs(got - want).max() / scale
    assert err <= tol, (name, err)


def _hold(jax_fn, params, port_fn, module, inputs, grad_inputs, seed=9):
    """Run both sides on ``inputs`` and hold outputs, parameter gradients
    (by the flax tree's names) and input gradients; JAX's outputs beyond
    the port's (the non-local block's new ``batch_stats``) are returned
    for the caller to hold."""
    ct_shape = jax.eval_shape(lambda *xs: jax_fn(params, *xs), *inputs)
    ct_shape = ct_shape[0] if isinstance(ct_shape, tuple) else ct_shape
    ct = _a(ct_shape.shape, seed)
    want_out, want_gp, want_gx = _jax_run(jax_fn, params, inputs, ct)
    got_out, got_gp, got_gx = _port_run(port_fn, module, inputs, ct,
                                        grad_inputs)
    assert len(got_out) <= len(want_out)
    for i, (g, w) in enumerate(zip(got_out, want_out)):
        if np.abs(w).max() == 0:
            np.testing.assert_array_equal(g, w, err_msg=f"output {i}")
        else:
            _close(f"output {i}", g, w, OUT_TOL)
    if module is not None:
        want = convert.state_dict_from_flax(want_gp)
        assert set(got_gp) == set(want), (set(got_gp), set(want))
        top = max((float(v.abs().max()) for v in want.values()), default=0)
        for k, v in want.items():
            if float(v.abs().max()) < 1e-4 * top:
                # vanishes in exact arithmetic (a bias under a norm):
                # both sides hold rounding noise
                assert float(got_gp[k].abs().max()) < 1e-4 * top, k
                continue
            _close(f"d{k}", got_gp[k].numpy(), v.numpy(), GRAD_TOL)
    for i, (g, w) in enumerate(zip(got_gx, want_gx)):
        if grad_inputs[i]:
            _close(f"d input {i}", g, w, GRAD_TOL)
    return want_out


class _NormCalls:
    """Counts ``InstanceNormFunction`` applications (the gradient path of
    every instance norm)."""

    def __init__(self, monkeypatch):
        self.n = 0
        apply = NK.InstanceNormFunction.apply

        def counting(*args):
            self.n += 1
            return apply(*args)
        monkeypatch.setattr(NK.InstanceNormFunction, "apply", counting)


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("update_stats", [False, True])
def test_non_local_block(update_stats):
    """Spectral 1×1 convs in the training form, the 2×2 pool dropping
    an odd edge (9×11), γ nonzero; with ``update_stats`` the new ``u``
    matches flax's too."""
    x = _a((2, 9, 11, 16), 1)
    jmod = JL.NonLocalBlock()
    v = _variables(jmod, (x,))
    v["params"]["gamma"] = np.array([0.7], np.float32)
    tmod = TL.enable_spectral_norm(TL.NonLocalBlock(16))
    convert.load_flax_params(tmod, v["params"], v["batch_stats"])

    def jfn(p, x):
        out, new = jmod.apply({"params": p, "batch_stats": v["batch_stats"]},
                              x, update_stats=update_stats,
                              mutable=["batch_stats"])
        return out, new["batch_stats"]

    def tfn(x):
        return tmod(x, update_stats=update_stats)

    outs = _hold(jfn, v["params"], tfn, tmod, [x], [True])
    _, want_stats = convert.flax_trees(tmod)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(a) for k, a in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    got, want = flat(want_stats), flat(outs[1])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("stride", [1, 2])
def test_partial_conv(stride):
    """An odd side (9×11), holes whose windows see no valid pixel (output
    0, no bias), and flax's asymmetric "SAME" at stride 2 for both the
    data conv and the mask count."""
    x, m = _a((2, 9, 11, 4), 2), _holes((2, 9, 11, 1), 3)
    jmod = JL.PartialConv(6, kernel=3, stride=stride)
    v = _variables(jmod, (x, m))
    tmod = TL.PartialConv(4, 6, 3, stride)
    convert.load_flax_params(tmod, v["params"])
    outs = _hold(lambda p, x, m: jmod.apply({"params": p}, x, m),
                 v["params"], tmod, tmod, [x, m], [True, False])
    assert 0 < outs[1].mean() < 1          # the holes reach the output


@pytest.mark.parametrize("kernel", [1, 3])
def test_partial_conv3d(kernel):
    x, m = _a((2, 5, 9, 11, 3), 4), _holes((2, 5, 9, 11, 1), 5)
    for stride in (1, 2):
        jmod = JL.PartialConv3d(5, kernel=kernel, stride=stride)
        v = _variables(jmod, (x, m))
        tmod = TL.PartialConv3d(3, 5, kernel, stride)
        convert.load_flax_params(tmod, v["params"])
        outs = _hold(lambda p, x, m: jmod.apply({"params": p}, x, m),
                     v["params"], tmod, tmod, [x, m], [True, False])
        assert 0 < outs[1].mean() < 1


def test_apply_noise_with_jax_noise(monkeypatch):
    """JAX's draw from its key, injected as the port's generator's draw;
    without a generator the input passes through."""
    x = _a((2, 7, 9, 4), 6)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, (2, 7, 9, 1)))
    jmod = JL.ApplyNoise()
    params = {"scale": np.array([0.6], np.float32)}
    tmod = TL.ApplyNoise()
    convert.load_flax_params(tmod, params)
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(TL, "noise_like", lambda x, g: torch.from_numpy(
        noise) if g is gen else None)
    _hold(lambda p, x: jmod.apply({"params": p}, x, key), params,
          lambda x: tmod(x, gen), tmod, [x], [True])
    assert torch.equal(tmod(torch.from_numpy(x)), torch.from_numpy(x))


def test_apply_noise_draws_from_the_generator():
    x = torch.zeros(2, 5, 6, 3)
    mod = TL.ApplyNoise()
    with torch.no_grad():
        mod.weight.fill_(1.0)
    a = mod(x, torch.Generator().manual_seed(4))
    b = mod(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and a.shape == x.shape
    assert torch.equal(a[..., 0], a[..., 2]) and a.std() > 0.5


@pytest.mark.parametrize("stride,kernel", [(1, 3), (2, 3), (2, 4)])
def test_hyper_conv2d_per_sample_weights(stride, kernel):
    x = _a((3, 9, 11, 4), 7)
    k = 0.3 * _a((3, kernel, kernel, 4, 6), 8)
    b = _a((3, 6), 9)
    _hold(lambda p, x, k, b: JL.hyper_conv2d(x, k, b, stride), {},
          lambda x, k, b: TL.hyper_conv2d(x, k, b, stride), None,
          [x, k, b], [True, True, True])


@pytest.mark.parametrize("stride", [1, 2])
def test_weight_demodulated_conv2d(stride):
    x = _a((2, 9, 11, 4), 10)
    k = _a((3, 3, 4, 5), 11)
    style = _a((2, 4), 12, 0.5, 2.0)
    _hold(lambda p, x, k, s: JL.weight_demodulated_conv2d(x, k, s,
                                                          stride=stride),
          {}, lambda x, k, s: TL.weight_demodulated_conv2d(x, k, s,
                                                           stride=stride),
          None, [x, k, style], [True, True, True])


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_2d(affine):
    x = 1.5 + 2.0 * _a((3, 5, 7, 6), 13)
    jmod = JL.LayerNorm2d(affine=affine)
    v = _variables(jmod, (x,)) if affine else {"params": {}}
    tmod = TL.LayerNorm2d(6, affine=affine)
    if affine:
        convert.load_flax_params(tmod, v["params"])
    _hold(lambda p, x: jmod.apply({"params": p}, x), v["params"], tmod,
          tmod, [x], [True])


def test_layer_norm_2d_init():
    mod = TL.LayerNorm2d(64)
    assert (mod.gamma >= 0).all() and (mod.gamma < 1).all()
    assert mod.gamma.std() > 0.1 and (mod.beta == 0).all()


@pytest.mark.parametrize("hyper", [True, False])
def test_hyper_spade(hyper, monkeypatch):
    """Condition 0 at a lower resolution (nearest), through per-sample
    hyper weights or its own conv; condition 1 masked by a mask at
    another resolution (JAX's antialiased linear resize); a missing
    condition 2.  The non-affine norm goes through
    ``InstanceNormFunction``."""
    B, H, W, C = 2, 10, 12, 4
    x = _a((B, H, W, C), 14)
    cond0, cond1 = _a((B, 5, 6, 3), 15), _a((B, H, W, 5), 16)
    mask1 = _a((B, 4, 5, 1), 17, 0.0, 1.0)
    kern = 0.2 * _a((B, 3, 3, 3, 2 * C), 18)
    bias = 0.1 * _a((B, 2 * C), 19)
    nw = (kern, bias) if hyper else None
    jmod = JL.HyperSpade(features=C, kernel=3)
    conds = lambda c0, c1, m1: [c0, (c1, m1), None]
    v = _variables(jmod, (x, conds(cond0, cond1, mask1)),
                   {"norm_weights": nw})
    tmod = TL.HyperSpade(C, [3, 5, None], 3, hyper=hyper)
    convert.load_flax_params(tmod, v["params"])
    calls = _NormCalls(monkeypatch)
    if hyper:
        _hold(lambda p, x, c0, c1, m1, k, b: jmod.apply(
                  {"params": p}, x, conds(c0, c1, m1), norm_weights=(k, b)),
              v["params"],
              lambda x, c0, c1, m1, k, b: tmod(x, conds(c0, c1, m1), (k, b)),
              tmod, [x, cond0, cond1, mask1, kern, bias],
              [True, True, True, False, True, True])
    else:
        _hold(lambda p, x, c0, c1, m1: jmod.apply(
                  {"params": p}, x, conds(c0, c1, m1)),
              v["params"], lambda x, c0, c1, m1: tmod(x, conds(c0, c1, m1)),
              tmod, [x, cond0, cond1, mask1], [True, True, True, False])
    assert calls.n == 1


@pytest.mark.parametrize("stride,norm,activation", [
    (1, "instance", "leaky"), (2, "instance", "none"), (2, "none", "leaky")])
def test_partial_conv_block(stride, norm, activation, monkeypatch):
    x, m = _a((2, 9, 11, 3), 20), _holes((2, 9, 11, 1), 21)
    jmod = JL.PartialConvBlock(6, stride=stride, norm=norm,
                               activation=activation)
    v = _variables(jmod, (x, m))
    tmod = TL.PartialConvBlock(3, 6, 3, stride, norm, activation)
    convert.load_flax_params(tmod, v["params"])
    calls = _NormCalls(monkeypatch)
    _hold(lambda p, x, m: jmod.apply({"params": p}, x, m), v["params"],
          tmod, tmod, [x, m], [True, False])
    assert calls.n == (norm == "instance")


@pytest.mark.parametrize("in_ch", [3, 6])
def test_partial_res_block(in_ch, monkeypatch):
    """With a 1×1 partial-conv shortcut (3 → 6 channels) and with the
    identity (6 → 6)."""
    x, m = _a((2, 9, 11, in_ch), 22), _holes((2, 9, 11, 1), 23)
    jmod = JL.PartialResBlock(6)
    v = _variables(jmod, (x, m))
    tmod = TL.PartialResBlock(in_ch, 6)
    convert.load_flax_params(tmod, v["params"])
    assert hasattr(tmod, "pconv_s") == (in_ch != 6)
    calls = _NormCalls(monkeypatch)
    _hold(lambda p, x, m: jmod.apply({"params": p}, x, m), v["params"],
          tmod, tmod, [x, m], [True, False])
    assert calls.n == 2


def test_flax_trees_round_trip_the_variants():
    """``convert.flax_trees`` gives back the trees the variants loaded:
    3-D kernels, γ/β, the noise scale."""
    mods = {"pc3": (TL.PartialConv3d(3, 5), JL.PartialConv3d(5),
                    (_a((1, 3, 5, 5, 3), 0), np.ones((1, 3, 5, 5, 1),
                                                     np.float32))),
            "ln": (TL.LayerNorm2d(6), JL.LayerNorm2d(), (_a((1, 4, 4, 6),
                                                            1),)),
            "noise": (TL.ApplyNoise(), JL.ApplyNoise(), (_a((1, 4, 4, 2),
                                                            2),))}
    for name, (tmod, jmod, args) in mods.items():
        params = _variables(jmod, args)["params"]
        convert.load_flax_params(tmod, params)
        back, _ = convert.flax_trees(tmod)
        flat = lambda t: {jax.tree_util.keystr(k): np.asarray(a) for k, a in
                          jax.tree_util.tree_flatten_with_path(t)[0]}
        assert flat(back).keys() == flat(params).keys(), name
        for k, a in flat(params).items():
            np.testing.assert_array_equal(flat(back)[k], a, err_msg=k)
