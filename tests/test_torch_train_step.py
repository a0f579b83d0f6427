"""One GAN train step of the PyTorch port against the JAX package's
``make_gan_train_step`` on the same prepared batch (B = 2, L = 3 — one
trained frame — at 64×96), the same tiny-width G and D weights and
power-iteration state, and the JAX package's random VGG tree.

Tolerances:
* d/* metrics 1e-4 relative: the D losses read G's forward (1e-4 per
  model) through the discriminators;
* g/* metrics 1e-3 relative: they read the *updated* D.  AMSGrad's
  first step with b1 = 0 moves every parameter by lr·g/(|g| + ε), about
  ±lr whatever |g| is, so a D gradient element near 0 whose sign
  differs between the two implementations moves its weight by 2·lr the
  other way, and the G losses see that;
* the step's gradients, read from each optimizer's first moment: every
  leaf within 2e-4 of that leaf's largest |g| (measured: 6.0e-5 for G,
  2.1e-5 for D).  This is the check of magnitudes: a dropped loss
  weight or a dγ scaled by B fails it, while the parameters below see
  little more than each gradient's sign.  A leaf whose gradient
  vanishes in exact arithmetic (see ``_vanishing``) holds only rounding
  noise and is held below 1e-4 of the net's largest gradient instead;
* parameters after the step: AMSGrad's first step moves a parameter by
  lr·g/(|g| + 1e-8), so JAX's own update tells |g|.  Where JAX's
  |g| ≥ 1e-6 (its update at least 0.99·lr) the port's parameter is
  within 1e-5 of JAX's.  The rest — the vanishing leaves, whose noise a
  sign step turns into up to ±lr, and elements with |g| < 1e-6 — are
  held to 2·lr (plus 1e-5), and are at most 2% of G's elements and 5%
  of D's (measured: 0.57% and 0.80%);
* power-iteration state 1e-4.

The batch is one where float32 rounding puts no activation across a
leaky kink: of four blob layouts tried, three had one element within
rounding of 0 (3e-7 in one) whose sign the two sides round apart, which
moves that element's gradient by 0.8·g and the leaves below it by up to
5e-3 of their largest |g|.  That is float32, not the port: the same
port in float64 agrees with JAX's float32 gradients there to 6e-5.

The same step in bf16 compute (``compute_dtype: bfloat16``: G, D and
VGG19 in bf16 on float32 parameters) against JAX's bf16 step.  Two bf16
evaluations that round at other places differ by rounding noise the
random-weight networks amplify: JAX's own bf16 gradients lie a median
0.26 (G) and 0.20 (D) of each leaf's largest from its float32 ones, and
its d/face metric 10% from float32's.  So bf16 is held as serving is
(``_torch_parity.hold_bf16``'s two conditions), on vectors normalized
by the JAX float32 step: the metrics each over |its float32 value|, the
gradients of the leaves above 1e-4 of their network's largest (float32)
each over its float32 largest |g|.  (1) the mean |port − JAX bf16|
within about 1.35× the port's reading (``BF16_MEAN_TOL``: metrics
3.08e-3, G 3.04e-2, D 2.10e-2); (2) the largest distance to JAX float32
at most 1.5× JAX bf16's own + 1e-3.  Control (``tests/_bf16_controls.py
train``): the port in float32 reads 1.43e-2, 4.48e-2 and 5.62e-2, beyond
each limit; a planted gradient fault in the norm (the shifted
contract's backward at the bf16 norms) reads as the sound port, which
only the norm's own check (``tests/test_torch_bf16.py``) sees.  The
leaves whose float32 gradient vanishes hold bf16 noise in both
implementations (up to 1.8e-3 of the net's largest here): each within
1.5× JAX bf16's largest + 1e-4 of the net's largest (reading 1.0×).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import (fill_tree, generator_trees, hold_bf16,  # noqa: F401
                           renderer_cfg, single_thread, t)
from renderloom.models.discriminator import DiscriminatorSet as JDis
from renderloom.models.perceptual import PerceptualLoss as JPerceptual
from renderloom.models.renderer import Generator as JGenerator
from renderloom.train import gan as JG
from renderloom_torch import convert
from renderloom_torch.train import gan as TG

H, W, B, L = 64, 96, 2, 3


def cfg(C):
    tiny = lambda n, layers=2: C.PatchDiscConfig(
        num_filters=4, max_num_filters=16, num_discriminators=n,
        num_layers=layers)
    # the hand crops are 8×8 at this height: with two more 4×4 layers the
    # last norm would see a 1×1 map, return its bias and pass no gradient
    return dataclasses.replace(
        renderer_cfg(C, H, W),
        dis=C.DiscriminatorConfig(image=tiny(2), face=tiny(1),
                                  hand=tiny(1, layers=1)))


def _blob(cy, cx, sigma=3.0):
    yy, xx = np.mgrid[0:H, 0:W]
    return np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma ** 2))


def make_batch(seed=0):
    """A prepared batch whose labels have face and hand heatmaps (the
    crops find them; one window lacks its left hand) and a blob in every
    other heatmap, so that no input channel of G or D is zero and every
    kernel weight gets a gradient."""
    rng = np.random.default_rng(seed)
    label = rng.uniform(-1, 1, (B, L, H, W, 22)).astype(np.float32)
    label[..., 3:] = 0.0
    for b in range(B):
        for f in range(L):
            label[b, f, ..., 3] = _blob(16 + 2 * f, 40 + 10 * b)
            for c in range(4, 20):
                label[b, f, ..., c] = _blob((3 * c + 5 * f + 4) % H,
                                            (23 * c + 5 * b + 9) % W)
            label[b, f, ..., 20] = _blob(40, 20 + f)
            if b == 0:
                label[b, f, ..., 21] = _blob(44, 70 - f)
    fg = np.zeros((B, L, H, W, 1), np.float32)
    fg[:, :, 8:56, 24:72] = 1.0
    return {"label": label,
            "image": rng.uniform(-1, 1, (B, L, H, W, 3)).astype(np.float32),
            "back": rng.uniform(-1, 1, (B, L, H, W, 3)).astype(np.float32),
            "fg_mask": fg}


def make_trees():
    """The G and D flax trees both sides start from."""
    jcfg = cfg(JC)
    params_g, stats_g = generator_trees(jcfg, H, W)
    z = lambda c: jnp.zeros((1, H, W, c))
    shapes = jax.eval_shape(JDis(jcfg.dis).init, jax.random.PRNGKey(0),
                            z(22), z(3), z(3), z(3), z(1))
    rng = np.random.default_rng(1)
    return {"params_g": params_g, "stats_g": stats_g,
            "params_d": fill_tree(shapes["params"], rng),
            "stats_d": fill_tree(shapes["batch_stats"], rng)}


def jax_step(trees, compute_dtype="float32"):
    """One JAX step on ``trees`` and :func:`make_batch` in
    ``compute_dtype``: (state before, state after, metrics, the VGG19
    tree)."""
    jcfg = dataclasses.replace(cfg(JC), compute_dtype=compute_dtype)
    jdt = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    tx_g, tx_d = JG.make_gan_optimizers(jcfg)
    state = JG.GanTrainState(
        params_g=trees["params_g"], params_d=trees["params_d"],
        stats_g=trees["stats_g"], stats_d=trees["stats_d"],
        opt_g=tx_g.init(trees["params_g"]), opt_d=tx_d.init(trees["params_d"]),
        step=jnp.zeros((), jnp.int32), key=jax.random.PRNGKey(0))
    perceptual = JPerceptual(compute_dtype=compute_dtype)
    step = JG.make_gan_train_step(JGenerator(jcfg.gen, jdt),
                                  JDis(jcfg.dis, jdt), (tx_g, tx_d), jcfg,
                                  perceptual)
    batch = make_batch()
    before = jax.tree.map(np.array, state)
    new_state, metrics = step(state, batch)
    return (before, jax.device_get(new_state),
            {k: float(v) for k, v in metrics.items()},
            jax.device_get(perceptual.variables["params"]))


def port_step(trees, vgg_params, compute_dtype="float32"):
    """The port's step on the same: (state after, metrics)."""
    tcfg = dataclasses.replace(cfg(TC), compute_dtype=compute_dtype)
    tstate = TG.create_gan_state(tcfg, "cpu", trees=trees)
    vgg = TG.make_perceptual(tcfg, "cpu", params=vgg_params)
    tmetrics = TG.make_gan_train_step(tcfg, vgg)(
        tstate, {k: t(v) for k, v in make_batch().items()})
    return tstate, {k: float(v) for k, v in tmetrics.items()}


def run_steps(trees, compute_dtype="float32"):
    """(JAX state before, JAX state after, JAX metrics, port state
    after, port metrics) of one step in ``compute_dtype``."""
    before, after, metrics, vgg = jax_step(trees, compute_dtype)
    return (before, after, metrics) + port_step(trees, vgg, compute_dtype)


@pytest.fixture(scope="module")
def trees():
    return make_trees()


@pytest.fixture(scope="module")
def steps(trees):
    return run_steps(trees)


@pytest.fixture(scope="module")
def bf16_steps(trees):
    return run_steps(trees, "bfloat16")


def test_metrics_match_jax(steps):
    _, _, want, _, got = steps
    assert got.keys() == want.keys()
    for k in want:
        tol = 1e-4 if k.startswith("d/") else 1e-3
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=1e-6,
                                   err_msg=k)
    assert got["notfinite/g"] == got["notfinite/d"] == 0.0
    assert got["g/perc"] > 0 and got["d/hand"] > 0


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_grads(module, opt):
    """The gradient the port's step applied, per flax leaf: AMSGrad's
    ``mu`` after one update is (1 − b1)·g.  The parameters are views of
    ``opt.flat``, so ``mu`` is read through the module's names (copied
    out: on the CPU the exported arrays share the buffer)."""
    saved = opt.flat.clone()
    opt.flat.copy_(opt.mu / (1 - opt.b1))
    try:
        return {k: v.copy() for k, v in
                _flat(convert.flax_trees(module)[0]).items()}
    finally:
        opt.flat.copy_(saved)


def _jax_grads(after, net, b1):
    """The gradient JAX's step applied, from its AMSGrad ``mu``."""
    mu = getattr(after, f"opt_{net}").inner_state[0].mu
    return {k: v / (1 - b1) for k, v in _flat(mu).items()}


def _vanishing(grads):
    """Leaves whose JAX gradient is below 1e-4 of the net's largest: the
    biases whose gradient is 0 in exact arithmetic, so that both sides
    hold only rounding noise — a conv bias ahead of an instance norm
    (which removes any per-channel constant), and a D head's bias while
    every logit lies inside the hinge margin (the real and the fake term
    cancel)."""
    top = max(np.abs(v).max() for v in grads.values())
    return {k for k, v in grads.items() if np.abs(v).max() < 1e-4 * top}


@pytest.mark.parametrize("net", ["g", "d"])
def test_gradients_of_the_step_match_jax(steps, net):
    """The gradient of each leaf within 2e-4 of that leaf's largest |g|
    (measured: at most 8.6e-5; the gradients read the G forward, 1e-4
    per model, and G's goes through the updated D).  The parameter check
    below sees little more than each gradient's sign, since AMSGrad's
    first step is about ±lr, so this is the check that fails a backward
    with wrong magnitudes.  A vanishing leaf is held to 1e-4 of the net's
    largest gradient on both sides."""
    _, after, _, tstate, _ = steps
    module = tstate.gen if net == "g" else tstate.dis
    got = _port_grads(module, getattr(tstate, f"opt_{net}"))
    want = _jax_grads(after, net, tstate.opt_g.b1)
    assert got.keys() == want.keys()
    top = max(np.abs(v).max() for v in want.values())
    vanishing = _vanishing(want)
    assert all(k.endswith("['bias']") and "norm" not in k
               for k in vanishing), sorted(vanishing)
    assert len(vanishing) < len(want) // 3
    for k in want:
        if k in vanishing:
            assert np.abs(got[k]).max() < 1e-4 * top, k
            continue
        err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert err <= 2e-4, (k, err)


@pytest.mark.parametrize("net,lr,small_share", [("g", 1e-4, 0.02),
                                               ("d", 4e-4, 0.05)])
def test_parameters_and_stats_after_the_step_match_jax(steps, net, lr,
                                                       small_share):
    before, after, _, tstate, _ = steps
    module = tstate.gen if net == "g" else tstate.dis
    got_p, got_s = (_flat(x) for x in convert.flax_trees(module))
    want_p = _flat(getattr(after, f"params_{net}"))
    old_p = _flat(getattr(before, f"params_{net}"))
    want_s = _flat(getattr(after, f"stats_{net}"))
    assert got_p.keys() == want_p.keys() and got_s.keys() == want_s.keys()
    vanishing = _vanishing(_jax_grads(after, net, tstate.opt_g.b1))
    n_small = n_all = 0
    for k in want_p:
        diff = np.abs(got_p[k] - want_p[k])
        assert diff.max() <= 2 * lr + 1e-5, (k, diff.max())
        # |g| ≥ 1e-6 ⇔ JAX's |update| ≥ lr·1e-6 / (1e-6 + 1e-8)
        large = np.abs(want_p[k] - old_p[k]) >= 0.99 * lr
        if k in vanishing:
            large[...] = False
        assert (diff[large] <= 1e-5).all(), (k, diff[large].max())
        n_small += int((~large).sum())
        n_all += diff.size
    assert n_small <= small_share * n_all, (n_small, n_all)
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert int(getattr(tstate, f"opt_{net}").count) == 1


# ---------------------------------------------------------------------------
# the step in bf16 compute
# ---------------------------------------------------------------------------

# about 1.35x the port's readings (module docstring)
BF16_MEAN_TOL = {"metrics": 4.2e-3, "g": 4.1e-2, "d": 2.8e-2}


def bf16_metric_vectors(steps, bf16_steps):
    """(port bf16, JAX bf16, JAX float32) metrics, each over |JAX
    float32|, the skip counters left out."""
    want32, (_, _, want, _, got) = steps[2], bf16_steps
    keys = [k for k in want32 if not k.startswith("notfinite")]
    vec = lambda m: np.array([m[k] / abs(want32[k]) for k in keys])
    return vec(got), vec(want), vec(want32)


def bf16_grad_vectors(steps, bf16_steps, net):
    """(port bf16, JAX bf16, JAX float32) gradients of the leaves whose
    float32 gradient does not vanish, each over its float32 largest |g|,
    concatenated; and the vanishing leaves' (port, JAX bf16) largest |g|
    over the net's largest float32 |g|."""
    tstate = bf16_steps[3]
    got = _port_grads(tstate.gen if net == "g" else tstate.dis,
                      getattr(tstate, f"opt_{net}"))
    b1 = tstate.opt_g.b1
    want = _jax_grads(bf16_steps[1], net, b1)
    want32 = _jax_grads(steps[1], net, b1)
    vanishing = _vanishing(want32)
    top = max(np.abs(v).max() for v in want32.values())
    keep = [k for k in want32 if k not in vanishing]
    vec = lambda g: np.concatenate([(g[k] / np.abs(want32[k]).max()).ravel()
                                    for k in keep])
    noise = {k: (np.abs(got[k]).max() / top, np.abs(want[k]).max() / top)
             for k in vanishing}
    return vec(got), vec(want), vec(want32), noise


def test_bf16_metrics_match_jax(steps, bf16_steps):
    got, want, want32 = bf16_metric_vectors(steps, bf16_steps)
    hold_bf16("bf16 step metrics", got, want, want32,
              BF16_MEAN_TOL["metrics"])
    m = bf16_steps[4]
    assert m["notfinite/g"] == m["notfinite/d"] == 0.0
    assert m["g/perc"] > 0 and m["d/hand"] > 0


@pytest.mark.parametrize("net", ["g", "d"])
def test_bf16_gradients_of_the_step_match_jax(steps, bf16_steps, net):
    got, want, want32, noise = bf16_grad_vectors(steps, bf16_steps, net)
    hold_bf16(f"bf16 {net} gradients", got, want, want32,
              BF16_MEAN_TOL[net])
    for k, (port, jax_bf16) in noise.items():
        assert port <= 1.5 * jax_bf16 + 1e-4, (k, port, jax_bf16)


def test_bf16_step_dtypes(bf16_steps):
    """Parameters, power-iteration state and the applied gradients stay
    float32; G, D and VGG19 compute in bf16 (the affine norms' outputs,
    D's features, are float32, as in JAX)."""
    tstate = bf16_steps[3]
    for opt in (tstate.opt_g, tstate.opt_d):
        assert opt.flat.dtype == opt.mu.dtype == torch.float32
    for module in (tstate.gen, tstate.dis):
        assert all(p.dtype == torch.float32 for p in module.parameters())
        assert all(b.dtype == torch.float32 for b in module.buffers())
    batch = {k: t(v)[:, 0].bfloat16() for k, v in make_batch().items()}
    with torch.no_grad():
        img, mask = tstate.gen(batch["label"], batch["label"], batch["back"],
                               batch["image"])
        out = tstate.dis(batch["label"], batch["image"], img, img,
                         batch["fg_mask"])
    assert img.dtype == mask.dtype == torch.bfloat16
    assert all(o.dtype == torch.bfloat16 for o in out["fuse"]["pred_fake"]
               ["output"])
    assert out["hand"]["weight"].dtype == torch.float32
