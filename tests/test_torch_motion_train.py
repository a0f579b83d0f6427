"""Motion training of the PyTorch port against the JAX package's
``renderloom/train/motion.py`` on the same weights and batch, with the
JAX step's own synthesis draws fed to the port
(``_torch_parity.jax_synthesis_draws`` of each step's
``split(fold_in(key, step))[0]``), at hidden 32, 2+2 layers, L = 33,
B = 2, and dropout 0 (dropout masks cannot be shared: the dropout sites
are held separately, against flax's).

Float32 tolerances: losses and ``grad_norm`` to 1e-5 relative; each
gradient leaf to 1e-4 of its largest |g|; parameters to 1e-6 after one
and three steps at the shipped learning rate (1e-4).  Two exceptions
are held to 2·lr, since AMSGrad's update g/(|g| + eps)·lr turns a
gradient error far below the leaf's tolerance into up to lr there:
elements whose clipped gradient lay below 100·eps (1e-6) at a step so
far (one element of ``enc_0/self_attn/k_proj/kernel`` reads 5.2e-6),
and the k-projection biases, whose gradient is zero but for rounding
(softmax ignores a per-query shift of the logits, which is all a key
bias adds; they read 1e-9 where the model's largest |g| is 2), so their
gradients are held to 1e-4 of the model's largest |g|.

bf16 compute (``compute_dtype: bfloat16`` on float32 parameters)
against JAX's bf16 step by mean error (``_torch_parity.hold_bf16``) on
vectors normalized by the JAX float32 step: the metrics each over
|float32|, the gradients each over its leaf's float32 largest |g| (the
k-projection biases left out).  ``BF16_MEAN_TOL`` is about 1.35× the
port's reading (``tests/_bf16_controls.py motion_train``: metrics
6.53e-3, gradients 4.72e-3).  Here the mean cannot see a port in
float32, which reads 6.91e-3 and 4.93e-3: JAX's bf16 step lies 2–8×
farther from float32 than the port's (its bf16 ``grad_norm`` 2.6% above
float32's, the port's 0.2%), so JAX's own rounding sets both distances.
The float32 control is therefore the port's distance from its own
float32 step, which a port in float32 reads as 0: at least half the
reading (``BF16_OWN_MIN``; metrics 8.3e-4, gradients 2.18e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import (hold_bf16, jax_synthesis_draws,  # noqa: F401
                           motion_cfg, motion_tree, single_thread,
                           smpl_clips, t)
from renderloom.models import motion_transformer as JM
from renderloom.ops import pose as JP
from renderloom.train import motion as JT
from renderloom_torch import convert
from renderloom_torch.models import motion_transformer as TM
from renderloom_torch.ops import pose as TP
from renderloom_torch.train import motion as TT

B, L, STEPS = 2, 33, 3
LR = 1e-4            # configs/motion.yaml's
NOISE_LEAVES = ("k_proj/bias",)
BF16_MEAN_TOL = {"metrics": 8.8e-3, "grads": 6.4e-3}
BF16_OWN_MIN = {"metrics": 4e-4, "grads": 1e-3}


def cfg_of(C, compute_dtype="float32", dropout=0.0):
    base = motion_cfg(C)
    return dataclasses.replace(
        base, compute_dtype=compute_dtype,
        transformer=dataclasses.replace(base.transformer, dropout=dropout),
        dataset=C.MotionDatasetConfig(max_seq_length=L, train_sample_rate=8,
                                      train_sample_size=8, noise_rate=2,
                                      joint_drop_rate=2, flip_rate=1),
        optim=C.MotionOptimConfig(lr=LR))


def make_case():
    tree = motion_tree(cfg_of(JC), seed=4)
    rng = np.random.default_rng(5)
    mean = rng.normal(scale=0.1, size=(19, 2)).astype(np.float32)
    std = rng.uniform(0.2, 1.0, (19, 2)).astype(np.float32)
    pad = np.zeros((B, L), bool)
    pad[1, 25:] = True
    clips = smpl_clips(B, L, seed=6)
    clips[1, :, :, 25:] = 0.0
    return tree, mean, std, {"motion3d": clips, "pad_mask": pad}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            # a copy: the donated JAX state's buffers are reused
            yield prefix + k, np.array(v, np.float32, copy=True)


def jax_run(case, compute_dtype="float32", steps=STEPS):
    """Per step the metrics, the params after it, the draws used and the
    raw gradients (``grads``: the first step's)."""
    tree, mean, std, raw = case
    cfg = cfg_of(JC, compute_dtype)
    model, tx, state = JT.create_motion_state(jax.random.PRNGKey(0), cfg, 1)
    params = jax.tree.map(jnp.asarray, tree)
    state = state.replace(params=params, opt_state=tx.init(params))
    synth = JP.SynthesisParams(rate=8, sample_size=8, noise_rate=2,
                               joint_drop_rate=2, flip_rate=1)
    step_fn = JT.make_train_step(model, tx, cfg, jnp.asarray(mean),
                                 jnp.asarray(std), synth)
    jraw = jax.tree.map(jnp.asarray, raw)
    synthesize = jax.jit(lambda *a: JP.synthesize_batch(*a, synth))
    grad_fn = jax.jit(jax.grad(lambda p, batch: JT.motion_loss(
        model, p, batch, 8, cfg.w_codition, cfg.w_2d)[0]))
    out = {"metrics": [], "params": [], "draws": [], "step_grads": []}
    for s in range(steps):
        k_synth = jax.random.split(jax.random.fold_in(state.key, s))[0]
        out["draws"].append(jax_synthesis_draws(k_synth, B, L, synth))
        batch = synthesize(k_synth, jraw["motion3d"], jraw["pad_mask"],
                           jnp.asarray(mean), jnp.asarray(std))
        out["step_grads"].append(dict(_leaves(jax.device_get(
            grad_fn(state.params, batch)))))
        state, m = step_fn(state, jraw)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"].append(dict(_leaves(jax.device_get(state.params))))
    out["grads"] = out["step_grads"][0]
    return out


def port_run(case, draws, compute_dtype="float32"):
    tree, mean, std, raw = case
    cfg = cfg_of(TC, compute_dtype)
    state = TT.create_motion_state(cfg, "cpu", params=tree)
    step = TT.make_train_step(cfg, mean, std)
    traw = {k: t(v) for k, v in raw.items()}
    synth = TP.synthesis_params(cfg.dataset)
    out = {"metrics": [], "params": []}
    for s, d in enumerate(draws):
        if s == 0:
            batch = TP.synthesize_batch(traw["motion3d"], traw["pad_mask"],
                                        t(mean), t(std), synth, d)
            total, _ = TT.motion_loss(state.model, batch, 8, cfg.w_codition,
                                      cfg.w_2d)
            grads = torch.autograd.grad(total, list(
                state.model.parameters()))
            names = [n for n, _ in state.model.named_parameters()]
            out["grads"] = dict(_leaves(convert.flax_trees(
                dict(zip(names, grads)))[0]))
        m = step(state, traw, d)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"].append(dict(_leaves(convert.flax_trees(
            state.model)[0])))
    out["state"] = state
    return out


@pytest.fixture(scope="module")
def case():
    return make_case()


@pytest.fixture(scope="module")
def runs(case):
    want = jax_run(case)
    return want, port_run(case, want["draws"])


@pytest.fixture(scope="module")
def bf16_runs(case, runs):
    """JAX's and the port's bf16 first step, and the port's float32 step
    on the same draws."""
    want = jax_run(case, "bfloat16", steps=1)
    return (want, port_run(case, want["draws"], "bfloat16"),
            port_run(case, want["draws"], "float32"))


def test_masked_losses_match_jax():
    rng = np.random.default_rng(0)
    pred, target = (rng.normal(size=(3, 6, 9)).astype(np.float32)
                    for _ in range(2))
    mask = rng.uniform(size=(3, 9)) < 0.4
    for name in ("masked_l1", "masked_mse"):
        got = getattr(TT, name)(t(pred), t(mask), t(target))
        want = getattr(JT, name)(jnp.asarray(pred), jnp.asarray(mask),
                                 jnp.asarray(target))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    full = np.ones((3, 9), bool)
    assert float(TT.masked_l1(t(pred), t(full), t(target))) == 0.0


@pytest.mark.parametrize("step", range(STEPS))
def test_metrics_match_jax(runs, step):
    want, got = runs
    w, g = want["metrics"][step], got["metrics"][step]
    assert sorted(w) == sorted(g) == sorted(
        ["loss/denoise", "loss/pose2d", "loss/total", "grad_norm",
         "notfinite"])
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    assert g["notfinite"] == 0.0 and g["grad_norm"] > 1.0   # clip active


def test_gradients_match_jax(runs):
    want, got = runs
    assert sorted(want["grads"]) == sorted(got["grads"])
    top = max(np.abs(w).max() for w in want["grads"].values())
    for k, w in want["grads"].items():
        # a noise leaf's largest is rounding noise: held to the model's
        scale = top if k.endswith(NOISE_LEAVES) else np.abs(w).max()
        err = np.abs(got["grads"][k] - w).max()
        assert err <= 1e-4 * scale, (k, err)


def _near_zero(want, step, k):
    """Elements of leaf k whose clipped gradient lay below 100·eps of
    AMSGrad (1e-6) at some step up to ``step``: there a gradient error
    far below 1e-4 of the leaf moves the update by up to lr."""
    near = np.zeros(want["grads"][k].shape, bool)
    for g, m in zip(want["step_grads"][:step + 1], want["metrics"]):
        near |= np.abs(g[k]) / max(m["grad_norm"], 1.0) < 1e-6
    return near


@pytest.mark.parametrize("step", [0, STEPS - 1])
def test_parameters_match_jax(runs, step):
    want, got = runs
    for k, w in want["params"][step].items():
        near = np.ones(w.shape, bool) if k.endswith(NOISE_LEAVES) \
            else _near_zero(want, step, k)
        err = np.abs(got["params"][step][k] - w)
        assert err[~near].max(initial=0) <= 1e-6, (k, err[~near].max())
        assert err[near].max(initial=0) <= 2 * LR, (k, err[near].max())


def test_non_finite_gradient_is_skipped_and_counted(case, runs):
    tree, mean, std, raw = case
    cfg = cfg_of(TC)
    state = TT.create_motion_state(cfg, "cpu", params=tree)
    step = TT.make_train_step(cfg, mean, std)
    bad = {"motion3d": t(raw["motion3d"]).clone(),
           "pad_mask": t(raw["pad_mask"])}
    bad["motion3d"][0, 0, 0, 5] = float("nan")      # the root joint
    draws = runs[0]["draws"][0]
    before = state.opt.flat.clone()
    m = step(state, bad, draws)
    assert m["notfinite"] == 1.0 and not np.isfinite(float(m["grad_norm"]))
    assert torch.equal(state.opt.flat, before)
    assert int(state.opt.count) == 0 and int(state.opt.total_notfinite) == 1
    m = step(state, {k: t(v) for k, v in raw.items()}, draws)
    assert m["notfinite"] == 0.0 and int(state.opt.count) == 1
    # the update after a skipped one equals the first update of a fresh run
    np.testing.assert_allclose(
        dict(_leaves(convert.flax_trees(state.model)[0]))[
            "dec_0/ffn/linear1/kernel"],
        runs[1]["params"][0]["dec_0/ffn/linear1/kernel"], atol=0)


def _bf16_vectors(runs, bf16_runs, port):
    """(port, JAX bf16, JAX float32) metric and gradient vectors of the
    first step, normalized by the JAX float32 step."""
    want32 = runs[0]
    m32 = want32["metrics"][0]
    keys = [k for k in m32 if k != "notfinite"]
    mvec = lambda m: np.array([m[k] / abs(m32[k]) for k in keys])
    gvec = lambda g: np.concatenate([
        (g[k] / np.abs(want32["grads"][k]).max()).ravel()
        for k in want32["grads"] if not k.endswith(NOISE_LEAVES)])
    return {"metrics": (mvec(port["metrics"][0]),
                        mvec(bf16_runs[0]["metrics"][0]), mvec(m32)),
            "grads": (gvec(port["grads"]), gvec(bf16_runs[0]["grads"]),
                      gvec(want32["grads"]))}


@pytest.mark.parametrize("what", ["metrics", "grads"])
def test_bf16_step_matches_jax(runs, bf16_runs, what):
    got, want, ref = _bf16_vectors(runs, bf16_runs, bf16_runs[1])[what]
    hold_bf16(f"bf16 motion step {what}", got, want, ref,
              BF16_MEAN_TOL[what])
    # the control: the port's bf16 step is not its float32 step
    f32, _, _ = _bf16_vectors(runs, bf16_runs, bf16_runs[2])[what]
    assert np.abs(got - f32).mean() >= BF16_OWN_MIN[what]
    assert bf16_runs[1]["metrics"][0]["notfinite"] == 0.0
    state = bf16_runs[1]["state"]
    assert state.opt.flat.dtype == torch.float32
    assert state.model.input_embed.compute_dtype == torch.bfloat16


def _dropout_sites_jax(cfg, params, args):
    import flax.linen as nn

    model = JM.build_motion_model(cfg)
    _, state = model.apply(
        {"params": params}, *args, deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(1)},
        capture_intermediates=lambda mdl, _: isinstance(mdl, nn.Dropout),
        mutable=["intermediates"])
    sites = []

    def walk(node, path):
        for k, v in node.items():
            if k == "__call__":
                sites.extend((path, tuple(o.shape)) for o in v)
            else:
                walk(v, path + (k,))

    walk(state["intermediates"], ())
    return sorted(("/".join(p), s) for p, s in sites)


def test_dropout_sites_match_flax():
    """Each dropout of the port sits where flax's does (module path and
    the shape dropped: attention weights, the feed-forward's hidden
    layer, each residual branch), and drops as flax's Dropout does."""
    jcfg, tcfg = cfg_of(JC, dropout=0.1), cfg_of(TC, dropout=0.1)
    tree = motion_tree(jcfg, seed=1)
    rng = np.random.default_rng(2)
    src = rng.normal(size=(2, 17, 38)).astype(np.float32)
    mask = np.zeros((2, 17), bool)
    mask[1, 13:] = True
    args = (src, mask, src, mask, 4)
    want = _dropout_sites_jax(jcfg, tree, tuple(
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    model = convert.load_flax_params(TM.build_motion_model(tcfg), tree)
    seen = []
    for name, m in model.named_modules():
        if isinstance(m, TM.Dropout):
            path = name.replace(".dropout", ".Dropout_0").replace(
                ".drop", ".Dropout_0").replace(".", "/")
            m.register_forward_hook(lambda _, a, out, p=path: seen.append(
                (p, tuple(out.shape))))
    g = torch.Generator().manual_seed(0)
    targs = tuple(t(a) if isinstance(a, np.ndarray) else a for a in args)
    with torch.no_grad():
        train = model(*targs, dropout_rng=g)
        det = model(*targs)
        again = model(*targs, dropout_rng=torch.Generator().manual_seed(0))
    assert sorted(seen[:len(want)]) == want, (seen, want)
    assert len(want) == 2 * (4 + 6)        # 2+2 layers: 4 and 6 sites each
    assert not torch.allclose(train[0], det[0])
    assert torch.equal(train[0], again[0])
    # the drop itself: kept with probability 1 - p, scaled by 1 / (1 - p)
    x = torch.ones(200_000)
    y = TM.Dropout(0.25)(x, torch.Generator().manual_seed(3))
    assert torch.equal(y.unique(), torch.tensor([0.0, 1.0 / 0.75]))
    assert abs((y == 0).float().mean().item() - 0.25) < 5e-3
    assert torch.equal(TM.Dropout(0.25)(x), x)


def test_initialisation_statistics_match_flax():
    """Per leaf, the port's seeded initial weights have the statistics
    of ``init_motion_params``'s (lecun-normal kernels, zero biases, unit
    layer-norm scales, a uniform [0, 1) learned table): std within 5%
    of JAX's, means near 0 (0.5 for the table), the same constants."""
    def full(C):
        c = C.MotionConfig()
        return dataclasses.replace(
            c, transformer=dataclasses.replace(c.transformer, enc_layers=2,
                                               dec_layers=2),
            pos_encode=dataclasses.replace(c.pos_encode,
                                           position_embedding="v3"),
            dataset=dataclasses.replace(c.dataset, max_seq_length=129))
    _, jparams = JM.init_motion_params(jax.random.PRNGKey(0), full(JC))
    want = dict(_leaves(jax.device_get(jparams)))
    got = dict(_leaves(convert.flax_trees(
        TM.init_motion_params(full(TC), 0))[0]))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        assert abs(g.std() / w.std() - 1) < 0.05, (k, g.std(), w.std())
        assert abs(g.mean() - w.mean()) < 0.05 * w.std() + 1e-3 * abs(
            w.mean()) + 3 * w.std() / np.sqrt(w.size), k
        assert g.min() >= w.min() - 0.1 * w.std() and \
            g.max() <= w.max() + 0.1 * w.std(), k       # the same cut
    assert want["learned_pe/embedding"].shape == (160, 128)
    again = convert.flax_trees(TM.init_motion_params(full(TC), 0))[0]
    np.testing.assert_array_equal(again["enc_0"]["ffn"]["linear1"]["kernel"],
                                  got["enc_0/ffn/linear1/kernel"])


def test_learned_position_encoding_matches_jax():
    def learned(C):
        c = motion_cfg(C)
        return dataclasses.replace(c, pos_encode=dataclasses.replace(
            c.pos_encode, position_embedding="v3"))
    jcfg = learned(JC)
    tree = motion_tree(jcfg, seed=3)
    rng = np.random.default_rng(4)
    tree["learned_pe"]["embedding"] = rng.uniform(
        size=tree["learned_pe"]["embedding"].shape).astype(np.float32)
    src = rng.normal(size=(2, 17, 38)).astype(np.float32)
    mask = np.zeros((2, 17), bool)
    mask[1, 13:] = True
    enc = (np.arange(17) % 4 != 0)[None] | mask
    want = JM.build_motion_model(jcfg).apply(
        {"params": tree}, jnp.asarray(src), jnp.asarray(enc),
        jnp.asarray(src), jnp.asarray(mask), 4)
    model = convert.load_flax_params(TM.build_motion_model(learned(TC)),
                                     tree)
    with torch.no_grad():
        got = model(t(src), t(enc), t(src), t(mask), 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    back = convert.flax_trees(model)[0]["learned_pe"]["embedding"]
    np.testing.assert_array_equal(back, tree["learned_pe"]["embedding"])
    long = torch.zeros(1, 161, 38)
    with pytest.raises(ValueError, match="161 positions"):
        model(long, torch.zeros(1, 161, dtype=torch.bool), long,
              torch.zeros(1, 161, dtype=torch.bool), 4)
