"""The parity-layout inference path of the PyTorch port
(``renderloom_torch/models/fastpath.py`` and the parity twin of the
CUDA norm ``renderloom_torch/csrc/instance_norm.cu``) against the JAX
package's ``models/fastpath.py``, ``ops/norm_pallas.instance_norm_fused
(parity=True)`` in interpret mode, and the JAX TPU serving
configuration ``eval/pipeline.build_pipeline(platform="tpu")`` run on
the CPU, on the same numpy-seeded weights and inputs.

Tolerances: weight transforms 1e-6 (the same sums in the same order);
the parity norm 1e-5 in float32 (summation order) and 8e-3 + 8e-3·|ref|
in bf16 (one bf16 ulp); the embedder and mask net 2e-5 and the trunk and
rollouts 3e-5, as tests/test_fastpath.py holds the JAX fast path to the
flax generator; the whole pipeline 1e-4, as tests/test_torch_pipeline.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderloom.core.config as JC
import renderloom.models.fastpath as JF
import renderloom_torch.core.config as TC
import renderloom_torch.models.fastpath as PF
from _torch_parity import (blobs, generator_trees, motion_cfg,  # noqa: F401
                           motion_tree, renderer_cfg, single_thread, t)
from renderloom.eval.pipeline import build_pipeline as jax_build_pipeline
from renderloom.models.layers import LEAKY_SLOPE, leaky
from renderloom.ops.norm_pallas import instance_norm_fused
from renderloom.train.gan import fold_spectral_norm as jax_fold
from renderloom_torch.eval.pipeline import build_pipeline
from renderloom_torch.models.layers import InstanceNorm, Spade
from renderloom_torch.ops import norm_kernel
from renderloom_torch.train.gan import (make_inference_pair,
                                        make_segment_rollout)

H, W = 32, 48


def _oihw(a) -> np.ndarray:
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


# ---------------------------------------------------------------------------
# weight transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,shape", [("w_s1_s2d", (3, 3, 5, 7)),
                                        ("w_s2_s2d", (3, 3, 5, 9)),
                                        ("w_up_d2s", (3, 3, 6, 4))])
def test_weight_transform_matches_jax(name, shape):
    k = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = _oihw(getattr(JF, name)(jnp.asarray(k)))
    got = getattr(PF, name)(t(_oihw(k)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.fixture(scope="module")
def weights():
    """(JAX folded params, port standard generator, JAX config, port
    config) on one numpy-seeded spectral generator tree."""
    jcfg, tcfg = renderer_cfg(JC, H, W), renderer_cfg(TC, H, W)
    params, stats = generator_trees(jcfg, H, W, seed=2)
    gen = make_inference_pair(tcfg, params, stats, "cpu")
    return jax_fold(params, stats), gen, jcfg, tcfg, params, stats


def _assert_tree_matches(got, want, atol=1e-6):
    assert set(got) == set(want)
    for block in want:
        assert set(got[block]) == set(want[block]), block
        for leaf, w in want[block].items():
            g = got[block][leaf]
            np.testing.assert_allclose(g.numpy(), _oihw(w), atol=atol,
                                       err_msg=f"{block}/{leaf}")


@pytest.mark.parametrize("part", ["mask", "embed", "trunk"])
def test_transform_params_match_jax(weights, part):
    folded, gen, jcfg, tcfg = weights[:4]
    g = jcfg.gen
    if part == "mask":
        want = JF.transform_mask_params(folded["mask_net"],
                                        g.mask.num_downsamples,
                                        g.mask.num_res_blocks)
        got = PF.transform_mask_params(gen.mask_net)
    elif part == "embed":
        want = JF.transform_embed_params(folded["ref_embed"],
                                         g.embed.num_downsamples)
        got = PF.transform_embed_params(gen.ref_embed)
    else:
        want = JF.transform_trunk_params(folded, g, packed_levels=2)
        got = PF.transform_trunk_params(gen, tcfg.gen, packed_levels=2)
    _assert_tree_matches(got, want)


# ---------------------------------------------------------------------------
# the parity instance norm's twin
# ---------------------------------------------------------------------------


def _x(shape, seed, loc=0.0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (loc + scale * rng.normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("act", [False, True])
def test_parity_twin_matches_jax(affine, act):
    x = _x((2, 4, 6, 16), 4, loc=2.0)
    s = _x((16,), 5) + 2.0 if affine else None
    b = _x((16,), 6) if affine else None
    slope = LEAKY_SLOPE if act else None
    js = None if s is None else jnp.asarray(s)
    jb = None if b is None else jnp.asarray(b)
    ref = JF.instance_norm_p4(jnp.asarray(x), js, jb)
    ref = np.asarray(leaky(ref) if act else ref)
    pallas = np.asarray(instance_norm_fused(
        jnp.asarray(x), js, jb, parity=True, slope=slope, interpret=True))
    got = norm_kernel.instance_norm(
        t(x), None if s is None else t(s), None if b is None else t(b),
        slope, parity=True).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=1e-5)


def test_parity_twin_bf16_matches_pallas():
    x = _x((2, 4, 8, 32), 7)        # H·W a multiple of bf16's 16-row tile
    s, b = _x((32,), 8) + 2.0, _x((32,), 9)
    want = instance_norm_fused(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s),
                               jnp.asarray(b), parity=True,
                               slope=LEAKY_SLOPE, interpret=True)
    got = norm_kernel.instance_norm(t(x).bfloat16(), t(s), t(b),
                                    LEAKY_SLOPE, parity=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=8e-3,
                               rtol=8e-3)


def test_parity_twin_large_mean_matches_float64():
    """The shifted fp32 contract at mean 4096, std 1e-2 (the case of
    tests/test_layers_extra.py for the standard norm): the parity norm of
    a packed tensor is the full-resolution norm of its unpacked one."""
    z = np.random.default_rng(0).normal(0, 1, (2, 24, 32, 8))
    x32 = (4096.0 + 1e-2 * z).astype(np.float32)
    x64 = x32.astype(np.float64)
    ref = (x64 - x64.mean(axis=(1, 2), keepdims=True)) / np.sqrt(
        x64.var(axis=(1, 2), keepdims=True) + 1e-5)
    packed = PF.space_to_depth(t(x32))
    got = PF.depth_to_space(norm_kernel.instance_norm(packed, parity=True))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(PF.depth_to_space(t(np.asarray(
            JF.instance_norm_p4(jnp.asarray(packed.numpy())))))), atol=1e-5)


def test_parity_norm_is_inference_only_and_never_falls_back():
    x = t(_x((1, 4, 4, 8), 3))
    with pytest.raises(RuntimeError, match="inference-only"):
        norm_kernel.instance_norm(x.requires_grad_(), parity=True)
    before = norm_kernel.instance_norm_cuda.parity_launches
    with pytest.raises(ValueError):
        norm_kernel.instance_norm_cuda(x.detach(), parity=True)
    assert norm_kernel.instance_norm_cuda.parity_launches == before


# ---------------------------------------------------------------------------
# embedder, trunk and mask net
# ---------------------------------------------------------------------------


def test_embed_fast_matches_jax(weights):
    folded, gen, jcfg = weights[:3]
    n = jcfg.gen.embed.num_downsamples
    x = np.random.default_rng(7).uniform(-1, 1, (2, H, W, 6)).astype(
        np.float32)
    want = JF.embed_apply_fast(JF.transform_embed_params(folded["ref_embed"],
                                                         n),
                               jnp.asarray(x), jnp.float32, n,
                               return_packed=True)
    got = PF.embed_apply_fast(PF.transform_embed_params(gen.ref_embed),
                              t(x), n)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list)
        for g, w in zip(g_list, w_list):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


@pytest.mark.parametrize("packed_levels", [1, 2])
def test_trunk_fast_matches_jax(weights, packed_levels):
    folded, gen, jcfg, tcfg = weights[:4]
    n = jcfg.gen.embed.num_downsamples
    rng = np.random.default_rng(8)
    label = rng.uniform(-1, 1, (2, H, W, 22)).astype(np.float32)
    x = rng.uniform(-1, 1, (2, H, W, 6)).astype(np.float32)
    cond, cond_packed = JF.embed_apply_fast(
        JF.transform_embed_params(folded["ref_embed"], n), jnp.asarray(x),
        jnp.float32, n, return_packed=True)
    # one jit of the JAX trunk costs a few seconds; eager, each op's
    # dispatch is compiled on its own, four times longer
    want = jax.jit(lambda tp, lbl, c, cp: JF.trunk_apply_fast(
        tp, lbl, c, cp, jnp.float32, jcfg.gen, packed_levels))(
            JF.transform_trunk_params(folded, jcfg.gen, packed_levels),
            jnp.asarray(label), cond, cond_packed)
    got = PF.trunk_apply_fast(
        PF.transform_trunk_params(gen, tcfg.gen, packed_levels),
        PF.space_to_depth(t(label)), [t(c) for c in cond],
        [t(c) for c in cond_packed], tcfg.gen, packed_levels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_mask_fast_matches_jax(weights):
    folded, gen, jcfg = weights[:3]
    m = jcfg.gen.mask
    rng = np.random.default_rng(4)
    label = rng.uniform(-1, 1, (2, H, W, 22)).astype(np.float32)
    imgs = rng.uniform(-1, 1, (2, H, W, 9)).astype(np.float32)
    want = JF.mask_apply_fast(
        JF.transform_mask_params(folded["mask_net"], m.num_downsamples,
                                 m.num_res_blocks),
        jnp.asarray(label), jnp.asarray(imgs), jnp.float32,
        m.num_downsamples, m.num_res_blocks)
    got = PF.mask_apply_fast(PF.transform_mask_params(gen.mask_net),
                             PF.space_to_depth(t(label)), t(imgs),
                             m.num_downsamples, m.num_res_blocks)
    assert got.shape == (2, H, W, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _count_norm_calls(fast, monkeypatch) -> dict:
    """The norms one call of the parity-layout generator ``fast`` runs,
    by the contract each takes."""
    seen = {"instance_norm": 0, "instance_norm_parity": 0,
            "instance_norm_r3": 0}
    inner = PF.instance_norm

    def counting(x, *args, parity=False, **kw):
        seen["instance_norm_parity" if parity else "instance_norm_r3"
             if x.dtype == torch.bfloat16 else "instance_norm"] += 1
        return inner(x, *args, parity=parity, **kw)
    monkeypatch.setattr(PF, "instance_norm", counting)
    rng = np.random.default_rng(9)
    ins = [t(rng.uniform(-1, 1, (1, H, W, c)).astype(np.float32))
           for c in (22, 22, 3, 3)]
    with torch.no_grad():
        fast(*ins)
    return seen


@pytest.mark.parametrize("packed_levels", [1, 2])
def test_derived_norm_counts_match_a_call(weights, monkeypatch,
                                          packed_levels):
    """``chip_smoke.derived_fast_launches`` (the card's launch check)
    counts the norms one generator call runs, by kind; together they are
    the standard generator's norms."""
    from chip_smoke import derived_fast_launches

    gen, tcfg = weights[1], weights[3]
    seen = _count_norm_calls(PF.FastInferenceGen(gen, tcfg.gen,
                                                 packed_levels), monkeypatch)
    assert seen == derived_fast_launches(tcfg.gen, packed_levels)
    assert sum(seen.values()) == sum(isinstance(m, (InstanceNorm, Spade))
                                     for m in gen.modules())


@pytest.mark.parametrize("packed_levels", [1, 2])
def test_derived_norm_counts_match_a_bf16_call(weights, monkeypatch,
                                               packed_levels):
    """The same in bf16 compute: the standard-layout norms of bf16
    tensors are r3centered, the mask net's residual blocks (after the
    float32 output of the last downs' affine norms) shifted float32."""
    import dataclasses

    from chip_smoke import derived_fast_launches
    from renderloom_torch import convert
    from renderloom_torch.train.gan import make_inference_generator

    tcfg, params, stats = weights[3], weights[4], weights[5]
    gen = make_inference_generator(
        dataclasses.replace(tcfg, compute_dtype="bfloat16"))
    convert.load_flax_params(gen, convert.fold_spectral_norm(params, stats))
    seen = _count_norm_calls(PF.FastInferenceGen(gen, tcfg.gen,
                                                 packed_levels), monkeypatch)
    assert seen == derived_fast_launches(tcfg.gen, packed_levels, bf16=True)
    assert seen["instance_norm"] > 0 and seen["instance_norm_r3"] > 0
    assert sum(seen.values()) == sum(isinstance(m, (InstanceNorm, Spade))
                                     for m in gen.modules())


# ---------------------------------------------------------------------------
# rollouts and the whole pipeline
# ---------------------------------------------------------------------------

RATE, K, B = 2, 3, 1
L = (K - 1) * RATE + 1


@pytest.fixture(scope="module")
def rollout_case(weights):
    """The batch and the JAX fast-path rollout's output on it."""
    jcfg, params, stats = weights[2], weights[4], weights[5]
    rng = np.random.default_rng(5)
    batch = {"label": rng.uniform(-1, 1, (B, L, H, W, 22)),
             "back": rng.uniform(-1, 1, (B, L, H, W, 3)),
             "key_img": rng.uniform(-1, 1, (B, L, H, W, 3))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    from renderloom.train.gan import make_inference_pair as jax_pair
    from renderloom.train.gan import make_segment_rollout as jax_rollout
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RENDERLOOM_FASTPATH", "1")
        mp.setenv("RENDERLOOM_PACKED_LEVELS", "2")
        jgen, jfolded = jax_pair(jcfg, params, stats)
        assert isinstance(jgen, JF.FastInferenceGen)
        fused, masks = jax_rollout(jgen, jcfg, RATE)(
            jfolded, {}, {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, np.asarray(fused), np.asarray(masks)


@pytest.mark.parametrize("label_layout", ["nhwc", "packed"])
def test_fast_rollout_matches_jax_and_standard(weights, rollout_case,
                                               label_layout):
    """``make_segment_rollout`` over ``FastInferenceGen`` takes the NHWC
    label or the pre-packed one unchanged and equals the JAX fast
    rollout and the port's own standard rollout."""
    tcfg, params, stats = weights[3], weights[4], weights[5]
    batch, want_fused, want_masks = rollout_case
    tb = {k: t(v) for k, v in batch.items()}
    std = make_segment_rollout(make_inference_pair(tcfg, params, stats,
                                                   "cpu"), RATE)
    fast_gen = make_inference_pair(tcfg, params, stats, "cpu", fastpath=True)
    assert isinstance(fast_gen, PF.FastInferenceGen)
    fast = make_segment_rollout(fast_gen, RATE)
    with torch.no_grad():
        ref_fused, ref_masks = std(tb)
        if label_layout == "packed":
            tb["label"] = PF.space_to_depth(
                tb["label"].reshape(B * L, H, W, 22)).reshape(
                    B, L, H // 2, W // 2, 88)
        fused, masks = fast(tb)
    assert fused.shape == (B, L, H, W, 3) and masks.shape == (B, L, H, W, 1)
    for got, jax_want, port_want in ((fused, want_fused, ref_fused),
                                     (masks, want_masks, ref_masks)):
        np.testing.assert_allclose(got.numpy(), jax_want, atol=3e-5)
        np.testing.assert_allclose(got.numpy(), port_want.numpy(),
                                   atol=3e-5)


def test_fastpath_pipeline_matches_jax_tpu_configuration():
    """``build_pipeline(fastpath=True)`` against the JAX pipeline's TPU
    configuration (fused raster in interpret mode with a packed bf16
    label, the parity-layout generator with ``instance_norm_p4``) at
    64×96, rate 2, 3 keyframes, with the joints kept in the frame as
    tests/test_torch_pipeline.py keeps them."""
    Hp, Wp, N = 64, 96, 1
    jm, jr = motion_cfg(JC), renderer_cfg(JC, Hp, Wp)
    m_params = motion_tree(jm, seed=3)
    g_params, g_stats = generator_trees(jr, Hp, Wp, seed=4)
    rng = np.random.default_rng(0)
    motion = np.stack([rng.uniform(-0.9, -0.7, (N, 19, K)),
                       rng.uniform(-0.9, -0.8, (N, 19, K))],
                      axis=2).astype(np.float32)
    conf = np.full((N, 19, 1, K), 0.9, np.float32)
    keys = np.stack([blobs(K, Hp, Wp, seed=s) for s in range(N)])
    mean = np.zeros((19, 2), np.float32)
    mean[-1] = (-0.8, -0.85)
    std = np.full((19, 2), 0.02, np.float32)

    jfn, jm_params, jg = jax_build_pipeline(
        jm, jr, RATE, K, m_params=m_params, g_params=g_params,
        g_stats=g_stats, mean=mean, std=std, platform="tpu")
    assert "__fast__" in jg
    want, _ = jfn(jm_params, jg, jnp.asarray(motion), jnp.asarray(conf),
                  jnp.asarray(keys))

    fn, _, gen = build_pipeline(motion_cfg(TC), renderer_cfg(TC, Hp, Wp),
                                RATE, K, m_params=m_params,
                                g_params=g_params, g_stats=g_stats,
                                mean=mean, std=std, device="cpu",
                                fastpath=True)
    assert isinstance(gen, PF.FastInferenceGen)
    got, _ = fn(t(motion), t(conf), t(keys))
    assert got.shape == (N, L, Hp, Wp, 3)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(got[:, ::RATE].numpy(),
                               keys * 255.0 / 127.5 - 1.0, atol=1e-6)
