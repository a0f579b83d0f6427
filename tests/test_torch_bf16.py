"""bfloat16 compute in the PyTorch port against the JAX package's
bfloat16 configuration on the CPU, on the same numpy-seeded weights and
inputs: the r3centered instance norm (K2's bf16 mode, through its plain
twin) and its gradient (K2b's r3centered mode, through its twin, against
``jax.vjp``), the motion transformer, and one generator step of the
standard and of the parity-layout generator.

Tolerances.
* r3centered twin against ``layers.instance_norm`` on bf16 input: one
  bf16 ulp of the normalized value n (times |γ| at affine sites) plus
  1e-6, as ``2⁻⁷·|n|·|γ| + 1e-6`` — XLA on the CPU may keep the float32
  value where the contract rounds n to bf16 (excess precision), which
  moves the result by up to half an ulp; the sums' order moves n by a
  few float32 ulp, which can round it to the neighbouring bf16 value.
  At affine call sites also at most 1% of elements not bit-equal: the
  twin equals JAX at every element there, and each planted departure
  that stays within the ulp (``PLANTED``) moves nearly every element.
* r3centered backward twin against ``jax.vjp`` of ``layers.instance_norm``
  (and ``layers.leaky``) on bf16 x at mean 0.7, std 1.5: dx in bf16,
  within one bf16 ulp (``2⁻⁷·max(|dx|)`` elementwise) and bit-equal but
  for at most 0.1% of elements — the readings are 0.008% (affine +
  leaky), 0.020% (affine) and 0.012% (no affine), a few float32 ulp of
  another algebra (autodiff goes through m1 and var) rounding dx to the
  neighbouring bf16 value; each planted fault (``PLANTED_BWD``) moves
  29% of elements or more, or dγ by 1.6e-3 of its largest.  dγ and dβ
  within 1e-5 of their largest (readings 5e-7).
* Models: bf16 evaluations that round at other places differ by
  rounding noise that the network amplifies; with these seeded weights
  the JAX bf16 image itself lies tenths from the JAX float32 image at
  its largest element (hundredths on average).  So each port output is
  held by two conditions (``_torch_parity.hold_bf16``): (1) its mean
  |port − JAX bf16| within a stated absolute tolerance, about 1.35×
  the reading of the port as it is (``MEAN_TOL``); (2) against the JAX
  float32 output its largest error at most 1.5× the JAX bf16 output's
  own plus 1e-3, which a port close to JAX only because both are far
  from the function would fail.  Two bf16 evaluations that round at
  other places lie about √2 times one's own distance from float32
  apart, so (1) cannot tell a port in float32 (it reads less) or one
  that departs from the norm's contract within the ulp (it reads the
  same to 2%) from a sound one: the dtype assertions and
  ``held_r3`` hold those.
* The fast path's JAX side runs the Pallas norm in interpret mode
  (``RENDERLOOM_PALLAS_NORM=1`` with the fast-path settings of
  tests/test_torch_fastpath.py), its parity norms then the contract of
  the port's K2 parity in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import (bf16, generator_trees, hold_bf16,  # noqa: F401
                           motion_cfg, motion_tree, renderer_cfg,
                           single_thread, t)
from renderloom.models.layers import LEAKY_SLOPE, instance_norm, leaky
from renderloom.models.motion_transformer import build_motion_model as jbm
from renderloom.train import gan as JG
from renderloom_torch import convert
from renderloom_torch.models import motion_transformer as TM
from renderloom_torch.models.fastpath import FastInferenceGen
from renderloom_torch.models.layers import cast_weights_
from renderloom_torch.ops import norm_kernel
from renderloom_torch.train import gan as TG


# mean |port − JAX bf16| of each output: the readings of the port as it
# is (joints 1.22e-2, reco 7.09e-3; img 1.85e-2 standard, 1.74e-2
# fastpath; mask 4.10e-3, 3.74e-3), about 1.35x above
MEAN_TOL = {"joints": 1.7e-2, "reco": 1e-2, "img": 2.5e-2, "mask": 5.5e-3}


# ---------------------------------------------------------------------------
# the r3centered instance norm
# ---------------------------------------------------------------------------


def r3_tolerance(x: torch.Tensor, scale) -> np.ndarray:
    """One bf16 ulp of n (× |γ|) + 1e-6, elementwise."""
    n = norm_kernel.instance_norm_plain(x, r3centered=True).float().numpy()
    g = 1.0 if scale is None else np.abs(scale)
    return 2.0 ** -7 * np.abs(n) * g + 1e-6


def held_r3(got: np.ndarray, want: np.ndarray, x: torch.Tensor,
            scale) -> bool:
    """Within :func:`r3_tolerance` everywhere and, at an affine call
    site, bit-equal but for at most 1% of elements (the twin equals JAX
    there at every element on the CPU; a departure that stays within
    the ulp — n not rounded, or the output rounded — moves nearly every
    one)."""
    ok = (np.abs(got - want) <= r3_tolerance(x, scale)).all()
    if scale is not None:
        ok &= (got != want).mean() <= 0.01
    return bool(ok)


def r3_case(affine, act):
    """bf16 x (B, H, W, C) with a mean and std away from 0 and 1, γ and
    β, the fused leaky's slope, and JAX ``layers.instance_norm`` on
    them."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(1.5, 2.0, (2, 8, 12, 16)), jnp.bfloat16)
    s = (2.0 + rng.normal(size=16)).astype(np.float32) if affine else None
    b = rng.normal(size=16).astype(np.float32) if affine else None
    want = instance_norm(x, scale=None if s is None else jnp.asarray(s),
                         bias=None if b is None else jnp.asarray(b))
    want = leaky(want) if act else want
    tx = t(np.asarray(x, np.float32)).bfloat16()
    return (tx, None if s is None else t(s), None if b is None else t(b),
            LEAKY_SLOPE if act else None, want)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("act", [False, True])
def test_r3centered_twin_matches_jax(affine, act):
    tx, s, b, slope, want = r3_case(affine, act)
    got = norm_kernel.instance_norm(tx, s, b, slope)
    # bf16 without affine, float32 with it, on both sides
    assert str(want.dtype) == ("float32" if affine else "bfloat16")
    assert got.dtype == (torch.float32 if affine else torch.bfloat16)
    assert held_r3(got.float().numpy(), np.asarray(want, np.float32), tx,
                   None if s is None else s.numpy())


def _not_rounded(x, s, b, slope):
    x32 = x.float()
    m1 = x32.mean(dim=(1, 2), keepdim=True)
    var = (x32 * x32).mean(dim=(1, 2), keepdim=True) - m1 * m1
    y = (x32 - m1) * torch.rsqrt(var.clamp(min=0.0) + 1e-5) * s + b
    return y if slope is None else torch.where(y >= 0, y, y * slope)


# the twin as it is, kept where a planted twin cannot replace it
_SOUND_R3 = norm_kernel._plain_r3centered
PLANTED = {
    "n not rounded before the affine": _not_rounded,
    "shifted moments, bf16 output": lambda x, s, b, slope:
        norm_kernel.instance_norm_plain(x, s, b, slope),
    "affine output rounded to bf16": lambda x, s, b, slope:
        _SOUND_R3(x, s, b, slope, norm_kernel.EPS).bfloat16(),
}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_r3centered_check_rejects_a_planted_fault(fault):
    """Each departure from the contract that stays within one ulp of n
    fails :func:`held_r3` at the affine + leaky call site."""
    tx, s, b, slope, want = r3_case(True, True)
    got = PLANTED[fault](tx, s, b, slope).float().numpy()
    assert not held_r3(got, np.asarray(want, np.float32), tx, s.numpy())


def test_bf16_norm_contracts_and_no_fallback():
    """A bf16 x takes r3centered in the standard layout and the parity
    contract when packed; under autograd r3centered goes through
    ``InstanceNormFunction`` and the parity norm raises; the CUDA
    wrappers refuse a CPU tensor without counting a launch."""
    x = t(np.random.default_rng(1).normal(size=(2, 4, 6, 8)).astype(
        np.float32)).bfloat16()
    torch.testing.assert_close(
        norm_kernel.instance_norm(x),
        norm_kernel.instance_norm_plain(x, r3centered=True), rtol=0, atol=0)
    torch.testing.assert_close(
        norm_kernel.instance_norm(x, parity=True),
        norm_kernel.instance_norm_plain(x, parity=True), rtol=0, atol=0)
    y = norm_kernel.instance_norm(x.clone().requires_grad_())
    assert type(y.grad_fn).__name__ == "InstanceNormFunctionBackward"
    with pytest.raises(RuntimeError, match="inference-only"):
        norm_kernel.instance_norm(x.clone().requires_grad_(), parity=True)
    before = (norm_kernel.instance_norm_cuda.r3_launches,
              norm_kernel.instance_norm_bwd_cuda.r3_launches)
    with pytest.raises(ValueError):
        norm_kernel.instance_norm_cuda(x, r3centered=True)
    with pytest.raises(ValueError):
        norm_kernel.instance_norm_cuda(x.float(), r3centered=True)
    stats = torch.zeros((2, 8, 3))
    with pytest.raises(ValueError):
        norm_kernel.instance_norm_bwd_cuda(x, x, stats, r3centered=True)
    assert (norm_kernel.instance_norm_cuda.r3_launches,
            norm_kernel.instance_norm_bwd_cuda.r3_launches) == before


# ---------------------------------------------------------------------------
# the r3centered backward
# ---------------------------------------------------------------------------

R3_BWD_NOT_EQUAL_MAX = 1e-3     # readings 0.008%–0.020% (module docstring)
R3_BWD_PARAM_RTOL = 1e-5        # of the largest |dγ|, |dβ|; readings 5e-7


def r3_bwd_case(affine, act):
    """bf16 x (2, 16, 24, 32) drawn at mean 0.7, std 1.5, γ and β, the
    leaky's slope, a cotangent in the output's dtype (float32 with
    affine, bf16 without), the forward's residuals from the twin, and
    JAX's gradients (``jax.vjp`` of ``instance_norm`` then ``leaky``)."""
    rng = np.random.default_rng(4)
    shape = (2, 16, 24, 32)
    x = jnp.asarray(rng.normal(0.7, 1.5, shape), jnp.bfloat16)
    s = (1.0 + 0.5 * rng.normal(size=32)).astype(np.float32) \
        if affine else None
    b = rng.normal(size=32).astype(np.float32) if affine else None

    def f(x, *sb):
        y = instance_norm(x, scale=sb[0] if sb else None,
                          bias=sb[1] if sb else None)
        return leaky(y) if act else y
    args = (x,) + ((jnp.asarray(s), jnp.asarray(b)) if affine else ())
    y, vjp = jax.vjp(f, *args)
    dy = jnp.asarray(rng.normal(size=shape), y.dtype)
    want = [np.asarray(g, np.float32) for g in vjp(dy)]
    tx = t(np.asarray(x, np.float32)).bfloat16()
    ts, tb = (None, None) if not affine else (t(s), t(b))
    slope = LEAKY_SLOPE if act else None
    _, stats = norm_kernel._plain_r3_forward(tx, ts, tb, slope,
                                             norm_kernel.EPS)
    tdy = t(np.asarray(dy, np.float32)).to(
        torch.float32 if affine else torch.bfloat16)
    return tx, tdy, stats, ts, tb, slope, want


def held_r3_bwd(got, want) -> bool:
    """``got`` (dx, dγ, dβ) against ``want`` (numpy): dx in bf16 within
    one bf16 ulp and bit-equal but for at most R3_BWD_NOT_EQUAL_MAX of
    elements; dγ and dβ within R3_BWD_PARAM_RTOL of their largest."""
    if got[0].dtype != torch.bfloat16:
        return False
    dx, w = got[0].float().numpy(), want[0]
    ok = (np.abs(dx - w) <= 2.0 ** -7 * np.maximum(np.abs(dx),
                                                   np.abs(w))).all()
    ok &= (dx != w).mean() <= R3_BWD_NOT_EQUAL_MAX
    for g_, w_ in zip(got[1:], want[1:]):
        ok &= (np.abs(g_.numpy() - w_) <= R3_BWD_PARAM_RTOL
               * np.abs(w_).max()).all()
    return bool(ok)


@pytest.mark.parametrize("affine,act", [(True, True), (True, False),
                                        (False, False)],
                         ids=["affine-leaky", "affine", "plain"])
def test_r3centered_backward_twin_matches_jax(affine, act):
    """The twin of K2b's r3centered mode equals JAX's autodiff of the bf16
    norm (within ``held_r3_bwd``), and torch autograd of the forward twin
    as well."""
    tx, tdy, stats, s, b, slope, want = r3_bwd_case(affine, act)
    got = norm_kernel.instance_norm_bwd_plain(tx, tdy, stats, s, b, slope,
                                              r3centered=True)
    assert got[0].dtype == torch.bfloat16
    assert held_r3_bwd(got, want)
    leaves = [tx.clone().requires_grad_()] + (
        [s.clone().requires_grad_(), b.clone().requires_grad_()]
        if affine else [])
    y = norm_kernel._plain_r3centered(
        *leaves, *([] if affine else [None, None]), slope, norm_kernel.EPS)
    auto = torch.autograd.grad(y, leaves, tdy)
    assert held_r3_bwd(auto, [g_.float().numpy() for g_ in got
                              if g_ is not None])


def _r3_bwd_by_hand(x, dy, stats, s, b, slope, round_g, dgamma_of_n):
    """The r3centered backward at an affine call site written out, with
    the rounding of g and the rounding of x̂ in dγ as switches."""
    m1, inv = (v[:, None, None, :] for v in stats[..., 1:].unbind(-1))
    xhat = (x.float() - m1) * inv
    n = xhat.bfloat16().float()
    z = n * s + b
    dz = dy if slope is None else torch.where(z >= 0, dy, dy * slope)
    g = dz * s
    if round_g:
        g = g.bfloat16().float()
    dx = (g - g.mean((1, 2), keepdim=True)
          - xhat * (g * xhat).mean((1, 2), keepdim=True)) * inv
    return (dx.bfloat16(), (dz * (n if dgamma_of_n else xhat)).sum((0, 1, 2)),
            dz.sum((0, 1, 2)))


def _shifted_residuals(x, dy, stats, s, b, slope):
    """The shifted forward's residuals (K2 outside its r3centered mode:
    s = x[b, 0, 0, c], m1 = E[x − s]) read by the r3centered backward,
    which takes s = 0."""
    _, shifted = norm_kernel._plain_forward(x, s, b, slope, norm_kernel.EPS)
    shifted[..., 0] = 0.0
    return norm_kernel.instance_norm_bwd_plain(x, dy, shifted, s, b, slope,
                                               r3centered=True)


PLANTED_BWD = {
    "g not rounded to bf16": lambda *a: _r3_bwd_by_hand(*a, False, True),
    "dgamma from unrounded xhat": lambda *a: _r3_bwd_by_hand(*a, True,
                                                             False),
    "shifted residuals": _shifted_residuals,
    "dx returned in float32": lambda x, *a: norm_kernel.
        instance_norm_bwd_plain(x.float(), *a, r3centered=True),
}


@pytest.mark.parametrize("fault", sorted(PLANTED_BWD))
def test_r3centered_backward_check_rejects_a_planted_fault(fault):
    """Each planted departure from the gradient's contract fails
    ``held_r3_bwd`` at the affine + leaky call site, where the written-out
    backward without a fault passes it."""
    tx, tdy, stats, s, b, slope, want = r3_bwd_case(True, True)
    assert held_r3_bwd(_r3_bwd_by_hand(tx, tdy, stats, s, b, slope, True,
                                       True), want)
    assert not held_r3_bwd(PLANTED_BWD[fault](tx, tdy, stats, s, b, slope),
                           want)


def test_instance_norm_function_bf16_on_cpu():
    """Under autograd a bf16 norm (affine + leaky, without affine, and
    without affine with the leaky, whose negative side the forward
    rounds to bf16) runs the r3centered forward and backward twins: the
    gradient reaches x in bf16 and γ, β in float32, equal to the
    backward twin on the forward's residuals and within
    ``held_r3_bwd`` of torch autograd through the forward twin."""
    rng = np.random.default_rng(6)
    x = t(rng.normal(0.7, 1.5, (2, 5, 7, 16)).astype(np.float32)).bfloat16()
    s = t((1.0 + 0.3 * rng.normal(size=16)).astype(np.float32))
    b = t(rng.normal(size=16).astype(np.float32))
    for affine, slope in ((True, LEAKY_SLOPE), (False, None),
                          (False, LEAKY_SLOPE)):
        leaves = [x.clone().requires_grad_()] + (
            [s.clone().requires_grad_(), b.clone().requires_grad_()]
            if affine else [])
        y = norm_kernel.instance_norm(*leaves, slope=slope)
        assert type(y.grad_fn).__name__ == "InstanceNormFunctionBackward"
        assert y.dtype == (torch.float32 if affine else torch.bfloat16)
        dy = t(rng.normal(size=y.shape).astype(np.float32)).to(y.dtype)
        got = torch.autograd.grad(y, leaves, dy)
        assert [g_.dtype for g_ in got] == [torch.bfloat16] + (
            [torch.float32] * 2 if affine else [])
        _, stats = norm_kernel._plain_r3_forward(
            x, s if affine else None, b if affine else None, slope,
            norm_kernel.EPS)
        want = norm_kernel.instance_norm_bwd_plain(
            x, dy, stats, s if affine else None, b if affine else None,
            slope, r3centered=True)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
        leaves = [v.detach().clone().requires_grad_() for v in leaves]
        y = norm_kernel._plain_r3centered(
            *leaves, *([] if affine else [None, None]), slope,
            norm_kernel.EPS)
        auto = torch.autograd.grad(y, leaves, dy)
        assert held_r3_bwd(got, [g_.float().numpy() for g_ in auto])


# ---------------------------------------------------------------------------
# the motion transformer
# ---------------------------------------------------------------------------


def test_motion_transformer_bf16_matches_jax():
    jm = motion_cfg(JC)
    params = motion_tree(jm, seed=1)
    rng = np.random.default_rng(0)
    src = rng.normal(size=(2, 17, 38)).astype(np.float32)
    mask = np.zeros((2, 17), bool)
    mask[1, -4:] = True
    args = (src, mask, src, mask)
    want = {name: jax.jit(lambda p, *a, m=jbm(cfg): m.apply(
                {"params": p}, *a, 4))(params, *map(jnp.asarray, args))
            for name, cfg in (("f32", jm), ("bf16", bf16(jm)))}
    model = convert.load_flax_params(
        TM.build_motion_model(bf16(motion_cfg(TC))), params).eval()
    cast_weights_(model, (TM.Dense,))
    assert model.input_embed.weight.dtype == torch.bfloat16
    assert model.decoder_norm.weight.dtype == torch.float32
    with torch.no_grad():
        got = model(*map(t, args), 4)
    for i, name in enumerate(("joints", "reco")):
        assert got[i].dtype == torch.float32
        hold_bf16(name, got[i], want["bf16"][i], want["f32"][i],
                  MEAN_TOL[name])


# ---------------------------------------------------------------------------
# one generator step
# ---------------------------------------------------------------------------

H, W = 64, 96


@pytest.fixture(scope="module")
def step_case():
    """Weights, inputs and the JAX float32 generator step on them (the
    standard generator: the parity layout computes the same function)."""
    jr = renderer_cfg(JC, H, W)
    params, stats = generator_trees(jr, H, W, seed=2)
    rng = np.random.default_rng(3)
    ins = [rng.uniform(-1, 1, (2, H, W, c)).astype(np.float32)
           for c in (22, 22, 3, 3)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RENDERLOOM_FASTPATH", "0")
        f32 = _jax_step(jr, params, stats, ins)
    return params, stats, ins, f32


def _jax_step(cfg, params, stats, ins):
    gen, folded = JG.make_inference_pair(cfg, params, stats)
    return jax.jit(lambda p, *a: gen.apply({"params": p}, *a))(
        folded, *map(jnp.asarray, ins))


@pytest.mark.parametrize("fastpath", [False, True],
                         ids=["standard", "fastpath"])
def test_generator_step_bf16_matches_jax(monkeypatch, step_case, fastpath):
    params, stats, ins, want_f32 = step_case
    monkeypatch.setenv("RENDERLOOM_FASTPATH", "1" if fastpath else "0")
    if fastpath:
        monkeypatch.setenv("RENDERLOOM_PACKED_LEVELS", "2")
        monkeypatch.setenv("RENDERLOOM_PALLAS_NORM", "1")
    want = _jax_step(bf16(renderer_cfg(JC, H, W)), params, stats, ins)
    assert want[0].dtype == want[1].dtype == jnp.bfloat16
    gen = TG.make_inference_pair(bf16(renderer_cfg(TC, H, W)), params,
                                 stats, "cpu", fastpath=fastpath)
    assert isinstance(gen, FastInferenceGen) == fastpath
    with torch.no_grad():
        got = gen(*map(t, ins))
    for i, name in enumerate(("img", "mask")):
        assert got[i].dtype == torch.bfloat16
        hold_bf16(name, got[i].float(), want[i], want_f32[i],
                  MEAN_TOL[name])
