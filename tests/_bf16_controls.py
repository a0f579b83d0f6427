"""Readings behind the bf16 limits of tests/test_torch_bf16.py,
tests/test_torch_pipeline.py and tests/test_torch_train_step.py: mean
and largest |port − JAX bf16| of each held output, for the port as it
is and for controls that depart from the bf16 function — the port in
float32, and the three departures from the r3centered norm's contract
that stay within one ulp of n (``test_torch_bf16.PLANTED``), planted at
its affine call sites by swapping the norm's CPU twin; for the train
step (``train``) the port as it is, in float32, and with the shifted
contract's backward planted at the bf16 norms (the gradient twin
called without ``r3centered``).

Run from the repository root (minutes on one CPU thread):
``JAX_PLATFORMS=cpu python tests/_bf16_controls.py [motion] [step]
[pipeline] [train]``.
"""

from __future__ import annotations

import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import renderloom.core.config as JC  # noqa: E402
import renderloom_torch.core.config as TC  # noqa: E402
import test_torch_bf16 as TB  # noqa: E402
import test_torch_pipeline as TP  # noqa: E402
import test_torch_train_step as TS  # noqa: E402
from _torch_parity import (bf16, generator_trees, motion_cfg,  # noqa: E402
                           motion_tree, renderer_cfg, t)
from renderloom_torch import convert  # noqa: E402
from renderloom_torch.eval.pipeline import build_pipeline  # noqa: E402
from renderloom_torch.models import motion_transformer as TM  # noqa: E402
from renderloom_torch.models.layers import cast_weights_  # noqa: E402
from renderloom_torch.ops import norm_kernel as NK  # noqa: E402
from renderloom_torch.train import gan as TG  # noqa: E402

SOUND = NK._plain_r3centered
# the test's planted slips, at affine call sites (elsewhere n is the
# output and the contract leaves them nothing to change)
PLANTS = {name: (lambda x, s, b, slope, eps, f=f: f(x, s, b, slope)
                 if s is not None else SOUND(x, s, b, slope, eps))
          for name, f in TB.PLANTED.items()}
RUNS = ["sound", "float32"] + list(PLANTS)


@contextlib.contextmanager
def planted(run):
    NK._plain_r3centered = PLANTS.get(run, SOUND)
    try:
        yield
    finally:
        NK._plain_r3centered = SOUND


def report(tag, got, jax_bf16, jax_f32):
    got, want, ref = (np.asarray(a, np.float32)
                      for a in (got, jax_bf16, jax_f32))
    d = np.abs(got - want)
    print(f"{tag}: mean |port - JAX bf16| {d.mean():.4e}, max "
          f"{d.max():.4e}; JAX bf16's own from float32 mean "
          f"{np.abs(want - ref).mean():.4e}", flush=True)


def motion():
    jm = motion_cfg(JC)
    params = motion_tree(jm, seed=1)
    rng = np.random.default_rng(0)
    src = rng.normal(size=(2, 17, 38)).astype(np.float32)
    mask = np.zeros((2, 17), bool)
    mask[1, -4:] = True
    args = (src, mask, src, mask)
    want = {name: jax.jit(lambda p, *a, m=TB.jbm(cfg): m.apply(
                {"params": p}, *a, 4))(params, *map(jnp.asarray, args))
            for name, cfg in (("f32", jm), ("bf16", bf16(jm)))}
    for run in ("sound", "float32"):
        cfg = motion_cfg(TC) if run == "float32" else bf16(motion_cfg(TC))
        model = convert.load_flax_params(TM.build_motion_model(cfg),
                                         params).eval()
        cast_weights_(model, (TM.Dense,))
        with torch.no_grad():
            got = model(*map(t, args), 4)
        for i, name in enumerate(("joints", "reco")):
            report(f"motion, {run}, {name}", got[i], want["bf16"][i],
                   want["f32"][i])


def step():
    H, W = TB.H, TB.W
    jr = renderer_cfg(JC, H, W)
    params, stats = generator_trees(jr, H, W, seed=2)
    rng = np.random.default_rng(3)
    ins = [rng.uniform(-1, 1, (2, H, W, c)).astype(np.float32)
           for c in (22, 22, 3, 3)]
    os.environ["RENDERLOOM_FASTPATH"] = "0"
    f32 = TB._jax_step(jr, params, stats, ins)
    for fastpath in (False, True):
        if fastpath:
            os.environ.update(RENDERLOOM_FASTPATH="1",
                              RENDERLOOM_PACKED_LEVELS="2",
                              RENDERLOOM_PALLAS_NORM="1")
        want = TB._jax_step(bf16(jr), params, stats, ins)
        for run in RUNS:
            cfg = renderer_cfg(TC, H, W)
            cfg = cfg if run == "float32" else bf16(cfg)
            with planted(run), torch.no_grad():
                gen = TG.make_inference_pair(cfg, params, stats, "cpu",
                                             fastpath=fastpath)
                got = gen(*map(t, ins))
            for i, name in enumerate(("img", "mask")):
                report(f"step, {'fastpath' if fastpath else 'standard'}, "
                       f"{run}, {name}", got[i].float(), want[i], f32[i])


def pipeline():
    weights, inputs, want_f32 = TP.case._fixture_function()
    for fastpath in (False, True):
        if fastpath:
            os.environ.update(RENDERLOOM_PACKED_LEVELS="2",
                              RENDERLOOM_PALLAS_NORM="1")
        want = TP._jax_fused(bf16(motion_cfg(JC)),
                             bf16(renderer_cfg(JC, TP.H, TP.W)), weights,
                             inputs, "tpu" if fastpath else "cpu")
        for run in RUNS:
            mcfg, rcfg = motion_cfg(TC), renderer_cfg(TC, TP.H, TP.W)
            if run != "float32":
                mcfg, rcfg = bf16(mcfg), bf16(rcfg)
            with planted(run):
                fn, _, _ = build_pipeline(mcfg, rcfg, TP.RATE, TP.K,
                                          device="cpu", fastpath=fastpath,
                                          **weights)
                got, _ = fn(*map(t, inputs))
            report(f"pipeline, {'fastpath' if fastpath else 'standard'}, "
                   f"{run}, fused frames", got, want, want_f32)


def train():
    trees = TS.make_trees()
    steps = TS.run_steps(trees)
    before, after, metrics, vgg = TS.jax_step(trees, "bfloat16")
    sound_bwd = NK.instance_norm_bwd_plain
    shifted_bwd = (lambda x, dy, stats, s=None, b=None, slope=None,
                   r3centered=False: sound_bwd(x, dy, stats, s, b, slope))
    for run, dtype, bwd in (("sound", "bfloat16", sound_bwd),
                            ("float32", "float32", sound_bwd),
                            ("shifted backward at the bf16 norms",
                             "bfloat16", shifted_bwd)):
        NK.instance_norm_bwd_plain = bwd
        try:
            bf16_steps = (before, after, metrics) + TS.port_step(
                trees, vgg, dtype)
        finally:
            NK.instance_norm_bwd_plain = sound_bwd
        vecs = {"metrics": TS.bf16_metric_vectors(steps, bf16_steps)}
        for net in ("g", "d"):
            vecs[net] = TS.bf16_grad_vectors(steps, bf16_steps, net)[:3]
        for name, (got, want, ref) in vecs.items():
            print(f"train, {run}, {name}: mean |port - JAX bf16| "
                  f"{np.abs(got - want).mean():.4e}; largest from float32 "
                  f"{np.abs(got - ref).max():.4e}, JAX bf16's "
                  f"{np.abs(want - ref).max():.4e}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    for part in sys.argv[1:] or ["motion", "step", "pipeline", "train"]:
        {"motion": motion, "step": step, "pipeline": pipeline,
         "train": train}[part]()
