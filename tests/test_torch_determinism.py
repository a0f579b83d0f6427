"""The port's train steps are reproducible: the counterpart of
tests/test_determinism.py.  Two copies of the same state fed the same
batches take two steps each, and their parameters, optimizer state,
generator and power-iteration state and metrics must be equal bit for
bit: the motion step (dropout on, the dropout generators seeded alike),
the float32 GAN step (tests/test_torch_train_step.py's tiny widths at
64×96), the flow step and the pose step with occlusion.  Port code only,
on the CPU.  On the card, chip_smoke.py's phase G reads which operators
are not reproducible there."""

import dataclasses

import numpy as np
import pytest
import torch

import renderloom_torch.core.config as TC
from _torch_parity import motion_cfg, renderer_cfg, single_thread  # noqa: F401
from renderloom_torch.cli import train_motion
from renderloom_torch.train import flow as TF
from renderloom_torch.train import gan as TG
from renderloom_torch.train import motion as TM
from renderloom_torch.train import pose as TP

H, W = 64, 96


def _opt_state(opt) -> dict:
    return {k: v.clone() for k, v in opt.state_dict().items()}


def _gan_case():
    tiny = lambda n, layers=2: TC.PatchDiscConfig(
        num_filters=4, max_num_filters=16, num_discriminators=n,
        num_layers=layers)
    cfg = dataclasses.replace(
        renderer_cfg(TC, H, W),
        dis=TC.DiscriminatorConfig(image=tiny(2), face=tiny(1),
                                   hand=tiny(1, layers=1)))
    vgg = TG.make_perceptual(cfg, "cpu", seed=0)
    rng = np.random.default_rng(0)
    shape = (2, 3, H, W)
    batches = []
    for _ in range(2):
        label = rng.uniform(-1, 1, shape + (22,)).astype(np.float32)
        label[..., 3:] = rng.uniform(0, 1, shape + (19,))
        batches.append({
            "label": torch.from_numpy(label),
            "image": torch.from_numpy(rng.uniform(-1, 1, shape + (3,))
                                      .astype(np.float32)),
            "back": torch.from_numpy(rng.uniform(-1, 1, shape + (3,))
                                     .astype(np.float32)),
            "fg_mask": torch.ones(shape + (1,))})

    def run():
        state = TG.create_gan_state(cfg, "cpu", seed=3)
        step = TG.make_gan_train_step(cfg, vgg)
        metrics = [step(state, b) for b in batches]
        return metrics, {"g": _opt_state(state.opt_g),
                         "d": _opt_state(state.opt_d),
                         "buffers": [b.clone() for m in (state.gen, state.dis)
                                     for b in m.buffers()],
                         "rng": state.rng.get_state()}

    return run


def _motion_case():
    cfg = motion_cfg(TC)
    cfg = dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, dropout=0.1))
    raws = [{k: torch.from_numpy(v) for k, v in raw.items()} for raw in
            train_motion.synthetic_batches(np.random.default_rng(1), 2, 2,
                                           33)]
    stats = (np.zeros((19, 2), np.float32), np.full((19, 2), 0.3, np.float32))

    def run():
        state = TM.create_motion_state(cfg, "cpu", seed=4)
        step = TM.make_train_step(cfg, *stats)
        metrics = [step(state, raw) for raw in raws]
        return metrics, {"opt": _opt_state(state.opt),
                         "rng": state.rng.get_state(),
                         "dropout_rng": state.dropout_rng.get_state()}

    return run


def _flow_case():
    cfg = TC.FlowConfig(base_filters=4, levels=2)
    rng = np.random.default_rng(2)
    batches = [{"frames": torch.from_numpy(rng.integers(
        0, 256, (2, 3, 32, 48, 3), dtype=np.uint8))} for _ in range(2)]

    def run():
        state = TF.create_flow_state(cfg, "cpu", seed=5)
        step = TF.make_flow_train_step(cfg)
        return [step(state, b) for b in batches], {
            "opt": _opt_state(state.opt)}

    return run


def _pose_case():
    cfg = TC.PoseNetConfig(base_filters=8, blocks=1, occlude_rate=0.5)
    rng = np.random.default_rng(3)
    batches = [{"images": torch.from_numpy(rng.integers(
        0, 256, (2, 32, 48, 3), dtype=np.uint8)),
        "poses": torch.from_numpy(np.concatenate(
            [rng.uniform(4, 28, (2, 19, 2)), rng.uniform(0, 1, (2, 19, 1))],
            -1).astype(np.float32))} for _ in range(2)]

    def run():
        state = TP.create_pose_state(cfg, "cpu", seed=6)
        step = TP.make_pose_train_step(cfg)
        return [step(state, b) for b in batches], {
            "opt": _opt_state(state.opt)}

    return run


def _equal(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert torch.equal(a, b), where


@pytest.mark.parametrize("case", ["motion", "gan", "flow", "pose"])
def test_two_runs_of_a_train_step_are_bit_equal(case):
    run = {"motion": _motion_case, "gan": _gan_case, "flow": _flow_case,
           "pose": _pose_case}[case]()
    (m1, s1), (m2, s2) = run(), run()
    _equal(m1, m2, "metrics")
    _equal(s1, s2, "state")
    # the steps did update (one update a step; the GAN windows train
    # one frame): a state that never moves is trivially equal
    opt = s1["g"] if case == "gan" else s1["opt"]
    assert int(opt["count"]) == 2
    assert all(np.isfinite(float(v)) for m in m1 for v in m.values())


@pytest.mark.parametrize("size", [(16, 24), (32, 48), (128, 192)])
def test_the_card_s_resize_matches_jax_and_its_gradient_is_a_matmul(size):
    """``ops.image.resize_matmul``, the card's antialiased resize (torch's
    antialiased ``F.interpolate``, the CPU's, adds its gradient with
    atomics on the card): ``jax.image.resize`` within 1e-5 downsampling
    and upsampling, and its gradient the transposed contraction of the
    same weights."""
    import jax
    import jax.numpy as jnp

    from _torch_parity import blobs
    from renderloom_torch.ops import image as TI

    x = blobs(2, 64, 96)
    want = jax.image.resize(jnp.asarray(x), (2,) + size + (3,), "bilinear")
    xt = torch.from_numpy(x).requires_grad_()
    got = TI.resize_matmul(xt, *size)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(
        got.detach().numpy(), TI.resize_bilinear(xt, *size).detach().numpy(),
        atol=1e-5)
    dy = torch.from_numpy(np.random.default_rng(0).normal(
        size=got.shape).astype(np.float32))
    (gx,) = torch.autograd.grad(got, xt, dy)
    _, vjp = jax.vjp(lambda v: jax.image.resize(v, (2,) + size + (3,),
                                                "bilinear"), jnp.asarray(x))
    np.testing.assert_allclose(gx.numpy(), np.asarray(vjp(jnp.asarray(
        dy.numpy()))[0]), atol=1e-5)
