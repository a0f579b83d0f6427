"""The renderer's GAN train step of the PyTorch port on alternate
perceptual backbones, against the JAX package's ``make_gan_train_step``
with ``PerceptualLoss(network=...)``, and the training CLI's choice of
perceptual model, on the CPU.

* One float32 step with AlexNet (here) and one with ResNet-50 (batch
  norms at random running statistics; test_torch_perceptual_train_
  resnet.py, which imports these tests) at tests/test_torch_train_step.py's shapes
  (64×96, B = 2, L = 3, its batch), from the same G and D trees; each
  backbone's weights written as a torchvision-schema ``.pth`` (the
  port's ``make_perceptual(..., network=, weights_path=)``) and
  ``.npz`` (JAX's loader).  G and D are that test's (its batch puts no
  activation of G or D within rounding of a kink; a cut-down G tried
  first had one, and missed JAX by 8e-3 on VGG19 too); the JAX step's
  compile is most of the file's time.
  Tolerances, float32: the perceptual term ``g/perc`` 1e-5 relative
  (it reads G's forward only); the other metrics as that test holds them
  (d/* 1e-4, g/* 1e-3: the G losses read the updated D, whose AMSGrad
  step turns rounding into ±lr); each gradient leaf within 2e-4 of its
  largest plus 1e-4 of the network's largest (a vanishing leaf below
  1e-4 of the net's largest on both sides); parameters within 2·lr, at
  most 2% (G) and 5% (D) of the elements beyond 1e-5, as that test's
  small share.  Readings: the perceptual gradient alone agrees to 1e-6
  of its largest (``test_torch_backbones.py``); in the step, AlexNet's
  G leaves reach 9.7e-5 of their own largest, ResNet-50's small G
  leaves (the mask net's norms, 4e-3 of the net's largest) 1.3e-3 of
  their own but 7.6e-6 of the net's, and a run of the file under pytest
  read 3.2e-4 of a leaf's own (6e-5 of the net's): float32 rounding
  through the random-statistics batch norms and G, which moves by the
  run.
* The CLI (``cli/train_renderer.main --synthetic --device cpu``) on a
  config whose ``perceptual.model`` is ``alexnet`` trains on VGG19, as
  the JAX package's CLI does: it reads that field nowhere.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
import test_torch_train_step as TS
from test_torch_backbones import jax_variables, write_weights
from _torch_parity import single_thread, t  # noqa: F401
from renderloom.models.discriminator import DiscriminatorSet as JDis
from renderloom.models.perceptual import PerceptualLoss as JPerceptual
from renderloom.models.renderer import Generator as JGenerator
from renderloom.train import gan as JG
from renderloom_torch import convert
from renderloom_torch.cli import train_renderer
from renderloom_torch.models.perceptual import VGG19Features
from renderloom_torch.train import gan as TG

H, W = TS.H, TS.W
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cfg(C):
    """tests/test_torch_train_step.py's config, whose batch puts no
    activation within rounding of a kink."""
    return TS.cfg(C)


@pytest.fixture(scope="module")
def trees():
    return TS.make_trees()


def jax_step(trees, perceptual):
    jcfg = cfg(JC)
    tx_g, tx_d = JG.make_gan_optimizers(jcfg)
    state = JG.GanTrainState(
        params_g=trees["params_g"], params_d=trees["params_d"],
        stats_g=trees["stats_g"], stats_d=trees["stats_d"],
        opt_g=tx_g.init(trees["params_g"]), opt_d=tx_d.init(trees["params_d"]),
        step=jnp.zeros((), jnp.int32), key=jax.random.PRNGKey(0))
    step = JG.make_gan_train_step(JGenerator(jcfg.gen, jnp.float32),
                                  JDis(jcfg.dis, jnp.float32), (tx_g, tx_d),
                                  jcfg, perceptual)
    before = jax.tree.map(np.array, state)
    new_state, metrics = step(state, TS.make_batch())
    return (before, jax.device_get(new_state),
            {k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module", params=["alexnet"])
def backbone(request):
    """The backbone of this file's step (ResNet-50's is
    test_torch_perceptual_train_resnet.py's, which imports these
    tests)."""
    return request.param


@pytest.fixture(scope="module")
def steps(backbone, trees, tmp_path_factory):
    net = backbone
    jax_variables(net)
    pth, npz = write_weights(net, str(tmp_path_factory.mktemp(net)))
    before, after, metrics = jax_step(trees, JPerceptual(network=net,
                                                         weights_path=npz))
    tcfg = cfg(TC)
    tstate = TG.create_gan_state(tcfg, "cpu", trees=trees)
    perc = TG.make_perceptual(tcfg, "cpu", network=net, weights_path=pth)
    assert perc.pretrained and perc.weights == (1.0,) * len(perc.layers)
    tmetrics = TG.make_gan_train_step(tcfg, perc)(
        tstate, {k: t(v) for k, v in TS.make_batch().items()})
    return (net, before, after, metrics, tstate,
            {k: float(v) for k, v in tmetrics.items()})


def test_metrics_match_jax(steps):
    _, _, _, want, _, got = steps
    assert got.keys() == want.keys()
    for k in want:
        tol = 1e-5 if k == "g/perc" else 1e-4 if k.startswith("d/") \
            else 1e-3
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=1e-6,
                                   err_msg=k)
    assert got["g/perc"] > 0
    assert got["notfinite/g"] == got["notfinite/d"] == 0.0


@pytest.mark.parametrize("net", ["g", "d"])
def test_gradients_of_the_step_match_jax(steps, net):
    _, _, after, _, tstate, _ = steps
    module = tstate.gen if net == "g" else tstate.dis
    got = TS._port_grads(module, getattr(tstate, f"opt_{net}"))
    want = TS._jax_grads(after, net, tstate.opt_g.b1)
    assert got.keys() == want.keys()
    top = max(np.abs(v).max() for v in want.values())
    vanishing = TS._vanishing(want)
    for k in want:
        if k in vanishing:
            assert np.abs(got[k]).max() < 1e-4 * top, k
            continue
        err = np.abs(got[k] - want[k]).max()
        assert err <= 2e-4 * np.abs(want[k]).max() + 1e-4 * top, \
            (k, err / np.abs(want[k]).max(), err / top)


@pytest.mark.parametrize("net,lr,share", [("g", 1e-4, 0.02),
                                          ("d", 4e-4, 0.05)])
def test_parameters_after_the_step_match_jax(steps, net, lr, share):
    _, before, after, _, tstate, _ = steps
    module = tstate.gen if net == "g" else tstate.dis
    got = TS._flat(convert.flax_trees(module)[0])
    want = TS._flat(getattr(after, f"params_{net}"))
    old = TS._flat(getattr(before, f"params_{net}"))
    assert got.keys() == want.keys()
    n_off = n_all = 0
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 * lr + 1e-5, (k, diff.max())
        n_off += int((diff > 1e-5).sum())
        n_all += diff.size
    assert n_off <= share * n_all, (n_off, n_all)
    moved = sum(int((np.abs(want[k] - old[k]) >= 0.99 * lr).sum())
                for k in want)
    assert moved >= n_all // 2


def test_cli_trains_on_vgg19_whatever_the_config_names(tmp_path,
                                                         monkeypatch):
    """A config with ``perceptual.model: alexnet`` takes its step on
    VGG19, as the JAX package's CLI (which builds ``PerceptualLoss(
    require_pretrained=..., compute_dtype=...)``, always VGG19)."""
    with open(os.path.join(ROOT, "configs", "smoke_hsm.yaml")) as f:
        text = f.read()
    config = tmp_path / "alexnet.yaml"
    config.write_text(text + "\nperceptual:\n  model: alexnet\n")
    assert TC.load_renderer_config(str(config)).perceptual.model == "alexnet"
    built = []
    make = train_renderer.make_perceptual

    def spy(*args, **kwargs):
        built.append(make(*args, **kwargs))
        return built[-1]
    monkeypatch.setattr(train_renderer, "make_perceptual", spy)
    train_renderer.main(["--synthetic", "--device", "cpu", "--config",
                         str(config), "--height", "64", "--width", "96",
                         "--batch-size", "1", "--steps-per-epoch", "1",
                         "--epochs", "1", "--out-dir", str(tmp_path / "run")])
    (perc,) = built
    assert isinstance(perc.model, VGG19Features)
    assert perc.layers == TC.PerceptualConfig().layers
    assert os.path.exists(tmp_path / "run" / "checkpoint.pt")
