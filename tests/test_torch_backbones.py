"""The alternate perceptual backbones of the PyTorch port against the JAX
package's ``renderloom/models/backbones.py`` on the CPU: VGG16, AlexNet,
ResNet-50 and robust ResNet-50 here; Inception-v3 and VGG-Face in
test_torch_backbones_inception.py and test_torch_backbones_vgg_face.py,
which import this file's tests and name their networks in their own
module-scoped ``net`` fixture.

Per network: the JAX module's variables (``jax.eval_shape`` of its
``init``, filled from a numpy seed, batch norms with random running
statistics), written as a torchvision-schema state dict (``.pth`` with
``torch.save`` for the port, ``.npz`` for the JAX package, robust
ResNet-50 under ``module.model.`` prefixes in a ``model`` envelope,
VGG-Face in Oxford's naming with a 4-D fc6), and one jitted JAX function
giving the taps at 64×96 (Inception 96×128), the perceptual loss with
its gradient and the LPIPS distance (the JAX ``PerceptualLoss`` built
from the ``.npz``, its variables passed as an argument, so that XLA
does not embed them as constants).  The tests: the taps and shapes, the
loaders on the same arrays, ``PerceptualLoss(network=...)``'s value,
gradient and ``lpips``, ``require_pretrained`` naming the network.

Tolerances, float32: taps, loss and LPIPS 1e-5 of each output's largest
magnitude (VGG-Face's fc taps 3e-4 absolute, as the JAX package's own
VGG-Face test against torch); gradients 1e-4 of their largest.
"""

from __future__ import annotations

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import single_thread  # noqa: F401

from renderloom.models import backbones as JB
from renderloom.models.perceptual import PerceptualLoss as JPerceptual
from renderloom_torch.models import backbones as TB
from renderloom_torch.models.perceptual import PerceptualLoss

TAP_TOL, GRAD_TOL, FC_ATOL = 1e-5, 1e-4, 3e-4


def input_hw(net: str):
    """Inception's five stride-2 stages need about 75 px; the JAX
    package's own test uses 96×128 for it, 64×96 for the others."""
    return (96, 128) if net == "inception_v3" else (64, 96)


def fill(tree, rng: np.random.Generator) -> dict:
    """numpy values for an ``eval_shape`` tree: lecun-scaled kernels,
    small biases, scales near 1, running means near 0 and variances in
    [0.5, 1.5]."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = fill(v, rng)
            continue
        shape = v.shape
        if k == "kernel":
            val = rng.standard_normal(shape, np.float32) / np.float32(
                np.sqrt(np.prod(shape[:-1])))
        elif k == "bias":
            val = 0.1 * rng.standard_normal(shape, np.float32)
        elif k == "scale":
            val = 1.0 + 0.1 * rng.standard_normal(shape, np.float32)
        elif k == "mean":
            val = 0.1 * rng.standard_normal(shape, np.float32)
        elif k == "var":
            val = rng.uniform(0.5, 1.5, shape)
        else:
            raise KeyError(k)
        out[k] = np.asarray(val, np.float32)
    return out


# robust ResNet-50 is ResNet-50's module under another loader: its case
# runs ResNet-50's variables, inputs and JAX outputs (computed once per
# process), read through its own ``.pth`` and loaders
ARCH = {"robust_resnet50": "resnet50"}


@functools.lru_cache(maxsize=None)
def jax_variables(net: str, seed: int = 0) -> dict:
    """Filled variables of ``net``'s JAX module (the caller must not
    change them: they are cached)."""
    cls, _, layers = JB.BACKBONES[net]
    # VGG-Face's fc6 needs the 224-input 7×7 grid at init (as JAX's)
    h, w = (224, 224) if net == "vgg_face_dag" else input_hw(net)
    shapes = jax.eval_shape(cls(layers).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, h, w, 3)))
    rng = np.random.default_rng(seed)
    return {k: fill(v, rng) for k, v in shapes.items()}


@functools.lru_cache(maxsize=None)
def port_module(arch: str) -> torch.nn.Module:
    """The port's module of ``arch`` on :func:`jax_variables` (cached:
    not to be changed)."""
    model = TB.BACKBONES[arch][0](TB.BACKBONES[arch][2])
    return TB.load_variables(model, jax_variables(arch))


def _resnet_key(k: str) -> str:
    head, _, rest = k.partition(".")
    if head.startswith("layer") and "_" in head:
        s, b = head[len("layer"):].split("_")
        rest = rest.replace("down_conv.", "downsample.0.").replace(
            "down_bn.", "downsample.1.")
        return f"layer{s}.{b}.{rest}"
    return k


def torchvision_state(net: str, oxford: bool = False) -> dict:
    """The torchvision-schema state dict (numpy) of ``net``'s
    :func:`jax_variables`, written by hand from the port module's names;
    ``oxford``: VGG-Face in Oxford's naming, fc6 as a 4-D 7×7 conv."""
    state = {k: v.numpy() for k, v in
             port_module(ARCH.get(net, net)).state_dict().items()}
    out = {}
    for k, v in state.items():
        name, leaf = k.rsplit(".", 1)
        if net in ("vgg16", "vgg_face_dag") and name.startswith("conv_"):
            b, i = name.split("_")[1:]
            out[f"conv{b}_{i}.{leaf}" if oxford else
                f"features.{TB.VGG16_CONV_IDX[name]}.{leaf}"] = v
        elif net == "alexnet":
            idx = TB._ALEXNET_SPECS[int(name.split("_")[1]) - 1][0]
            out[f"features.{idx}.{leaf}"] = v
        elif net == "vgg_face_dag":
            if oxford:
                if name == "fc6" and leaf == "weight":
                    v = v.reshape(v.shape[0], 512, 7, 7)
                out[k] = v
            else:
                idx = {"fc6": 0, "fc7": 3, "fc8": 6}[name]
                out[f"classifier.{idx}.{leaf}"] = v
        elif net in ("resnet50", "robust_resnet50"):
            out[_resnet_key(k)] = v
        else:                       # inception: torchvision's own names
            out[k] = v
    if net == "robust_resnet50":
        out = {f"module.model.{k}": v for k, v in out.items()}
    if net == "inception_v3":       # the heads the loader skips
        out["fc.weight"] = np.zeros((4, 2048), np.float32)
        out["AuxLogits.conv0.conv.weight"] = np.zeros((2, 768, 1, 1),
                                                      np.float32)
    return out


def write_weights(net: str, tmp: str):
    """(``.pth`` for the port, ``.npz`` for JAX) of the torchvision state;
    robust ResNet-50's ``.pth`` in a ``model`` envelope, VGG-Face's in
    Oxford's naming."""
    oxford = net == "vgg_face_dag"
    state = torchvision_state(net, oxford=oxford)
    pth, npz = os.path.join(tmp, f"{net}.pth"), os.path.join(tmp, f"{net}.npz")
    tensors = {k: torch.from_numpy(v) for k, v in state.items()}
    torch.save({"model": tensors} if net == "robust_resnet50" else tensors,
               pth)
    np.savez(npz, **(torchvision_state(net) if oxford else state))
    return pth, npz


def lpips_defined(net: str) -> bool:
    """JAX's ``lpips`` averages each tap over axes 1–3, which VGG-Face's
    2-D fc taps lack: there it raises, and so does the port's."""
    return net != "vgg_face_dag"


def jax_outputs(p: JPerceptual, x, pred, target):
    """Taps of ``x``, (loss, its gradient in ``pred``) and LPIPS (None
    where it is not defined), from the JAX package's ``PerceptualLoss``
    ``p``, in one jitted call."""
    with_lpips = all(len(s.shape) == 4 for s in jax.eval_shape(
        p.model.apply, p.variables, x).values())

    def f(variables, x, pred, target):
        q = copy.copy(p)
        q.variables = variables
        taps = p.model.apply(variables, x)
        loss, grad = jax.value_and_grad(q.__call__)(pred, target)
        return (taps, loss, grad,
                q.lpips(pred, target) if with_lpips else None)

    return jax.tree.map(np.asarray,
                        jax.jit(f)(p.variables, x, pred, target))


_JAX_CASES: dict = {}


def _jax_case(arch: str, npz: str):
    h, w = input_hw(arch)
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, h, w, 3)).astype(np.float32)
    pred = rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
    jp = JPerceptual(network=arch, weights_path=npz)
    return (x, pred, target, jp) + tuple(jax_outputs(jp, x, pred, target))


def make_case(net: str, tmp: str) -> dict:
    arch = ARCH.get(net, net)
    variables = jax_variables(arch)
    pth, npz = write_weights(net, tmp)
    if arch != net:         # the architecture's JAX loss and outputs
        write_weights(arch, tmp)
    if arch not in _JAX_CASES:
        _JAX_CASES[arch] = _jax_case(arch, os.path.join(tmp, f"{arch}.npz"))
    x, pred, target, jp, taps, loss, grad, lpips = _JAX_CASES[arch]
    return dict(net=net, x=x, pred=pred, target=target,
                variables=variables, pth=pth, npz=npz, jax_loss=jp,
                taps=taps, loss=loss, grad=grad, lpips=lpips)


@pytest.fixture(scope="module")
def case(net, tmp_path_factory):
    return make_case(net, str(tmp_path_factory.mktemp(net)))


def hold_taps(net: str, got: dict, want: dict, err_msg: str = ""):
    assert set(got) == set(want) == set(JB.BACKBONES[net][2])
    for k in want:
        g = got[k].detach().numpy()
        assert g.shape == want[k].shape, (k, g.shape, want[k].shape)
        if net == "vgg_face_dag" and k != "avgpool":
            np.testing.assert_allclose(g, want[k], rtol=0, atol=FC_ATOL,
                                       err_msg=f"{err_msg}{k}")
        else:
            err = np.abs(g - want[k]).max() / np.abs(want[k]).max()
            assert err <= TAP_TOL, (f"{err_msg}{k}", err)


def test_taps_match_jax(case):
    """The port's module on the JAX variables gives JAX's taps and
    shapes."""
    model = port_module(ARCH.get(case["net"], case["net"]))
    with torch.no_grad():
        got = model(torch.from_numpy(case["x"]))
    hold_taps(case["net"], got, case["taps"])


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def port_loss(case) -> PerceptualLoss:
    """``PerceptualLoss(network=...)`` read from the case's ``.pth``
    (built once per case)."""
    if "port_loss" not in case:
        case["port_loss"] = PerceptualLoss(network=case["net"],
                                           weights_path=case["pth"],
                                           require_pretrained=True)
    return case["port_loss"]


def test_loader_matches_jax(case):
    """The port's loader gives JAX's loader's tree on the same
    torchvision-schema arrays, bit for bit, and the ``.pth`` that
    ``PerceptualLoss`` reads through ``build_backbone`` loads exactly
    the variables it was written from."""
    net = case["net"]
    state = TB.read_state(case["pth"])
    got = dict(_leaves(TB.BACKBONES[net][1](state)))
    want = dict(_leaves(JB.BACKBONES[net][1](state)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    p = port_loss(case)
    assert p.pretrained and p.layers == JB.BACKBONES[net][2]
    ref = port_module(ARCH.get(net, net)).state_dict()
    assert p.model.state_dict().keys() == ref.keys()
    for k, v in p.model.state_dict().items():
        assert torch.equal(v, ref[k]), k


def test_perceptual_loss_matches_jax(case):
    """``PerceptualLoss(network=...)`` from the ``.pth``: its value, its
    gradient in the prediction, and ``lpips`` against the JAX loss from
    the ``.npz``; uniform tap weights, as JAX's."""
    net = case["net"]
    p = port_loss(case)
    assert p.layers == tuple(case["jax_loss"].layers)
    assert p.weights == tuple(case["jax_loss"].weights) == \
        (1.0,) * len(p.layers)
    pred = torch.from_numpy(case["pred"]).requires_grad_(True)
    target = torch.from_numpy(case["target"])
    loss = p(pred, target)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), case["loss"],
                               rtol=TAP_TOL, err_msg="loss")
    err = (np.abs(pred.grad.numpy() - case["grad"]).max()
           / np.abs(case["grad"]).max())
    assert err <= GRAD_TOL, err
    with torch.no_grad():
        if not lpips_defined(net):
            assert case["lpips"] is None
            with pytest.raises(IndexError):
                p.lpips(pred, target)
            with pytest.raises(IndexError):
                jax.eval_shape(case["jax_loss"].lpips, case["pred"],
                               case["target"])
            return
        lp = p.lpips(pred, target).numpy()
    assert lp.shape == (2,)
    np.testing.assert_allclose(lp, case["lpips"], rtol=TAP_TOL,
                               err_msg="lpips")


def test_require_pretrained_names_the_network(case):
    with pytest.raises(RuntimeError, match=case["net"]):
        PerceptualLoss(network=case["net"], require_pretrained=True)


@pytest.fixture(scope="module",
                params=["vgg16", "alexnet", "resnet50", "robust_resnet50"])
def net(request):
    return request.param


@pytest.mark.parametrize("prefix", ["module.attacker.model.", "model."])
def test_robust_loader_unwraps_each_prefix(prefix):
    """Robust ResNet-50 keys under the other prefixes, with the first of
    two keys that strip to one name winning, as in JAX's loader."""
    plain = torchvision_state("resnet50")
    state = {prefix + k: v for k, v in plain.items()}
    state["conv1.weight"] = np.zeros_like(plain["conv1.weight"])
    got = TB.load_robust_resnet50_state(state)
    want = JB.load_robust_resnet50_state(state)
    np.testing.assert_array_equal(got["params"]["conv1"]["kernel"],
                                  want["params"]["conv1"]["kernel"])
    assert np.abs(got["params"]["conv1"]["kernel"]).max() > 0
    for tree in ("params", "batch_stats"):
        np.testing.assert_array_equal(
            got[tree]["layer4_2"]["bn3"][
                "scale" if tree == "params" else "var"],
            want[tree]["layer4_2"]["bn3"][
                "scale" if tree == "params" else "var"])
