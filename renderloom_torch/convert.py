"""Weight bridge: flax param trees ↔ the port's modules, spectral-norm
folding, and seeded random weights.

* :func:`fold_spectral_norm` — port of ``renderloom/train/gan.py:
  fold_spectral_norm``: one power step from each stored ``u`` gives σ,
  and the matching conv kernel is divided by it (``σ == 0`` leaves the
  kernel as it is).  Works on numpy trees, as ``jax.device_get`` gives
  them.
* :func:`state_dict_from_flax` / :func:`load_flax_params` — the port's
  modules carry the flax tree's names, so a tree loads by path: conv
  kernels go HWIO → OIHW (the inverse of
  ``renderloom/data/torch_import.py:_conv_w``), dense kernels (in, out) →
  (out, in), ``scale`` → ``weight``, the motion transformer's learned
  position table (``embedding``) and the layer variants' ``gamma`` and
  ``beta`` as they are, 3-D kernels DHWIO → OIDHW;
  ``load_state_dict(strict=True)``
  refuses a tree that misses or adds a name.  With ``stats`` (the
  ``batch_stats`` tree) the spectral-norm state loads too:
  ``<conv>/sn/conv/kernel/u`` → ``<conv>.sn_u`` and ``…/sigma`` →
  ``<conv>.sn_sigma``, for modules in the training form
  (:func:`renderloom_torch.models.layers.enable_spectral_norm`), and a
  batch norm's ``mean`` and ``var`` → ``running_mean`` and
  ``running_var``.  This loads the generator, the discriminator set, the
  perceptual backbones and the layer variants alike.
* :func:`flax_trees` — the reverse direction: a module's (or a saved
  state dict's) parameters and spectral-norm state as numpy flax trees,
  for comparing a trained module with the JAX package's state and for
  serving from the port's checkpoints.
* :func:`random_init_` — seeded weights for runs without a checkpoint:
  lecun-normal kernels (as flax's default), zero biases, unit norm
  scales, and, for serving modules, spectral convs divided by their
  largest singular value, which is what folding does to a trained
  spectral conv (training modules keep the raw kernel, as flax's init
  does, and divide by σ at every call).
* :func:`flax_init_` — flax's own initial weights for the convolutional
  models the port trains from their initialisation (the flow UNet, the
  pose head), drawn from a seed: truncated lecun-normal kernels, zero
  biases, zero heads.

The flow UNet's and the pose head's flax trees load by the same name
mapping: their modules carry flax's names (``down{l}``, ``down{l}b``,
``up{l}``, ``flow_head``; ``Conv_0``, ``Conv_1``, ``_ResBlock_{i}/
Conv_{0,1,2}``, ``Conv_2``) and their kernels go HWIO ↔ OIHW.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from renderloom_torch.models.layers import Conv, SNConv


def _l2norm(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    return x / np.sqrt((x * x).sum() + np.float32(eps))


def _sigma(kernel: np.ndarray, u: np.ndarray) -> np.float32:
    mat = kernel.reshape(-1, kernel.shape[-1]).astype(np.float32)
    v = _l2norm(u.astype(np.float32) @ mat.T)
    u1 = _l2norm(v @ mat)
    return (v @ mat @ u1.T)[0, 0]


def fold_spectral_norm(params: Mapping, stats: Mapping) -> dict:
    """Divide every spectral conv kernel of ``params`` by its σ from the
    power-iteration state in ``stats`` (``batch_stats``); returns a new
    tree of float32 numpy arrays."""

    def walk(p, s):
        out = {}
        for k, v in p.items():
            sv = s.get(k, {}) if isinstance(s, Mapping) else {}
            out[k] = walk(v, sv) if isinstance(v, Mapping) \
                else np.asarray(v, np.float32)
        sn = s.get("sn") if isinstance(s, Mapping) else None
        if sn and "conv/kernel/u" in sn and "conv" in out:
            sig = _sigma(out["conv"]["kernel"],
                         np.asarray(sn["conv/kernel/u"]))
            sig = sig if sig != 0 else np.float32(1.0)
            out["conv"] = dict(out["conv"],
                               kernel=out["conv"]["kernel"] / sig)
        return out

    return walk(params, stats)


def _leaves(tree: Mapping, prefix: str = ""
            ) -> Iterator[Tuple[str, str, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix, k, np.asarray(v, np.float32)


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flat torch state dict of a flax param tree (numpy leaves)."""
    out = {}
    for prefix, name, leaf in _leaves(params):
        if name == "kernel" and leaf.ndim == 4:        # HWIO → OIHW
            out[prefix + "weight"] = leaf.transpose(3, 2, 0, 1)
        elif name == "kernel" and leaf.ndim == 5:      # DHWIO → OIDHW
            out[prefix + "weight"] = leaf.transpose(4, 3, 0, 1, 2)
        elif name == "kernel" and leaf.ndim == 2:      # (in, out) → (out, in)
            out[prefix + "weight"] = leaf.T
        elif name == "scale":
            out[prefix + "weight"] = leaf
        elif name in ("bias", "embedding", "gamma", "beta"):
            out[prefix + name] = leaf
        else:
            raise KeyError(f"no torch counterpart for {prefix}{name}")
    return {k: torch.tensor(v) for k, v in out.items()}


def state_dict_from_flax_stats(stats: Mapping, prefix: str = ""
                               ) -> Dict[str, torch.Tensor]:
    """Flat torch buffers of a flax ``batch_stats`` tree: spectral-norm
    state (``{…: {"sn": {"conv/kernel/u": (1, O), "conv/kernel/sigma":
    ()}}}``) and batch norms' running statistics (``{…: {"mean": (C,),
    "var": (C,)}}`` → ``running_mean``, ``running_var``)."""
    out = {}
    for k, v in stats.items():
        if k == "sn":
            out[prefix + "sn_u"] = torch.tensor(
                np.asarray(v["conv/kernel/u"], np.float32))
            out[prefix + "sn_sigma"] = torch.tensor(
                np.asarray(v["conv/kernel/sigma"], np.float32))
        elif k in ("mean", "var"):
            out[prefix + "running_" + k] = torch.tensor(
                np.asarray(v, np.float32))
        else:
            out.update(state_dict_from_flax_stats(v, f"{prefix}{k}."))
    return out


def load_flax_params(module: nn.Module, params: Mapping,
                     stats: Optional[Mapping] = None) -> nn.Module:
    """Load a flax param tree (and, for a training module, its
    ``batch_stats``) into ``module`` by name (strict)."""
    state = state_dict_from_flax(params)
    if stats:
        state.update(state_dict_from_flax_stats(stats))
    module.load_state_dict(state, strict=True)
    return module


def _set(tree: dict, path: List[str], value: np.ndarray):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def flax_trees(module) -> Tuple[dict, dict]:
    """(params, batch_stats) of ``module`` (an ``nn.Module``, or its
    ``state_dict`` as read from a checkpoint) as numpy flax trees: the
    inverse of :func:`load_flax_params`."""
    state = module.state_dict() if isinstance(module, nn.Module) else module
    params, stats = {}, {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        v = t.detach().cpu().numpy()
        if leaf == "weight" and v.ndim == 4:           # OIHW → HWIO
            # contiguous, as a JAX tree is: numpy's matmuls in the
            # spectral-norm fold sum in an order that follows the layout
            _set(params, path + ["kernel"],
                 np.ascontiguousarray(v.transpose(2, 3, 1, 0)))
        elif leaf == "weight" and v.ndim == 5:         # OIDHW → DHWIO
            _set(params, path + ["kernel"],
                 np.ascontiguousarray(v.transpose(2, 3, 4, 1, 0)))
        elif leaf == "weight" and v.ndim == 2:         # (out, in) → (in, out)
            _set(params, path + ["kernel"], np.ascontiguousarray(v.T))
        elif leaf == "weight":
            _set(params, path + ["scale"], v)
        elif leaf in ("bias", "embedding", "gamma", "beta"):
            _set(params, path + [leaf], v)
        elif leaf in ("running_mean", "running_var"):
            _set(stats, path + [leaf[len("running_"):]], v)
        elif leaf == "sn_u":
            _set(stats, path + ["sn", "conv/kernel/u"], v)
        elif leaf == "sn_sigma":
            _set(stats, path + ["sn", "conv/kernel/sigma"], v)
        else:
            raise KeyError(f"no flax counterpart for {name}")
    return params, stats


def random_init_(module: nn.Module, seed: int) -> nn.Module:
    """Seeded weights, drawn on the CPU in module order so every device
    gets the same numbers; the power-iteration vectors of a training
    module are drawn from a normal after the weights."""
    g = torch.Generator().manual_seed(seed)
    spectral = {id(m.conv) for m in module.modules()
                if isinstance(m, SNConv) and m.spectral
                and not hasattr(m, "sn_u")}
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv, nn.Linear)):
                w = torch.randn(m.weight.shape, generator=g)
                w /= math.sqrt(w[0].numel())            # fan-in
                if id(m) in spectral:
                    w /= torch.linalg.matrix_norm(w.reshape(w.shape[0], -1),
                                                  ord=2)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for m in module.modules():
            if isinstance(m, SNConv) and hasattr(m, "sn_u"):
                m.sn_u.copy_(torch.randn(m.sn_u.shape, generator=g))
                m.sn_sigma.fill_(1.0)
    return module


# flax's truncated-normal stddev correction for the cut at ±2σ
_TRUNC_STD = 0.87962566103423978


def flax_init_(module: nn.Module, seed: int) -> nn.Module:
    """flax's default initialisers for every :class:`Conv` under
    ``module``, drawn on the CPU in module order from ``seed``:
    lecun-normal kernels (a normal of variance 1/fan_in, fan_in = I·kh·kw,
    truncated at two of its deviations) and zero biases; a conv whose
    ``zero_init`` is set (a head flax initialises with zeros) gets a zero
    kernel."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if not isinstance(m, Conv):
                continue
            if getattr(m, "zero_init", False):
                m.weight.zero_()
            else:
                std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
            if m.bias is not None:
                m.bias.zero_()
    return module
