"""Weight bridge of the reference: flax param trees → its modules, and
spectral-norm folding.  Frozen copy of the port's ``convert.py``
(``fold_spectral_norm``, ``state_dict_from_flax``,
``state_dict_from_flax_stats``, ``load_flax_params``): conv kernels go
HWIO → OIHW, dense kernels (in, out) → (out, in), ``scale`` →
``weight``; the ``batch_stats`` tree gives the spectral-norm state
(``sn_u``, ``sn_sigma``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn



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
