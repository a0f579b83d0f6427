"""Seeded random weights, made on the device and handed to both sides as
flax param trees (numpy float32 leaves), the form the program's
``build_pipeline``, ``create_gan_state`` and ``make_perceptual`` take.

The tree's names and shapes come from the reference's modules built on
the ``meta`` device.  All normal draws of a tree are one call of
``torch.randn`` on the device from a generator seeded from the run's
seed; the kernels are then scaled to lecun-normal (variance 1/fan_in),
biases are 0 and layer-norm scales 1, the learned position table is
uniform in [0, 1), the spectral-norm vectors ``u`` are standard normal
and σ is 1.  One copy brings the whole tree to the host.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from rlbench.seeds import derive

# (path, flax leaf name, flax shape, kind, fan_in)
Leaf = Tuple[List[str], str, Tuple[int, ...], str, int]


def tree_spec(module: torch.nn.Module) -> List[Leaf]:
    """The flax leaves of ``module``'s parameters and spectral-norm state,
    in the port's naming (``convert.flax_trees``'s mapping)."""
    out: List[Leaf] = []
    for name, t in module.state_dict().items():
        *path, leaf = name.split(".")
        shape = tuple(t.shape)
        if leaf == "weight" and len(shape) == 4:          # OIHW → HWIO
            o, i, kh, kw = shape
            out.append((path, "kernel", (kh, kw, i, o), "normal",
                        kh * kw * i))
        elif leaf == "weight" and len(shape) == 5:        # OIDHW → DHWIO
            o, i, kd, kh, kw = shape
            out.append((path, "kernel", (kd, kh, kw, i, o), "normal",
                        kd * kh * kw * i))
        elif leaf == "weight" and len(shape) == 2:        # (out, in) → (in, out)
            out.append((path, "kernel", (shape[1], shape[0]), "normal",
                        shape[1]))
        elif leaf == "weight":
            out.append((path, "scale", shape, "one", 0))
        elif leaf == "bias":
            out.append((path, "bias", shape, "zero", 0))
        elif leaf == "embedding":
            out.append((path, "embedding", shape, "uniform", 0))
        elif leaf == "sn_u":
            out.append((path + ["sn"], "conv/kernel/u", shape, "normal", 1))
        elif leaf == "sn_sigma":
            out.append((path + ["sn"], "conv/kernel/sigma", shape, "one", 0))
        else:
            raise KeyError(f"no flax counterpart for {name}")
    return out


def _put(tree: dict, path: List[str], value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_trees(specs: Dict[str, List[Leaf]], seed: int, device
               ) -> Dict[str, Tuple[dict, dict]]:
    """``{name: (params, stats)}`` for each named spec, every leaf drawn
    on ``device`` from the stream ``(seed, "weights")``."""
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    leaves = [(name, leaf) for name, spec in specs.items() for leaf in spec]
    sizes = [math.prod(leaf[2]) for _, leaf in leaves]
    n_normal = sum(n for n, (_, leaf) in zip(sizes, leaves)
                   if leaf[3] == "normal")
    n_uniform = sum(n for n, (_, leaf) in zip(sizes, leaves)
                    if leaf[3] == "uniform")
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device)
    flat = torch.empty(sum(sizes), device=device)
    offs = {"normal": 0, "uniform": 0}
    pos = 0
    with torch.no_grad():
        for n, (_, (path, key, shape, kind, fan_in)) in zip(sizes, leaves):
            dst = flat[pos:pos + n]
            if kind in ("normal", "uniform"):
                src = normal if kind == "normal" else uniform
                dst.copy_(src[offs[kind]:offs[kind] + n])
                offs[kind] += n
                if key == "kernel":
                    dst.mul_(1.0 / math.sqrt(fan_in))
            else:
                dst.fill_(1.0 if kind == "one" else 0.0)
            pos += n
    host = flat.cpu().numpy()
    trees: Dict[str, Tuple[dict, dict]] = {}
    pos = 0
    for n, (name, (path, key, shape, _, _)) in zip(sizes, leaves):
        params, stats = trees.setdefault(name, ({}, {}))
        is_stat = path and path[-1] == "sn"
        _put(stats if is_stat else params, path + [key],
             host[pos:pos + n].reshape(shape))
        pos += n
    return trees


def motion_stats() -> Tuple[np.ndarray, np.ndarray]:
    """The motion transformer's normalization statistics (the
    configuration's ``assumed``): mean 0 and std 0.25 per joint
    coordinate."""
    return (np.zeros((19, 2), np.float32),
            np.full((19, 2), 0.25, np.float32))
