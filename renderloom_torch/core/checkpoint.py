"""Trained weights for the serving CLIs, as numpy flax trees.

Two formats are read:

* the port's own ``torch.save`` files: the renderer checkpoint that
  ``renderloom_torch.cli.train_renderer`` writes (its ``"gen"`` entry, the
  training generator's state dict with its spectral-norm state), the
  motion checkpoint that ``renderloom_torch.cli.train_motion`` writes
  (its ``"model"`` entry), and a motion model's ``state_dict``;
* an ``.npz`` of flattened flax trees, for weights trained with the JAX
  package: keys ``params/<path>`` and, for the renderer,
  ``batch_stats/<path>`` (:func:`write_npz` writes one, and
  ``write_npz(path, state.params_g, state.stats_g)`` on the JAX
  package's ``jax.device_get`` state writes the same file there).

Both come out as flax trees, which ``build_pipeline``,
``make_inference_pair`` and the evaluators take.  This module, not
``convert.py``, owns the file formats: ``convert.py`` maps trees to
modules and knows no files.  An orbax checkpoint (a directory) cannot be
read without JAX; the readers say so.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from renderloom_torch.convert import flax_trees

ORBAX_HELP = ("an orbax checkpoint directory cannot be read without JAX: "
              "restore it with the JAX package and save it with "
              "renderloom_torch.core.checkpoint.write_npz(path, params, "
              "batch_stats) as an .npz of flax trees")


def _flatten(tree: Mapping, prefix: str, out: dict):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[prefix + k] = np.asarray(v)


def write_npz(path: str, params: Mapping,
              batch_stats: Optional[Mapping] = None) -> None:
    """Save flax trees as the ``.npz`` that :func:`read_renderer` and
    :func:`read_motion` read."""
    flat = {}
    _flatten(params, "params/", flat)
    _flatten(batch_stats or {}, "batch_stats/", flat)
    np.savez(path, **flat)


def _unflatten(flat: Mapping[str, np.ndarray], root: str) -> dict:
    """The tree under ``root`` of a flattened ``.npz``.  A spectral-norm
    leaf of ``batch_stats`` is one key holding slashes (``sn`` →
    ``conv/kernel/u``), so everything after an ``sn`` level is one key."""
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] != root:
            continue
        parts = parts[1:]
        if "sn" in parts:
            i = parts.index("sn") + 1
            parts = parts[:i] + ["/".join(parts[i:])]
        node = tree
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = np.asarray(value)
    return tree


def _read(path: str):
    """The npz mapping or the ``torch.save`` object at ``path``."""
    if os.path.isdir(path):
        raise ValueError(f"{path}: {ORBAX_HELP}")
    if path.endswith(".npz"):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    return torch.load(path, map_location="cpu", weights_only=True)


def read_renderer(path: str) -> Tuple[dict, dict]:
    """(params_g, stats_g) of the renderer's generator at ``path``: an
    ``.npz`` of flax trees, or a ``train_renderer`` checkpoint."""
    ckpt = _read(path)
    if path.endswith(".npz"):
        return _unflatten(ckpt, "params"), _unflatten(ckpt, "batch_stats")
    if "gen" not in ckpt:
        raise ValueError(f"{path}: no 'gen' entry; not a renderer "
                         "checkpoint of renderloom_torch.cli.train_renderer")
    return flax_trees(ckpt["gen"])


def read_motion(path: str) -> dict:
    """The motion transformer's params at ``path``: an ``.npz`` of flax
    trees, a ``train_motion`` checkpoint (its ``"model"`` entry), or a
    ``torch.save`` of the model's ``state_dict``."""
    ckpt = _read(path)
    if path.endswith(".npz"):
        return _unflatten(ckpt, "params")
    params, _ = flax_trees(ckpt.get("model", ckpt))
    return params
