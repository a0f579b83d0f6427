"""Motion normalization statistics from their cached files.

Port of the cached-file part of the JAX package's
``renderloom/data/amass.py``: :func:`stats_paths` names the mean/std
``.npy`` files with the reference's names
(``AMASS_dataset.py:77-81``), so the reference's shipped
``mean_pose_network_perspective_4_4.npy`` files load directly, and
:func:`load_or_compute_stats` reads them.  Computing the statistics
from the AMASS h5 needs its reader, which comes with motion training.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from renderloom_torch.core.config import MotionDatasetConfig


def stats_paths(cfg: MotionDatasetConfig) -> Tuple[str, str]:
    """Reference-compatible cache filenames (AMASS_dataset.py:77-81)."""
    kind = "3D" if cfg.return_type == "3D" else "network"
    suffix = (f"{kind}_{cfg.camera_project}_"
              f"{cfg.focal:.0f}_{cfg.depth:.0f}.npy")
    root = cfg.data_root
    return (os.path.join(root, f"mean_pose_{suffix}"),
            os.path.join(root, f"std_pose_{suffix}"))


def load_or_compute_stats(reader, cfg: MotionDatasetConfig
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, std) float32 from the cached files of :func:`stats_paths`.
    Without them, ``reader=None`` raises ``FileNotFoundError`` as in
    JAX; computing them from an AMASS reader is not ported yet."""
    mean_path, std_path = stats_paths(cfg)
    if os.path.exists(mean_path) and os.path.exists(std_path):
        return (np.load(mean_path).astype(np.float32),
                np.load(std_path).astype(np.float32))
    if reader is None:
        raise FileNotFoundError(
            f"no cached stats at {mean_path} and no dataset to compute "
            "them from")
    raise NotImplementedError(
        "computing the motion statistics from an AMASS reader waits for "
        "the port's motion training (ROADMAP Queue 1 item 6)")
