"""Metrics logging: console + JSONL (+ tensorboard when available).

A copy of the JAX package's ``renderloom/core/logging.py``: the primary
sink is an append-only ``metrics.jsonl`` (one ``{"step", "time",
"<prefix><name>": value, ...}`` record per call, the same lines the JAX
package writes), tensorboard is an optional extra, and
:func:`snapshot_source` zips the package's source into the run directory
for provenance.
"""

from __future__ import annotations

import json
import os
import time
import zipfile
from typing import Mapping


class MetricLogger:
    def __init__(self, out_dir: str, name: str = "metrics"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{name}.jsonl")
        self._tb = None
        try:  # tensorboard is optional
            from torch.utils.tensorboard import SummaryWriter  # type: ignore
            self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
        except ImportError:
            self._tb = None

    def log(self, step: int, scalars: Mapping[str, float], prefix: str = ""):
        record = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            key = f"{prefix}{k}"
            record[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), int(step))
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def console(self, step: int, scalars: Mapping[str, float],
                header: str = ""):
        parts = [f"{k}={float(v):.5f}" for k, v in scalars.items()]
        print(f"[{header}step {step}] " + " ".join(parts), flush=True)

    def log_images(self, step: int, images: Mapping[str, "object"],
                   prefix: str = ""):
        """Image summaries: (H, W, C) or (H, W) arrays in [0, 1] or
        [-1, 1], written as PNGs under ``<out>/images/`` and to
        tensorboard when available."""
        import numpy as np
        from PIL import Image

        img_dir = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(img_dir, exist_ok=True)
        for name, img in images.items():
            arr = np.asarray(img, dtype=np.float32)
            if arr.ndim == 2:
                arr = arr[..., None].repeat(3, axis=-1)
            if arr.min() < 0:
                arr = arr * 0.5 + 0.5
            arr8 = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            safe = name.replace("/", "_")
            Image.fromarray(arr8).save(os.path.join(
                img_dir, f"{safe}_{int(step):08d}.png"))
            if self._tb is not None:
                self._tb.add_image(f"{prefix}{name}",
                                   arr8.transpose(2, 0, 1), int(step))

    def close(self):
        if self._tb is not None:
            self._tb.close()
            self._tb = None


class NullLogger:
    """:class:`MetricLogger`'s interface, writing nothing: the logger of
    the ranks other than 0 of a data-parallel run."""

    def log(self, *args, **kwargs):
        pass

    console = log_images = close = log


def snapshot_source(out_dir: str, package_root: str) -> str:
    """Zip the package's ``.py`` files into ``<out_dir>/code.zip``, paths
    relative to the package's parent directory."""
    os.makedirs(out_dir, exist_ok=True)
    zpath = os.path.join(out_dir, "code.zip")
    with zipfile.ZipFile(zpath, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _, files in os.walk(package_root):
            for fname in files:
                if fname.endswith(".py"):
                    full = os.path.join(root, fname)
                    zf.write(full, os.path.relpath(
                        full, os.path.dirname(package_root)))
    return zpath
