"""AMASS 3D-joints h5 reading, host-side batching, and the motion
normalization statistics.

Port of the JAX package's ``renderloom/data/amass.py``.
:class:`AmassReader` reads the ``AMASS_3D_joints.h5`` layout the
reference builds (``Human_Motion_Modelling/AMASS/gen_amass_h5.py:60-74``:
groups ``<dataset>/<motion>/joints`` holding (T, 52, 3) SMPL-H joints)
and yields raw (B, 52, 3, L) windows with their pad masks; everything
downstream (rotation, projection, noise, masks) runs on the device in
the train step (:func:`renderloom_torch.ops.pose.synthesize_batch`).
``h5py`` is imported only when a reader opens a file.

The statistics (mean/std of the localized default-view projection, a
mean of per-motion statistics in float64, :func:`compute_stats`) are
cached beside the data with the reference's file names
(:func:`stats_paths`), so the reference's shipped
``mean_pose_network_perspective_4_4.npy`` files load directly.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from renderloom_torch.core.config import MotionDatasetConfig
from renderloom_torch.core.registry import DATASETS
from renderloom_torch.data.hsm import process_shard
from renderloom_torch.ops import pose as pose_ops


def random_window(rng: np.random.Generator, data: np.ndarray,
                  max_len: int, rate: int
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Temporal crop/pad of (J, D, T) → (J, D, max_len), its (max_len,)
    pad mask (True = padded) and the crop's start: a short clip is
    truncated to a rate-aligned length and zero-padded; a long one gets
    a random crop."""
    T = data.shape[2]
    if T < max_len:
        keep = ((T - 1) // rate) * rate + 1
        pad = max_len - keep
        out = np.pad(data[:, :, :keep], [(0, 0), (0, 0), (0, pad)])
        mask = np.zeros(max_len, dtype=bool)
        mask[keep:] = True
        return out, mask, 0
    start = int(rng.integers(0, T - max_len + 1))
    return (data[:, :, start:start + max_len],
            np.zeros(max_len, dtype=bool), start)


def center_window(data: np.ndarray, max_len: int, align: int = 16
                  ) -> Tuple[np.ndarray, int]:
    """The evaluation's crop: a long clip center-cropped to ``max_len``,
    a short one truncated to ``(T − 1) // align · align + 1`` frames."""
    T = data.shape[2]
    if T > max_len:
        start = (T - max_len) // 2
        return data[:, :, start:start + max_len], start
    keep = ((T - 1) // align) * align + 1
    return data[:, :, :keep], 0


@DATASETS.register("amass")
class AmassReader:
    """Sample index and raw window loading for the AMASS joints h5."""

    def __init__(self, h5_path: str, splits: Sequence[str]):
        import h5py

        self.h5_path = h5_path
        self.splits = tuple(splits)
        self.samples: List[Tuple[str, str]] = []
        with h5py.File(h5_path, "r") as f:
            for name in splits:
                if name not in f:
                    continue
                for motion in f[name]:
                    self.samples.append((name, motion))
        self._file = None

    def __len__(self) -> int:
        return len(self.samples)

    def _handle(self):
        # one handle per reader, opened on first read
        if self._file is None:
            import h5py
            self._file = h5py.File(self.h5_path, "r")
        return self._file

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def read_motion(self, dataset_key: str, motion_key: str) -> np.ndarray:
        """(T, J, D) on disk → (J, D, T) float32."""
        data = np.asarray(self._handle()[dataset_key][motion_key]["joints"])
        return np.ascontiguousarray(data.transpose(1, 2, 0),
                                    dtype=np.float32)

    def batches(self, rng: np.random.Generator, batch_size: int,
                max_len: int, rate: int, shuffle: bool = True,
                drop_last: bool = True, process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> Iterator[dict]:
        """Raw batches ``{"motion3d": (B, 52, 3, L), "pad_mask": (B, L)}``.
        Every process draws the same shuffled order (seeded ``rng``) and
        keeps its strided slice (:func:`~renderloom_torch.data.hsm.
        process_shard`); ``batch_size`` is per process."""
        order = np.arange(len(self.samples))
        if shuffle:
            rng.shuffle(order)
        order = order[process_shard(len(order), process_index,
                                    process_count)]
        motions, masks = [], []
        for idx in order:
            data = self.read_motion(*self.samples[idx])
            window, mask, _ = random_window(rng, data, max_len, rate)
            motions.append(window)
            masks.append(mask)
            if len(motions) == batch_size:
                yield {"motion3d": np.stack(motions),
                       "pad_mask": np.stack(masks)}
                motions, masks = [], []
        if motions and not drop_last:
            yield {"motion3d": np.stack(motions),
                   "pad_mask": np.stack(masks)}


def stats_paths(cfg: MotionDatasetConfig) -> Tuple[str, str]:
    """Reference-compatible cache filenames (AMASS_dataset.py:77-81)."""
    kind = "3D" if cfg.return_type == "3D" else "network"
    suffix = (f"{kind}_{cfg.camera_project}_"
              f"{cfg.focal:.0f}_{cfg.depth:.0f}.npy")
    root = cfg.data_root
    return (os.path.join(root, f"mean_pose_{suffix}"),
            os.path.join(root, f"std_pose_{suffix}"))


def compute_stats(reader, cfg: MotionDatasetConfig,
                  limit: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and std of the localized default-view projection, a mean of
    per-motion statistics (the reference's, not one global pass): each
    motion is projected in float32, its mean and std over time taken in
    float64 and averaged over motions; a zero std becomes 1e-9."""
    mean_acc = 0.0
    std_acc = 0.0
    samples = reader.samples[:limit] if limit else reader.samples
    for dataset_key, motion_key in samples:
        motion = torch.from_numpy(reader.read_motion(dataset_key,
                                                     motion_key))
        data3d = pose_ops.rotate_motion_3d(pose_ops.centralize(motion))
        if cfg.return_type == "3D":
            local = pose_ops.localize(data3d, pose_ops.ROOT_3D)
        else:
            p2d = pose_ops.project_2d(data3d, cfg.focal, cfg.depth,
                                      cfg.frame_boarder, cfg.camera_project)
            local = pose_ops.localize(pose_ops.joints_to_openpose(p2d),
                                      pose_ops.ROOT_2D)
        local = local.numpy().astype(np.float64)
        mean_acc = mean_acc + local.mean(axis=2)
        std_acc = std_acc + local.std(axis=2)
    n = len(samples)
    if n == 0:
        raise ValueError(
            "AMASS reader matched no motions — check that the h5's "
            "top-level groups intersect the configured split "
            f"(reader splits: {reader.splits})")
    mean = mean_acc / n
    std = std_acc / n
    std[std == 0] = 1e-9
    return mean.astype(np.float32), std.astype(np.float32)


def load_or_compute_stats(reader, cfg: MotionDatasetConfig,
                          limit: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, std) float32 from the cached files of :func:`stats_paths`;
    without them, computed from ``reader`` (:func:`compute_stats`) and
    cached there.  Neither files nor reader: ``FileNotFoundError``."""
    mean_path, std_path = stats_paths(cfg)
    if os.path.exists(mean_path) and os.path.exists(std_path):
        return (np.load(mean_path).astype(np.float32),
                np.load(std_path).astype(np.float32))
    if reader is None:
        raise FileNotFoundError(
            f"no cached stats at {mean_path} and no dataset to compute "
            "them from")
    mean, std = compute_stats(reader, cfg, limit)
    os.makedirs(cfg.data_root, exist_ok=True)
    np.save(mean_path, mean)
    np.save(std_path, std)
    return mean, std
