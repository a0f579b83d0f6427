"""Motion-model evaluation: MSE/MAE/MAX against the ground truth, beside
the linear-interpolation baseline.

Port of the JAX package's ``renderloom/eval/motion_eval.py`` (the
reference's ``Human_Motion_Modelling/models/evaluator.py``): fixed
per-sample random viewpoints cached to ``evaluation_view.npy``, test
clips center-cropped or truncated, keyframe corruption at evaluation when
``evaluate_noise``, and the metrics on globalized joints with the linear
baseline alongside.  Samples are padded to ``max_seq_length`` and
synthesized and inferred a batch at a time on the model's device (masks
and per-sample lengths keep the math of each valid prefix).

The corruption's draws for sample i come from a CPU generator seeded i
(:meth:`MotionEvaluator.drop_draws`), where the JAX package folds i into
``PRNGKey(0)``; the tests replace that method with the JAX draws.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from renderloom_torch.core.config import MotionConfig
from renderloom_torch.data.amass import center_window
from renderloom_torch.ops import pose as pose_ops


def load_or_create_views(path: str, rotation_axes, n: int = 1000,
                         rng: Optional[np.random.Generator] = None
                         ) -> np.ndarray:
    """The ``n`` cached random viewpoints at ``path``, drawn uniformly in
    ±π·``rotation_axes`` (from ``default_rng(0)`` unless given) and saved
    there when the file is missing."""
    if os.path.exists(path):
        return np.load(path)
    rng = rng or np.random.default_rng(0)
    axes = np.asarray(rotation_axes) * np.pi
    views = rng.uniform(-axes, axes, (n, 3))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, views)
    return views


def relocate(motion: np.ndarray, root_idx: int) -> np.ndarray:
    """Move the root joint of frame 0 to the origin."""
    center = motion[root_idx, :, 0]
    return motion - center[None, :, None]


def global_metrics(gt: np.ndarray, pred: np.ndarray,
                   interp: np.ndarray, root_idx: int = 8) -> Dict:
    """One sample's sums for the MSE/MAE/MAX accumulation."""
    gt_g = relocate(gt, root_idx)
    pred_g = relocate(pred, root_idx)
    interp_g = relocate(interp, root_idx)
    return {
        "count": gt_g.size,
        "mse": float(np.sum((gt_g - pred_g) ** 2)),
        "mae": float(np.sum(np.abs(gt_g - pred_g))),
        "max": float(np.max(np.abs(gt_g - pred_g))),
        "mse_interp": float(np.sum((gt_g - interp_g) ** 2)),
        "mae_interp": float(np.sum(np.abs(gt_g - interp_g))),
        "max_interp": float(np.max(np.abs(gt_g - interp_g))),
    }


class MotionEvaluator:
    """Batched evaluation over the AMASS test split of ``reader``
    (anything with ``samples`` and ``read_motion``)."""

    def __init__(self, cfg: MotionConfig, reader, mean: np.ndarray,
                 std: np.ndarray,
                 views_path: str = "data/evaluation_view.npy"):
        self.cfg = cfg
        self.reader = reader
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.views = load_or_create_views(views_path,
                                          cfg.dataset.rotation_axes)
        self.rate = cfg.dataset.test_sample_rate
        self.max_len = cfg.dataset.max_seq_length
        self.root = (pose_ops.ROOT_3D if cfg.dataset.return_type == "3D"
                     else pose_ops.ROOT_2D)

    def drop_draws(self, i: int, J: int, D: int, L: int
                   ) -> Dict[str, torch.Tensor]:
        """Sample i's keyframe-corruption draws (batch axis of 1)."""
        return pose_ops.draw_random_drop(torch.Generator().manual_seed(i),
                                         1, J, D, L, self.rate)

    def _prepare(self, motion3d, pad_mask, view, draws, mean, std):
        """Project padded clips (B, 52, 3, L) at their fixed views and
        synthesize the evaluation inputs: no projection jitter, keyframe
        corruption iff ``evaluate_noise``, inputs zero off the
        keyframes, the linear prior of the corrupted sequence."""
        d = self.cfg.dataset
        data3d = pose_ops.rotate_motion_3d(pose_ops.centralize(motion3d),
                                           view)
        if d.return_type == "3D":
            gt = data3d
        else:
            gt = pose_ops.joints_to_openpose(pose_ops.project_2d(
                data3d, d.focal, d.depth, d.frame_boarder, d.camera_project))
        noised = gt
        if d.evaluate_noise:
            noised = pose_ops.random_drop(gt, self.rate, draws,
                                          d.noise_weight, d.noise_rate,
                                          d.joint_drop_rate, d.flip_rate)
        normed = pose_ops.normalize(pose_ops.localize(noised, self.root),
                                    mean, std)
        enc_mask = pose_ops.encoder_mask_from_pad(pad_mask, self.rate)
        interp = pose_ops.keyframe_interpolate(normed, self.rate)
        inputs = normed * (~enc_mask)[:, None, None, :]
        B, J, D = normed.shape[:3]
        return {"gt": gt, "input": inputs.reshape(B, J * D, -1),
                "interp": interp.reshape(B, J * D, -1),
                "src_mask": enc_mask, "mask": pad_mask}

    def _postprocess(self, flat: np.ndarray, length: int) -> np.ndarray:
        """(C, L) normalized → (J, D, T) denormalized global joints: the
        denormalization in float64, the globalization in float32 (as the
        JAX package's, whose arrays are float32)."""
        J, D = self.mean.shape
        data = np.asarray(flat, dtype=np.float64).reshape(J, D, -1)
        data = data[:, :, :length] * self.std[:, :, None] \
            + self.mean[:, :, None]
        return pose_ops.globalize(torch.from_numpy(data.astype(np.float32)),
                                  self.root).numpy()

    @torch.no_grad()
    def evaluate(self, model, limit: Optional[int] = None,
                 batch_size: int = 8,
                 dump_h5: Optional[str] = None) -> Dict[str, float]:
        """The full test protocol on ``model`` (on its device): mse, mae
        and max of the model and of the linear baseline.  ``dump_h5``
        writes each sample's ``<dataset>/<motion>/{pred,gt,interp}``
        global joints."""
        device = next(model.parameters()).device
        mean, std = (torch.from_numpy(x).to(device)
                     for x in (self.mean, self.std))
        samples = self.reader.samples[:limit] if limit \
            else self.reader.samples
        h5_out = None
        if dump_h5:
            import h5py
            os.makedirs(os.path.dirname(dump_h5) or ".", exist_ok=True)
            h5_out = h5py.File(dump_h5, "w")

        totals = {"count": 0, "mse": 0.0, "mae": 0.0, "max": 0.0,
                  "mse_interp": 0.0, "mae_interp": 0.0, "max_interp": 0.0}
        n_samples = 0
        J, D = self.mean.shape
        try:
            buf = []
            for i, (dkey, mkey) in enumerate(samples):
                motion = self.reader.read_motion(dkey, mkey)
                window, _ = center_window(motion, self.max_len, 16)
                T = window.shape[2]
                padded = np.zeros((52, 3, self.max_len), dtype=np.float32)
                padded[:, :, :T] = window
                buf.append((padded, np.arange(self.max_len) >= T,
                            self.views[i % len(self.views)],
                            self.drop_draws(i, J, D, self.max_len), T,
                            dkey, mkey))
                if len(buf) < batch_size and i < len(samples) - 1:
                    continue
                on = lambda k: torch.from_numpy(np.stack(
                    [b[k] for b in buf])).to(device)
                draws = {k: torch.cat([b[3][k] for b in buf])
                         for k in buf[0][3]}
                st = self._prepare(on(0), on(1), on(2).float(), draws,
                                   mean, std)
                lengths = torch.tensor([b[4] for b in buf], device=device)
                pred, _ = model(st["input"].transpose(1, 2), st["src_mask"],
                                st["interp"].transpose(1, 2), st["mask"],
                                self.rate, lengths=lengths)
                preds = pred.transpose(1, 2).cpu().numpy()
                gts = st["gt"].cpu().numpy()
                interps = st["interp"].cpu().numpy()
                for j, (_, _, _, _, length, dk, mk) in enumerate(buf):
                    gt = gts[j][:, :, :length]
                    pred_j = self._postprocess(preds[j], length)
                    interp = self._postprocess(interps[j], length)
                    if h5_out is not None:
                        grp = h5_out.create_group(f"{dk}/{mk}")
                        grp.create_dataset("pred", data=pred_j)
                        grp.create_dataset("gt", data=gt)
                        grp.create_dataset("interp", data=interp)
                    m = global_metrics(gt, pred_j, interp, self.root)
                    for k in totals:
                        totals[k] += m[k]
                    n_samples += 1
                buf = []
        finally:
            if h5_out is not None:
                h5_out.close()
        cnt = max(totals["count"], 1)
        n = max(n_samples, 1)
        return {
            "mse_global": totals["mse"] / cnt,
            "mae_global": totals["mae"] / cnt,
            "max_global": totals["max"] / n,
            "mse_interp": totals["mse_interp"] / cnt,
            "mae_interp": totals["mae_interp"] / cnt,
            "max_interp": totals["max_interp"] / n,
        }
