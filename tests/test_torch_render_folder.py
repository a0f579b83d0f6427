"""The PyTorch port's ``render_folder`` and its array core
``render_frames`` (``renderloom_torch/eval/render_eval.py``) against the
JAX package's ``render_folder`` on the same folder triple (keyframe
PNGs, per-frame DAIN PNGs, openpose JSONs in pixels) at 64×96, tiny
widths and the same generator weights: 4 keyframes at rate 2 (one
chunk), and 34 keyframes at rate 2 (33 segments: a chunk of 32 and one
of 1; JAX pads the second to 32 segments, the port does not).

Tolerance: the written PNGs within 1 level (the float32 frames differ
by ~1e-5 and are truncated to uint8, so a value near a level boundary
can land on either side; the share of values not equal reads 0.0054%
or less and is held under 0.05%); the keyframes pass through within 1 level
(mapped to [-1, 1] and back, then truncated, in JAX as here).
"""

import os
import types

import numpy as np
import pytest
import torch
from PIL import Image

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import (blobs, generator_trees,  # noqa: F401
                           renderer_cfg, single_thread)
from renderloom.eval import render_eval as JE
from renderloom_torch.data.openpose import (read_openpose_dir,
                                            write_openpose_dir)
from renderloom_torch.eval import render_eval as TE
from renderloom_torch.train.gan import make_inference_pair

H, W = 64, 96


def _clip(root, K, rate, seed):
    """inputs/, DAIN/ and Predict_motion/ for K keyframes at ``rate``."""
    L = (K - 1) * rate + 1
    rng = np.random.default_rng(seed)
    frames = (blobs(L, H, W, seed=seed) * 255).astype(np.uint8)
    dirs = {k: os.path.join(root, k) for k in ("inputs", "DAIN",
                                               "Predict_motion")}
    for d in dirs.values():
        os.makedirs(d)
    for i in range(K):
        Image.fromarray(frames[i * rate]).save(
            os.path.join(dirs["inputs"], f"{i:03d}.png"))
    for i in range(L):
        noisy = np.clip(frames[i] + rng.integers(-20, 20, frames[i].shape),
                        0, 255).astype(np.uint8)
        Image.fromarray(noisy).save(os.path.join(dirs["DAIN"],
                                                 f"{i:05d}.png"))
    motion = np.stack([rng.uniform(10, W - 10, (19, L)),
                       rng.uniform(8, H - 8, (19, L))], axis=1)
    write_openpose_dir(motion, rng.uniform(0.5, 1.0, (19, 1, L)),
                       dirs["Predict_motion"], scale=1.0, offset=0.0)
    return dirs, frames[::rate]


def _pngs(path):
    return np.stack([np.asarray(Image.open(os.path.join(path, f)))
                     for f in sorted(os.listdir(path))])


@pytest.fixture(scope="module")
def trees():
    return generator_trees(renderer_cfg(JC, H, W), H, W, seed=5)


@pytest.mark.parametrize("K", [4, 34])
def test_render_folder_matches_jax(tmp_path, trees, K):
    dirs, keys = _clip(str(tmp_path), K, 2, seed=K)
    args = (dirs["inputs"], dirs["DAIN"], dirs["Predict_motion"])
    n = TE.render_folder(*trees, renderer_cfg(TC, H, W), *args,
                         str(tmp_path / "port"), device="cpu")
    m = JE.render_folder(None, types.SimpleNamespace(params_g=trees[0],
                                                     stats_g=trees[1]),
                         renderer_cfg(JC, H, W), *args,
                         str(tmp_path / "jax"))
    assert n == m == (K - 1) * 2 + 1
    got, want = _pngs(tmp_path / "port"), _pngs(tmp_path / "jax")
    assert got.shape == want.shape == (n, H, W, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    share = (diff > 0).mean()
    print(f"K={K}: max |port - JAX| {diff.max()} levels, "
          f"{100 * share:.4f}% of values not equal")
    assert diff.max() <= 1 and share < 5e-4
    # keyframes go to [-1, 1] and back, truncated: within 1 level
    assert np.abs(got[::2].astype(int) - keys).max() <= 1


def test_render_frames_is_render_folders_core(tmp_path, trees):
    """The array core yields the frames ``render_folder`` writes."""
    dirs, keys = _clip(str(tmp_path), 4, 2, seed=1)
    cfg = renderer_cfg(TC, H, W)
    TE.render_folder(*trees, cfg, dirs["inputs"], dirs["DAIN"],
                     dirs["Predict_motion"], str(tmp_path / "out"),
                     device="cpu")
    motion, conf, _ = read_openpose_dir(dirs["Predict_motion"], 1.0, 0.0)
    poses = np.concatenate([motion, conf], axis=1).transpose(2, 0, 1)
    gen = make_inference_pair(cfg, *trees, torch.device("cpu"))
    parts = list(TE.render_frames(gen, cfg, keys, _pngs(dirs["DAIN"]),
                                  poses, 2, "cpu"))
    assert [start for start, _ in parts] == [0]
    np.testing.assert_array_equal(parts[0][1], _pngs(tmp_path / "out"))
