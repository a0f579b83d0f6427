"""HumanSloMo h5 reading, and frame preparation for serving and
training: [-1, 1] images and backgrounds, the 22-channel pose label, the
human mask, and the zero frame-0 background.

Host side, :class:`HsmReader` (port of the JAX package's ``HsmReader``)
reads the reference's ``HumanSlomo.h5`` layout — per-clip groups with
variable-length PNG/JPEG byte datasets ``train_images``/``train_dain``/
``train_poses`` and ``gt_*``
(``HumanSloMo_Dataset/lib/gen_dataset_h5.py:57-174``) — and decodes the
bytes to uint8 numpy arrays (:func:`decode_images`, the port's C++
decoder in :mod:`renderloom_torch.native`).  ``h5py`` is imported only
when a reader opens a file.

Device side, port of the JAX package's ``prepare_batch`` on
its fused-raster route: all B·F frames are rasterized in one call of
the label kernel (:mod:`renderloom_torch.ops.rasterize_kernel`), which
writes the NHWC label directly.  The deterministic branch serves; the
train branch (:func:`window_affine`, ``prepare_batch(..., draws)``, the
ports of ``_window_affine`` and ``prepare_batch(train=True)``) warps
each window by a random shift/scale/rotate, rasterizes with train-mode
tables and masks, and pastes the gaussian-blurred background under the
part mask.  Its randomness is drawn by
:func:`draw_train_randomness` from an explicit ``torch.Generator`` and
passed in, so the draws (small) can be made once on the CPU and shared
by every device.
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from renderloom_torch.core.config import RendererDataConfig
from renderloom_torch.ops.image import (affine_warp, compose_affine,
                                        gaussian_blur, resize_matrix,
                                        separable_resize,
                                        shift_scale_rotate_matrix,
                                        transform_keypoints)
from renderloom_torch.ops.rasterize_kernel import (draw_train_tables,
                                                   rasterize_frames_fused)
# re-exported: data/amass.py and the tests import it from here
from renderloom_torch.parallel.mesh import process_shard  # noqa: F401


def decode_image(buf: np.ndarray) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(buf.tobytes())).convert("RGB"))


def decode_images(bufs: Sequence[np.ndarray]) -> np.ndarray:
    """Decode same-sized PNG/JPEG byte buffers to (n, H, W, 3) uint8 with
    the multithreaded C++ decoder (PIL where it cannot build)."""
    from renderloom_torch import native
    w, h = native.image_dims(bufs[0].tobytes())
    return native.batch_decode(bufs, h, w)


class HsmReader:
    """Window sampler over the HumanSloMo h5 (train or test phase)."""

    def __init__(self, h5_path: str, video_list: Sequence[str],
                 phase: str = "train", max_frames: int = 4):
        import h5py

        self.h5_path = h5_path
        self.phase = phase
        self.max_frames = max_frames
        self.video_list = list(video_list)
        img_key = "train_images" if phase == "train" else "gt_images"
        self.n_frames: Dict[str, int] = {}
        self.samples: List[Tuple[str, int]] = []
        with h5py.File(h5_path, "r") as f:
            for vid in self.video_list:
                if vid not in f:
                    continue
                n = len(f[vid][img_key])
                self.n_frames[vid] = n
                # safe sliding windows (the reference over-runs by 2:
                # HSM_auto_dataset.py:94 — a latent bug, not reproduced)
                for start in range(max(n - max_frames + 1, 0)):
                    self.samples.append((vid, start))
        self._file = None

    def __len__(self):
        return len(self.samples)

    def set_max_frames(self, max_frames: int):
        """Curriculum: regrow windows at a new length (the reference's
        ``update_max_frame``, HSM_auto_dataset.py:339-358, minus its
        ``videl_list``/``train_fake`` typos)."""
        self.__init__(self.h5_path, self.video_list, self.phase,
                      max_frames)

    def close(self):
        """Close the h5 handle that reads opened (reopened on demand)."""
        if self._file is not None:
            self._file.close()
            self._file = None

    def _handle(self):
        if self._file is None:
            import h5py
            self._file = h5py.File(self.h5_path, "r")
        return self._file

    def read_window(self, vid: str, start: int) -> Dict[str, np.ndarray]:
        """Decode one window: images (F,H0,W0,3) u8, dain (F,H0,W0,3) u8
        (entry i = DAIN frame start+i−1; entry for frame 0 of the clip is
        zeros, HSM_auto_dataset.py:148-149,190-203), poses (F,19,3)."""
        grp = self._handle()[vid]
        key_img = "train_images" if self.phase == "train" else "gt_images"
        key_dain = "train_dain" if self.phase == "train" else "gt_dain"
        key_pose = "train_poses" if self.phase == "train" else "gt_poses"
        idxs = list(range(start, start + self.max_frames))
        bufs = [np.asarray(grp[key_img][i]) for i in idxs]
        dain_idxs = [i - 1 for i in idxs if i > 0]
        bufs += [np.asarray(grp[key_dain][i]) for i in dain_idxs]
        decoded = decode_images(bufs)  # one parallel native decode
        imgs = decoded[:len(idxs)]
        dain_decoded = decoded[len(idxs):]
        dains = np.zeros_like(imgs)
        dains[len(idxs) - len(dain_idxs):] = dain_decoded
        poses = np.asarray(grp[key_pose][start:start + self.max_frames],
                           dtype=np.float32)
        return {"images": imgs, "dain": dains, "poses": poses}

    def read_test_frame(self, vid: str, index: int) -> Dict[str, np.ndarray]:
        """Eval fetch (HSM_auto_dataset.py:361-399): gt image, same-index
        gt DAIN frame, pose row."""
        grp = self._handle()[vid]
        return {
            "image": decode_image(np.asarray(grp["gt_images"][index])),
            "dain": decode_image(np.asarray(grp["gt_dain"][index])),
            "pose": np.asarray(grp["gt_poses"][index], dtype=np.float32),
        }

    def batches(self, rng: np.random.Generator, batch_size: int,
                shuffle: bool = True, drop_last: bool = True,
                process_index: Optional[int] = None,
                process_count: Optional[int] = None):
        """Batches of :meth:`read_window` windows, stacked.  Every process
        draws the same shuffled order (seeded ``rng``) and keeps its
        strided slice (:func:`process_shard`), so processes read disjoint
        windows; ``batch_size`` is per process."""
        order = np.arange(len(self.samples))
        if shuffle:
            rng.shuffle(order)
        order = order[process_shard(len(order), process_index,
                                    process_count)]
        buf = []
        for idx in order:
            buf.append(self.read_window(*self.samples[idx]))
            if len(buf) == batch_size:
                yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
                buf = []
        if buf and not drop_last:
            yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    return x.float() / 127.5 - 1.0


def draw_train_randomness(generator: torch.Generator, B: int, F: int,
                          cfg: RendererDataConfig) -> Dict[str, torch.Tensor]:
    """Every random value of one train-mode preparation of B windows of
    F frames: per window a shift in [−0.0625, 0.0625), a rotation in
    [−10°, 10°) and a scale in [−0.1, 0.1) (the reference's
    ShiftScaleRotate ranges, ``_window_affine``), and the rasterizer's
    per-frame draws (:func:`draw_train_tables`, B·F frames)."""
    dev = generator.device
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(B, generator=generator,
                                                   device=dev)
    draws = {"shift": u(-0.0625, 0.0625), "angle": u(-10.0, 10.0),
             "scale": u(-0.1, 0.1)}
    draws.update(draw_train_tables(generator, B * F, cfg.gauss_sigma,
                                   cfg.random_drop_prob,
                                   cfg.random_blur_rate))
    return draws


def window_affine(draws: Dict[str, torch.Tensor], src_h: int, src_w: int,
                  cfg: RendererDataConfig) -> torch.Tensor:
    """(B, 2, 3) per-window transform: resize to load size, then the
    drawn shift (the same along x and y), scale and rotation."""
    resize = resize_matrix(src_h, src_w, cfg.load_height, cfg.load_width,
                           device=draws["shift"].device)
    ssr = shift_scale_rotate_matrix(cfg.load_height, cfg.load_width,
                                    draws["shift"], draws["shift"],
                                    draws["scale"], draws["angle"])
    return compose_affine(ssr, resize.expand(ssr.shape))


def _label_layout(ras, B, F, H, W, packed_label):
    if packed_label:
        return ras["label"].reshape(B, F, H // 2, W // 2, 88)
    return ras["label"].reshape(B, F, H, W, 22)


def prepare_batch(batch: Dict[str, torch.Tensor], cfg: RendererDataConfig,
                  draws: Optional[Dict[str, torch.Tensor]] = None,
                  label_dtype: Optional[torch.dtype] = None,
                  packed_label: bool = False,
                  want_masks: bool = True) -> Dict[str, torch.Tensor]:
    """``batch``: images/dain (B, F, H0, W0, 3) in [0, 255] (dain already
    shifted to t−1 per frame), poses (B, F, 19, 3) xy + conf in source
    pixels.  Returns label (B, F, H, W, 22) float32, image/back
    (B, F, H, W, 3) in [-1, 1] and the human mask ``fg_mask``
    (B, F, H, W, 1) float32 0/1.

    ``draws`` (:func:`draw_train_randomness`, on the batch's device)
    selects the train branch.  ``want_masks=False`` (serving, the
    deterministic branch only) drops ``fg_mask``, and the kernel then
    skips the mask capsules (the JAX ``want_masks``).  ``label_dtype`` (default float32) is the label
    stream's type, which the kernel casts to at the store (bf16 halves
    the label's bytes); ``packed_label`` emits it parity-packed,
    (B, F, H/2, W/2, 88) = space_to_depth of each frame's label, which
    the parity-layout generator (``models/fastpath.py``) takes as it is
    (the JAX ``prepare_batch``'s ``label_dtype``/``packed_label``)."""
    layout = dict(out_dtype=label_dtype or torch.float32,
                  layout="packed" if packed_label else "nhwc")
    if draws is not None:
        return _prepare_train(batch, cfg, draws, layout, packed_label)
    images, dain, poses = batch["images"], batch["dain"], batch["poses"]
    B, F = images.shape[:2]
    H, W = cfg.model_height, cfg.model_width
    if (images.shape[2:4] == (H, W) and cfg.load_height == H
            and cfg.load_width == W):
        # the window affine is the identity: no resample at all
        images_t, dain_t = _to_unit(images), _to_unit(dain)
        coords = poses[..., :2].float()
    else:
        # a pure resize to load size, cropped to model size
        src_h, src_w = images.shape[2:4]
        res = lambda x: separable_resize(_to_unit(x), cfg.load_height,
                                         cfg.load_width, H, W)
        images_t, dain_t = res(images), res(dain)
        scale = torch.tensor([np.float32(cfg.load_width / src_w),
                              np.float32(cfg.load_height / src_h)],
                             device=poses.device)
        coords = poses[..., :2].float() * scale
    conf = poses[..., 2]

    ras = rasterize_frames_fused(
        coords.reshape(B * F, -1, 2), conf.reshape(B * F, -1), H, W,
        gauss_sigma=cfg.gauss_sigma, thres=cfg.skeleton_thres,
        foot_thres=cfg.foot_thres, emit_masks=want_masks, **layout)
    out = {"label": _label_layout(ras, B, F, H, W, packed_label),
           "image": images_t, "back": _zero_first_back(dain_t, dain)}
    if want_masks:
        out["fg_mask"] = ras["mask"].reshape(B, F, H, W, 1)
    return out


def _zero_first_back(back: torch.Tensor, dain: torch.Tensor) -> torch.Tensor:
    """Zero the frame-0 background of a window whose host shipped a zero
    dain frame."""
    zero0 = (dain[:, 0] == 0).flatten(1).all(dim=1)
    first = torch.where(zero0[:, None, None, None], 0.0, back[:, 0])
    return torch.cat([first[:, None], back[:, 1:]], dim=1)


def _prepare_train(batch, cfg: RendererDataConfig, draws, layout,
                   packed_label):
    images, dain, poses = batch["images"], batch["dain"], batch["poses"]
    B, F, src_h, src_w = images.shape[:4]
    H, W = cfg.model_height, cfg.model_width
    m = window_affine(draws, src_h, src_w, cfg)                 # (B, 2, 3)
    m_frames = m[:, None].expand(B, F, 2, 3).reshape(B * F, 2, 3)
    warp = lambda x: affine_warp(
        _to_unit(x).reshape(B * F, src_h, src_w, -1), m_frames, H,
        W).reshape(B, F, H, W, -1)
    images_t, dain_t = warp(images), warp(dain)
    coords = transform_keypoints(poses[..., :2].float(), m[:, None])
    conf = poses[..., 2]
    tables = {k: draws[k] for k in ("sigma", "keep_j", "keep_e", "part")}
    ras = rasterize_frames_fused(
        coords.reshape(B * F, -1, 2), conf.reshape(B * F, -1), H, W,
        gauss_sigma=cfg.gauss_sigma, thres=cfg.skeleton_thres,
        foot_thres=cfg.foot_thres, emit_masks=True, draws=tables, **layout)
    part = ras["part_mask"].reshape(B, F, H, W, 1)
    back = gaussian_blur(dain_t, 10.0) * part + dain_t * (1.0 - part)
    return {"label": _label_layout(ras, B, F, H, W, packed_label),
            "image": images_t, "back": _zero_first_back(back, dain),
            "fg_mask": ras["mask"].reshape(B, F, H, W, 1)}
