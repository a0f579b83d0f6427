"""Dataset production: downloads, clip extraction, h5 packing.

Port of the JAX package's ``renderloom/data/builders.py``, the rebuild of
the ``HumanSloMo_Dataset`` stage with the reference's on-disk formats:

* :func:`emit_download_script` — diff ``video.csv`` against the mp4s
  present and write youtube-dl commands (``lib/download.py:6-52``);
* :func:`extract_clips` — pull the listed frames out of the videos,
  keep columns 100–1180, resize to 768×512 (``lib/gen_dataset.py:
  12-48``);
* :func:`pack_hsm_h5` — folder tree → ``HumanSlomo.h5``: vlen-uint8 PNG
  bytes and float64 (F, 19, 3) poses parsed from openpose JSONs
  (``lib/gen_dataset_h5.py:57-174``), which ``data/hsm.py:HsmReader``
  reads;
* :func:`pack_amass_h5` — SMPL-H joints through the external
  ``human_body_prior`` BodyModel (``Human_Motion_Modelling/AMASS/
  gen_amass_h5.py:34-94``), which this environment may lack: then it
  raises with the JAX package's message.

h5py, cv2 and ``human_body_prior`` are imported inside the functions
that use them.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Sequence

import numpy as np

from renderloom_torch.data import openpose as op_io


def emit_download_script(csv_file: str, video_dir: str,
                         out_script: str) -> int:
    """Write youtube-dl commands for the videos not yet present; returns
    the number of commands written (lib/download.py:42-52)."""
    existing = set()
    if os.path.isdir(video_dir):
        existing = {os.path.splitext(f)[0] for f in os.listdir(video_dir)
                    if f.endswith(".mp4")}
    n = 0
    with open(csv_file) as f, open(out_script, "w") as out:
        for row in csv.DictReader(f):
            fid, vid, fps = (row["File_name"], row["Youtube_id"],
                             row["FPS"])
            if fid in existing:
                continue
            target = os.path.join(video_dir, f"{fid}.mp4")
            out.write(
                f"youtube-dl -f 'bestvideo[height<=720][fps<={fps}]"
                f"[ext=mp4]' \"https://www.youtube.com/watch?v={vid}\" "
                f"-o \"{target}\"\n")
            n += 1
    return n


def extract_clips(video_dir: str, clip_json: str, out_dir: str,
                  crop: tuple = (100, 1180), size: tuple = (768, 512)
                  ) -> int:
    """Extract the frames listed per clip in ``clip_json`` ({clip:
    {video_name, video_frames[], num_frames}}) from the mp4s, keep the
    columns ``crop`` and resize to ``size`` (lib/gen_dataset.py:12-41);
    returns the frames written."""
    import cv2

    with open(clip_json) as f:
        clips = json.load(f)

    written = 0
    for clip_name, clip in clips.items():
        clip_out = os.path.join(out_dir, clip_name)
        os.makedirs(clip_out, exist_ok=True)
        wanted = set(clip["video_frames"])
        cap = cv2.VideoCapture(os.path.join(video_dir,
                                            clip["video_name"] + ".mp4"))
        ok, frame = cap.read()
        count = done = 0
        while ok:
            name = f"frame{count:05d}.png"
            if name in wanted:
                img = cv2.resize(frame[:, crop[0]:crop[1]], size)
                cv2.imwrite(os.path.join(clip_out, name), img)
                done += 1
                written += 1
            if done >= clip["num_frames"]:
                break
            ok, frame = cap.read()
            count += 1
        cap.release()
    return written


def _parse_pose_jsons(pose_dir: str) -> np.ndarray:
    """Sorted openpose JSONs → (F, 19, 3) in image coordinates
    (gen_dataset_h5.py:89-113: the largest-bbox person, hand means,
    zeros where nobody was detected)."""
    motion, conf, _ = op_io.read_openpose_dir(pose_dir, scale=1.0,
                                              offset=0.0)
    return np.concatenate([motion.transpose(2, 0, 1),
                           conf.transpose(2, 0, 1)], axis=2)


def _pack_image_folder(group, name: str, folder: str,
                       exts=(".png", ".jpg")) -> int:
    """The folder's images, in name order, as a vlen-uint8 dataset of
    their file bytes under ``group``; returns their count."""
    import h5py

    dt = h5py.special_dtype(vlen=np.uint8)
    files = [os.path.join(folder, f) for f in sorted(os.listdir(folder))
             if f.lower().endswith(exts)]
    dset = group.create_dataset(name, (len(files),), chunks=True, dtype=dt)
    for i, path in enumerate(files):
        with open(path, "rb") as fh:
            dset[i] = np.frombuffer(fh.read(), dtype=np.uint8)
    return len(files)


def pack_hsm_h5(root: str, out_path: str) -> Dict[str, int]:
    """Pack the HumanSloMo folder tree into ``HumanSlomo.h5``.

    Expects the reference's layout (gen_dataset_h5.py:42-51):
      root/test/{gt, poses, DAIN}/<clip>/…
      root/train/{frames, poses, DAIN}/<clip>/…
    Either phase may be absent.  Returns {clip: frame count}."""
    import h5py

    counts: Dict[str, int] = {}
    specs = (("test", "gt", ("gt_images", "gt_dain", "gt_poses")),
             ("train", "frames",
              ("train_images", "train_dain", "train_poses")))
    with h5py.File(out_path, "w") as out:
        for phase, img_sub, (k_img, k_dain, k_pose) in specs:
            img_root = os.path.join(root, phase, img_sub)
            if not os.path.isdir(img_root):
                continue
            dain_root = os.path.join(root, phase, "DAIN")
            pose_root = os.path.join(root, phase, "poses")
            for clip in sorted(os.listdir(img_root)):
                clip_img = os.path.join(img_root, clip)
                if not os.path.isdir(clip_img):
                    continue
                grp = out.require_group(clip)
                counts[clip] = _pack_image_folder(grp, k_img, clip_img)
                dain_dir = os.path.join(dain_root, clip)
                if os.path.isdir(dain_dir):
                    _pack_image_folder(grp, k_dain, dain_dir)
                pose_dir = os.path.join(pose_root, clip)
                if os.path.isdir(pose_dir):
                    grp.create_dataset(k_pose,
                                       data=_parse_pose_jsons(pose_dir),
                                       dtype=np.float64)
    return counts


def pack_amass_h5(amass_dir: str, out_path: str, splits: Sequence[str],
                  body_model_path: str = "",
                  keep_middle: float = 0.8) -> int:
    """AMASS npz archives → ``AMASS_3D_joints.h5`` (gen_amass_h5.py:
    34-94): per motion, SMPL-H forward kinematics over the middle
    ``keep_middle`` of its frames, (T, 52, 3) joints stored under
    ``<dataset>/<model>_<motion>/joints``.

    Needs the external ``human_body_prior`` package and an SMPL-H model
    file (the reference's external dependency); raises ImportError
    without them.  Returns the motions written."""
    try:
        from human_body_prior.body_model.body_model import BodyModel
    except ImportError as e:
        raise ImportError(
            "pack_amass_h5 needs the external 'human_body_prior' package "
            "and an SMPL-H model file (see the AMASS project); this "
            "environment does not ship it. Precomputed-joint h5 files "
            "from the reference pipeline load directly via "
            "renderloom_torch.data.amass.AmassReader.") from e
    import h5py
    import torch

    written = 0
    with h5py.File(out_path, "w") as out:
        for dataset_name in splits:
            droot = os.path.join(amass_dir, dataset_name)
            if not os.path.isdir(droot):
                continue
            sub = out.create_group(dataset_name)
            for model in sorted(os.listdir(droot)):
                mdir = os.path.join(droot, model)
                if not os.path.isdir(mdir):
                    continue
                for motion in sorted(f for f in os.listdir(mdir)
                                     if f.endswith(".npz")):
                    data = np.load(os.path.join(mdir, motion))
                    if "poses" not in data:
                        continue
                    N = len(data["poses"])
                    lo = int((1 - keep_middle) / 2 * N)
                    hi = int((1 + keep_middle) / 2 * N)
                    if hi - lo < 1:
                        continue
                    n = hi - lo
                    bm = BodyModel(bm_path=body_model_path, num_betas=10,
                                   batch_size=n)
                    poses = data["poses"][lo:hi]
                    body = bm(
                        root_orient=torch.Tensor(poses[:, :3]),
                        pose_body=torch.Tensor(poses[:, 3:66]),
                        pose_hand=torch.Tensor(poses[:, 66:]),
                        betas=torch.Tensor(
                            np.repeat(data["betas"][:10][None], n, 0)),
                        trans=torch.Tensor(data["trans"][lo:hi]))
                    grp = sub.create_group(f"{model}_{motion}")
                    grp.create_dataset("joints",
                                       data=body.Jtr.detach().numpy(),
                                       dtype=np.float64)
                    written += 1
    return written
