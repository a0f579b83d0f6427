"""OpenPose JSON folder ⇄ motion arrays.

A copy of the JAX package's ``renderloom/data/openpose.py`` (plain numpy
and json), kept here so the port never imports that package.  Same
external contract as the reference
(``Human_Motion_Modelling/utils/utils.py:85-229``): folders of
``*_keypoints.json`` files in the BODY25(+hands) schema produced by
AlphaPose/OpenPose, converted to/from the 19-joint normalized motion
layout (BODY25 joints 0–14 + 19 + 22, plus mean left-hand and mean
right-hand points).  This is the ingestion boundary for the external pose
detector — renderloom reads/writes the same JSONs so reference-produced
assets work unchanged.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

# BODY25 rows kept: body 0-14 plus big toes (19 = LBigToe, 22 = RBigToe)
BODY25_KEEP = list(range(15)) + [19, 22]
NUM_JOINTS = 19
DEFAULT_SCALE = 512.0
DEFAULT_OFFSET = 256.0


def mean_valid_keypoint(pts: np.ndarray, thres: float = 0.01) -> np.ndarray:
    """Mean of confident hand keypoints; zeros when fewer than 6 are valid
    (utils.py:81-91)."""
    out = np.zeros((1, 3))
    valid = pts[:, 2] > thres
    if valid.sum() > 5:
        out = np.mean(pts[valid], axis=0, keepdims=True)
    return out


def select_largest_person(people: list, thres: float = 0.01) -> int:
    """Index of the person with the largest valid-joint bbox area, or -1
    (utils.py:93-115).  Guards against spurious background detections."""
    best_idx, best_area = -1, -1.0
    for i, person in enumerate(people):
        joints = np.asarray(person["pose_keypoints_2d"],
                            dtype=np.float64).reshape(-1, 3)[:15]
        valid = joints[:, 2] > thres
        if valid.sum() < 8:
            continue
        xs, ys = joints[valid, 0], joints[valid, 1]
        area = (xs.max() - xs.min()) * (ys.max() - ys.min())
        if area > best_area:
            best_area, best_idx = area, i
    return best_idx


def read_openpose_dir(json_dir: str, scale: Optional[float] = None,
                      offset: Optional[float] = None,
                      max_frames: Optional[int] = None,
                      thres: float = 0.0
                      ) -> Tuple[np.ndarray, np.ndarray,
                                 Tuple[float, float]]:
    """JSON dir → ``(motion (19,2,L), conf (19,1,L), (scale, offset))``.

    Normalization: ``(xy - offset) / scale``; zero-confidence joints are
    zeroed; frames with no detected person repeat the previous frame
    (utils.py:116-176).
    """
    files = sorted(f for f in os.listdir(json_dir) if f.endswith(".json"))
    if max_frames is not None:
        files = files[:max_frames]

    frames = []
    for fname in files:
        with open(os.path.join(json_dir, fname)) as f:
            payload = json.load(f)
        people = payload.get("people", [])
        idx = select_largest_person(people) if people else -1
        if idx != -1:
            person = people[idx]
            body = np.asarray(person["pose_keypoints_2d"],
                              dtype=np.float64).reshape(-1, 3)[BODY25_KEEP]
            lh = mean_valid_keypoint(np.asarray(
                person["hand_left_keypoints_2d"],
                dtype=np.float64).reshape(-1, 3))
            rh = mean_valid_keypoint(np.asarray(
                person["hand_right_keypoints_2d"],
                dtype=np.float64).reshape(-1, 3))
            joints = np.concatenate([body, lh, rh], axis=0)
            conf = joints[:, 2].copy()
            out = np.zeros_like(joints)
            out[conf > thres] = joints[conf > thres]
            out[:, 2] = conf
        else:
            # nobody detected: carry the previous pose (utils.py:158-162)
            out = frames[-1].copy() if frames else np.zeros(
                (NUM_JOINTS, 3))
        frames.append(out)

    motion = np.stack(frames, axis=0)                 # (L, 19, 3)
    conf = motion[:, :, 2]
    valid = conf > thres
    xy = motion[:, :, :2]

    scale = DEFAULT_SCALE if scale is None else scale
    offset = DEFAULT_OFFSET if offset is None else offset
    xy = (xy - offset) / scale
    xy[~valid] = 0.0

    return (xy.transpose(1, 2, 0), conf[:, :, None].transpose(1, 2, 0),
            (scale, offset))


def write_openpose_dir(motion: np.ndarray, conf: np.ndarray,
                       json_dir: str, scale: float = DEFAULT_SCALE,
                       offset: float = DEFAULT_OFFSET) -> None:
    """``(19,2,L)`` motion + ``(19,1,L)`` conf → openpose-schema JSON files
    (utils.py:179-229): rows 0-14 are BODY25 body joints, toes at 19/22,
    hand means replicated over all 21 hand keypoints."""
    os.makedirs(json_dir, exist_ok=True)
    seq_len = motion.shape[-1]
    for i in range(seq_len):
        joints = motion[:, :, i] * scale + offset     # (19, 2)
        c = conf[:, :, i]                             # (19, 1)
        body = np.zeros((25, 3))
        body[:15, :2] = joints[:15]
        body[:15, 2:] = c[:15]
        body[19] = np.concatenate([joints[15], c[15]])
        body[22] = np.concatenate([joints[16], c[16]])

        def hand(j):
            pt = np.concatenate([joints[j], c[j]])
            return np.tile(pt, (21, 1)).reshape(-1).tolist()

        payload = {
            "version": 1.3,
            "people": [{
                "person_id": [-1],
                "pose_keypoints_2d": body.reshape(-1).tolist(),
                "face_keypoints_2d": [],
                "hand_left_keypoints_2d": hand(17),
                "hand_right_keypoints_2d": hand(18),
                "pose_keypoints_3d": [],
                "face_keypoints_3d": [],
                "hand_left_keypoints_3d": [],
                "hand_right_keypoints_3d": [],
            }],
        }
        path = os.path.join(json_dir, f"{i:06d}_keypoints.json")
        with open(path, "w") as f:
            json.dump(payload, f)
