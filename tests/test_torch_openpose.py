"""The PyTorch port's openpose JSON I/O (``renderloom_torch/data/
openpose.py``) and cached motion statistics (``renderloom_torch/data/
amass.py``) against the JAX package's, bit for bit: the same folders
read to the same arrays, the same arrays write the same files."""

import json
import os

import numpy as np
import pytest

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from renderloom.data import amass as JA
from renderloom.data import openpose as JO
from renderloom_torch.data import amass as TA
from renderloom_torch.data import openpose as TO


def _person(rng, x0, y0, size, n_valid=25, hand_valid=(21, 21)):
    body = np.zeros((25, 3))
    body[:, 0] = x0 + size * rng.uniform(0, 1, 25)
    body[:, 1] = y0 + size * rng.uniform(0, 1, 25)
    body[:n_valid, 2] = rng.uniform(0.05, 1.0, n_valid)

    def hand(n):
        pts = np.zeros((21, 3))
        pts[:, :2] = rng.uniform(0, 300, (21, 2))
        pts[:n, 2] = rng.uniform(0.2, 1.0, n)
        return pts.reshape(-1).tolist()

    return {"person_id": [-1], "pose_keypoints_2d": body.reshape(-1).tolist(),
            "hand_left_keypoints_2d": hand(hand_valid[0]),
            "hand_right_keypoints_2d": hand(hand_valid[1])}


def _folder(path, seed=0):
    """Frames exercising every rule: nobody in frame 0 (zeros), a spurious
    small detection beside the largest person, a person with fewer than
    8 valid body joints (skipped), hands with 5 and 6 valid points (the
    mean needs six), nobody again (the last pose carries), and
    low-confidence joints."""
    rng = np.random.default_rng(seed)
    frames = [
        [],
        [_person(rng, 10, 10, 30), _person(rng, 100, 80, 200)],
        [_person(rng, 50, 50, 150, n_valid=7), _person(rng, 60, 40, 120,
                                                      hand_valid=(5, 6))],
        [],
        [_person(rng, 20, 30, 180, n_valid=20, hand_valid=(6, 0))],
        [_person(rng, 200, 10, 90)],
    ]
    os.makedirs(path, exist_ok=True)
    for i, people in enumerate(frames):
        with open(os.path.join(path, f"{i:06d}_keypoints.json"), "w") as f:
            json.dump({"version": 1.3, "people": people}, f)
    return path


@pytest.mark.parametrize("kwargs", [
    {}, dict(scale=1.0, offset=0.0), dict(scale=300.0, offset=128.0),
    dict(thres=0.3), dict(max_frames=4)])
def test_read_openpose_dir_matches_jax(tmp_path, kwargs):
    path = _folder(str(tmp_path / "poses"))
    got = TO.read_openpose_dir(path, **kwargs)
    want = JO.read_openpose_dir(path, **kwargs)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]


def test_selection_and_hand_means_match_jax():
    rng = np.random.default_rng(3)
    people = [_person(rng, 0, 0, 20), _person(rng, 0, 0, 200, n_valid=7),
              _person(rng, 5, 5, 90)]
    assert TO.select_largest_person(people) == \
        JO.select_largest_person(people) == 2
    for n in (5, 6, 21):
        pts = np.asarray(_person(rng, 0, 0, 1, hand_valid=(n, n))
                         ["hand_left_keypoints_2d"]).reshape(-1, 3)
        np.testing.assert_array_equal(TO.mean_valid_keypoint(pts),
                                      JO.mean_valid_keypoint(pts))
    assert not TO.mean_valid_keypoint(pts[:5]).any()


def test_write_openpose_dir_matches_jax_and_round_trips(tmp_path):
    rng = np.random.default_rng(1)
    motion = rng.uniform(-0.5, 0.5, (19, 2, 5))
    conf = rng.uniform(0.1, 1.0, (19, 1, 5))
    TO.write_openpose_dir(motion, conf, str(tmp_path / "port"), 400.0, 200.0)
    JO.write_openpose_dir(motion, conf, str(tmp_path / "jax"), 400.0, 200.0)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 5
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes()
    back, back_conf, _ = TO.read_openpose_dir(str(tmp_path / "port"),
                                              400.0, 200.0)
    # the hand rows come back as the mean of 21 copies: float64 rounding
    np.testing.assert_allclose(back, motion, atol=1e-12)
    np.testing.assert_allclose(back_conf, conf, atol=1e-12)


@pytest.mark.parametrize("return_type", ["network", "3D"])
def test_load_stats_from_cached_files_matches_jax(tmp_path, return_type):
    tcfg = TC.MotionDatasetConfig(data_root=str(tmp_path),
                                  return_type=return_type, focal=5.0)
    jcfg = JC.MotionDatasetConfig(data_root=str(tmp_path),
                                  return_type=return_type, focal=5.0)
    assert TA.stats_paths(tcfg) == JA.stats_paths(jcfg)
    with pytest.raises(FileNotFoundError):
        TA.load_or_compute_stats(None, tcfg)
    # a reader without cached files computes them (test_torch_amass.py);
    # one that matched no motion raises, as JAX's does
    empty = type("Empty", (), {"samples": [], "splits": ("none",)})()
    for load, cfg in ((TA.load_or_compute_stats, tcfg),
                      (JA.load_or_compute_stats, jcfg)):
        with pytest.raises(ValueError, match="matched no motions"):
            load(empty, cfg)
    rng = np.random.default_rng(2)
    for path in TA.stats_paths(tcfg):
        np.save(path, rng.uniform(0.1, 1.0, (19, 2)))     # float64 on disk
    got = TA.load_or_compute_stats(None, tcfg)
    want = JA.load_or_compute_stats(None, jcfg)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
