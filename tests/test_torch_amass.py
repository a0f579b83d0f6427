"""The AMASS reader, windows and statistics of the PyTorch port
(``renderloom_torch/data/amass.py``) and the motion config's training
sections against the JAX package's, on a tiny h5 the test writes:
windows and batches bit for bit under the same seed, statistics to
1e-6 relative (the same float32 projection, float64 sums), the config
loaders field for field.
"""

import dataclasses
import os

import numpy as np
import pytest

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import single_thread, write_amass_h5  # noqa: F401
from renderloom.data import amass as JA
from renderloom_torch.data import amass as TA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = {"CMU": (40, 25, 70, 33), "KIT": (50,), "HumanEva": (45, 20)}


@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    return write_amass_h5(str(tmp_path_factory.mktemp("amass") / "j.h5"),
                          GROUPS)


def test_windows_match_jax():
    data = np.random.default_rng(0).normal(size=(52, 3, 50)).astype(
        np.float32)
    for T, max_len, rate in ((50, 33, 8), (50, 50, 8), (30, 33, 8),
                             (20, 33, 4)):
        ra, rb = np.random.default_rng(T), np.random.default_rng(T)
        got = TA.random_window(ra, data[:, :, :T], max_len, rate)
        want = JA.random_window(rb, data[:, :, :T], max_len, rate)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert ra.integers(1 << 30) == rb.integers(1 << 30)   # same draws
        for align in (16, 8):
            got = TA.center_window(data[:, :, :T], max_len, align)
            want = JA.center_window(data[:, :, :T], max_len, align)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]


def test_reader_batches_match_jax(h5):
    splits = ("CMU", "KIT", "absent")
    port, ref = TA.AmassReader(h5, splits), JA.AmassReader(h5, splits)
    assert port.samples == ref.samples and len(port) == 5
    np.testing.assert_array_equal(port.read_motion("CMU", "m1"),
                                  ref.read_motion("CMU", "m1"))
    for kwargs in ({}, {"drop_last": False},
                   {"process_index": 1, "process_count": 2,
                    "drop_last": False}):
        got = list(port.batches(np.random.default_rng(3), 2, 33, 8,
                                **kwargs))
        want = list(ref.batches(np.random.default_rng(3), 2, 33, 8,
                                **kwargs))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ["motion3d", "pad_mask"]
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    port.close()


@pytest.mark.parametrize("return_type", ["network", "3D"])
def test_compute_stats_matches_jax(h5, tmp_path, return_type):
    kw = dict(data_root=str(tmp_path), return_type=return_type)
    tcfg, jcfg = TC.MotionDatasetConfig(**kw), JC.MotionDatasetConfig(**kw)
    splits = ("CMU", "HumanEva")
    got = TA.compute_stats(TA.AmassReader(h5, splits), tcfg)
    want = JA.compute_stats(JA.AmassReader(h5, splits), jcfg)
    shape = (19, 2) if return_type == "network" else (52, 3)
    for g, w in zip(got, want):
        assert g.shape == w.shape == shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    limited = TA.compute_stats(TA.AmassReader(h5, splits), tcfg, limit=2)
    np.testing.assert_allclose(
        limited[0], JA.compute_stats(JA.AmassReader(h5, splits), jcfg,
                                     limit=2)[0], rtol=1e-6, atol=1e-7)
    # the computing branch caches them with the reference's names
    loaded = TA.load_or_compute_stats(TA.AmassReader(h5, splits), tcfg)
    for g, path in zip(got, TA.stats_paths(tcfg)):
        np.testing.assert_array_equal(np.load(path), g)
    for g, w in zip(loaded, got):
        np.testing.assert_array_equal(g, w)


def test_motion_config_training_sections_match_jax(tmp_path):
    flat = tmp_path / "flat.yaml"
    flat.write_text("lr: 0.5\nnoise_rate: 3\nw_2d: 7.0\nseed: 4\n"
                    "optim:\n  gamma: 0.1\n  grad_clip: 2.0\n")
    for path in (os.path.join(ROOT, "configs", "motion.yaml"),
                 os.path.join(ROOT, "configs", "smoke_motion.yaml"),
                 str(flat)):
        got = dataclasses.asdict(TC.load_motion_config(path))
        want = dataclasses.asdict(JC.load_motion_config(path))
        assert got == want, path
    c = TC.load_motion_config(str(flat))
    assert (c.optim.lr, c.optim.gamma, c.optim.grad_clip, c.w_2d,
            c.seed) == (0.5, 0.1, 2.0, 7.0, 4)
    assert dataclasses.asdict(TC.MotionConfig()) == \
        dataclasses.asdict(JC.MotionConfig())
