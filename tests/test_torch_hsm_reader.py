"""The PyTorch port's HumanSloMo reader (``renderloom_torch/data/hsm.py``:
``HsmReader``, ``decode_images``, ``process_shard``) and its copy of the
C++ decoder (``renderloom_torch/native``) against the JAX package's, bit
for bit, on a tiny h5 the test writes: a clip of 6 frames and one of 3,
shorter than the 4-frame window."""

import io

import numpy as np
import pytest
import torch.distributed as dist
from PIL import Image

from _torch_parity import write_hsm_h5
from renderloom import native as jnative
from renderloom.data.hsm import HsmReader as JReader
from renderloom_torch import native
from renderloom_torch.data import hsm as TH

H, W = 24, 40
CLIPS = {"clip_a": 6, "clip_b": 3}


@pytest.fixture(scope="module")
def h5_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hsm") / "tiny.h5")
    return write_hsm_h5(path, CLIPS, H, W, seed=4)


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("phase", ["train", "gt"])
def test_reader_windows_match_jax(h5_path, phase):
    videos = ["clip_a", "missing", "clip_b"]
    port, ref = (R(h5_path, videos, phase, max_frames=4)
                 for R in (TH.HsmReader, JReader))
    assert port.samples == ref.samples and len(port) == len(ref) == 3
    assert port.n_frames == ref.n_frames == CLIPS
    for vid, start in ref.samples:
        _same(port.read_window(vid, start), ref.read_window(vid, start))
    # frame 0 of a clip has no DAIN frame before it: a zero row
    assert not port.read_window("clip_a", 0)["dain"][0].any()
    port.set_max_frames(2)
    ref.set_max_frames(2)
    assert port.samples == ref.samples and len(port) == 7
    for vid, start in ref.samples:
        _same(port.read_window(vid, start), ref.read_window(vid, start))
    port.close()


def test_read_test_frame_matches_jax(h5_path):
    port, ref = (R(h5_path, list(CLIPS), "test") for R in (TH.HsmReader,
                                                           JReader))
    for vid, n in CLIPS.items():
        for i in range(n):
            _same(port.read_test_frame(vid, i), ref.read_test_frame(vid, i))
    port.close()


@pytest.mark.parametrize("shuffle,drop_last,proc", [
    (True, True, (0, 1)), (True, False, (0, 2)), (True, False, (1, 2)),
    (False, False, (2, 3))])
def test_batches_match_jax(h5_path, shuffle, drop_last, proc):
    port, ref = (R(h5_path, list(CLIPS), "train", max_frames=2)
                 for R in (TH.HsmReader, JReader))
    kw = dict(shuffle=shuffle, drop_last=drop_last, process_index=proc[0],
              process_count=proc[1])
    got = list(port.batches(np.random.default_rng(5), 2, **kw))
    want = list(ref.batches(np.random.default_rng(5), 2, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _same(g, w)
    port.close()


def test_process_shard_reads_the_process_group(tmp_path):
    np.testing.assert_array_equal(TH.process_shard(5), np.arange(5))
    np.testing.assert_array_equal(TH.process_shard(7, 1, 3), [1, 4])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        np.testing.assert_array_equal(TH.process_shard(4), np.arange(4))
        np.testing.assert_array_equal(TH.process_shard(4, process_count=2),
                                      [0, 2])
    finally:
        dist.destroy_process_group()


def _encode(img, fmt):
    b = io.BytesIO()
    Image.fromarray(img).save(b, format=fmt, quality=95)
    return b.getvalue()


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(7).integers(0, 256, (6, 40, 56, 3),
                                             dtype=np.uint8)


def test_decoder_builds_here():
    """This host has g++ and the libpng/libjpeg headers, so the tests
    below hold the C++ decoder, not the PIL path."""
    assert native.native_available() and jnative.native_available()


@pytest.mark.parametrize("fmt", ["PNG", "JPEG", "mixed"])
def test_decoder_matches_jax_and_pil(images, fmt):
    bufs = [_encode(im, ("PNG", "JPEG")[i % 2] if fmt == "mixed" else fmt)
            for i, im in enumerate(images)]
    got = native.batch_decode(bufs, 40, 56)
    np.testing.assert_array_equal(got, jnative.batch_decode(bufs, 40, 56))
    pil = np.stack([np.asarray(Image.open(io.BytesIO(b)).convert("RGB"))
                    for b in bufs])
    np.testing.assert_array_equal(got, pil)
    if fmt == "PNG":
        np.testing.assert_array_equal(got, images)
    np.testing.assert_array_equal(native.batch_decode(bufs, 40, 56,
                                                      threads=1), got)
    assert native.image_dims(bufs[0]) == jnative.image_dims(bufs[0]) \
        == (56, 40)
    arrays = [np.frombuffer(b, np.uint8) for b in bufs]
    np.testing.assert_array_equal(TH.decode_images(arrays), got)


def test_decoder_wrong_size_raises(images):
    bufs = [_encode(images[0], "PNG")]
    with pytest.raises(ValueError, match="unexpected dims"):
        native.batch_decode(bufs, 41, 56)
    assert native.batch_decode([], 8, 8).shape == (0, 8, 8, 3)


def test_pil_path_matches_the_decoder(images, monkeypatch):
    """Where the decoder cannot build, PIL decodes to the same arrays and
    the wrong size still raises."""
    bufs = [_encode(im, "PNG") for im in images]
    want = native.batch_decode(bufs, 40, 56)
    monkeypatch.setattr(native, "load", lambda: None)
    assert not native.native_available()
    np.testing.assert_array_equal(native.batch_decode(bufs, 40, 56), want)
    assert native.image_dims(bufs[0]) == (56, 40)
    with pytest.raises(ValueError):
        native.batch_decode(bufs[:1], 41, 56)
