"""The PyTorch port's ``evaluate_h5`` (``renderloom_torch/eval/
render_eval.py``) against the JAX package's on a tiny HumanSloMo h5 the
test writes, at 64×96 with tiny widths, the same generator weights and
the same random VGG19 weights for LPIPS.

Tolerances: float32, every metric to 1e-4 relative (the readings are at
most 4e-6: the tiny generator through up to three steps, summed in
another order than XLA's).  bfloat16 (``compute_dtype``), held as
``_torch_parity.hold_bf16`` holds outputs: the mean |port − JAX bf16|
over the six metrics within ``BF16_MEAN_TOL`` (about 1.35× the reading
of 4.7e-5), and the largest distance from JAX float32 within 1.5× JAX
bf16's own + 1e-3.  Averaged metrics cannot tell a port that ran in
float32 (its mean distance from JAX bf16 reads 3.1e-5), so the test also
checks that ``OURS_*`` differ from the port's float32 values (the clip
ran in bf16) while ``DAIN_*``, which do not involve the generator, equal
them exactly.
"""

import dataclasses
import os
import types

import jax
import numpy as np
import pytest

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import (generator_trees, hold_bf16,  # noqa: F401
                           renderer_cfg, single_thread, write_hsm_h5)
from renderloom.data.hsm import HsmReader as JReader
from renderloom.eval import render_eval as JE
from renderloom.models.perceptual import PerceptualLoss as JPerceptual
from renderloom_torch.data.hsm import HsmReader
from renderloom_torch.eval import render_eval as TE
from renderloom_torch.train.gan import make_perceptual

H, W = 64, 96
# 7 frames: (7 − 1) % 2 == 0, the segment rollout; 6: the sequential one
CLIPS = {"clip_seg": 7, "clip_seq": 6}
KEYS = ("DAIN_PSNR", "DAIN_SSIM", "OURS_PSNR", "OURS_SSIM", "DAIN_LPIPS",
        "OURS_LPIPS")
BF16_MEAN_TOL = 6.5e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hsm") / "HumanSlomo.h5")
    write_hsm_h5(path, CLIPS, H, W, seed=8, phases=("gt",))
    jcfg = renderer_cfg(JC, H, W)
    vgg = JPerceptual()
    return dict(h5=path, jcfg=jcfg, trees=generator_trees(jcfg, H, W, seed=3),
                vgg=vgg, vgg_params=jax.device_get(vgg.variables["params"]))


def _jax(s, clips, compute_dtype="float32"):
    params, stats = s["trees"]
    cfg = dataclasses.replace(s["jcfg"], compute_dtype=compute_dtype)
    return JE.evaluate_h5(None, types.SimpleNamespace(params_g=params,
                                                      stats_g=stats), cfg,
                          JReader(s["h5"], clips, "test"), max_keyframes=3,
                          perceptual=s["vgg"])


def _port(s, clips, compute_dtype="float32", **kw):
    cfg = dataclasses.replace(renderer_cfg(TC, H, W),
                              compute_dtype=compute_dtype)
    # LPIPS through the float32 VGG in both configurations, as in JAX
    vgg = make_perceptual(renderer_cfg(TC, H, W), "cpu",
                          params=s["vgg_params"])
    reader = HsmReader(s["h5"], clips, "test")
    try:
        return TE.evaluate_h5(*s["trees"], cfg, reader, max_keyframes=3,
                              perceptual=vgg, device="cpu", **kw)
    finally:
        reader.close()


@pytest.fixture(scope="module")
def jax_f32(setup):
    return {clip: _jax(setup, [clip]) for clip in CLIPS}


@pytest.mark.parametrize("clip", list(CLIPS))
def test_evaluate_h5_matches_jax(setup, jax_f32, clip):
    got, want = _port(setup, [clip]), jax_f32[clip]
    assert sorted(got) == sorted(want) == sorted(KEYS)
    for k in KEYS:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_evaluate_h5_bf16_matches_jax_bf16(setup, jax_f32):
    clips = list(CLIPS)
    got = _port(setup, clips, "bfloat16")
    port32 = _port(setup, clips)
    want = _jax(setup, clips, "bfloat16")
    # both clips have three generated frames: the totals are the mean
    ref = {k: np.mean([jax_f32[c][k] for c in clips]) for k in KEYS}
    vec = lambda d: [d[k] for k in KEYS]
    hold_bf16("evaluate_h5 metrics", vec(got), vec(want), vec(ref),
              BF16_MEAN_TOL)
    for k in KEYS:
        if k.startswith("DAIN"):
            assert got[k] == port32[k], k
        else:
            assert got[k] != port32[k], k


def test_evaluate_h5_writes_one_video_per_clip(setup, tmp_path):
    vdir = str(tmp_path / "videos")
    _port(setup, list(CLIPS), video_dir=vdir)
    files = sorted(os.listdir(vdir))
    assert len(files) == len(CLIPS)
    assert [f.split(".")[0] for f in files] == sorted(CLIPS)
