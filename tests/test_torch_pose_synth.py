"""The AMASS training-sample synthesis of the PyTorch port
(``renderloom_torch/ops/pose.py``) against the JAX package's
``renderloom/ops/pose.py``, with the JAX package's own random draws fed
to the port (JAX's PRNG streams cannot be reproduced in torch):
``_torch_parity.jax_synthesis_draws`` splits the keys exactly as
``synthesize_batch``, ``synthesize_sample`` and ``random_drop`` do.

Tolerances: float32 values to 1e-5 absolute (the same arithmetic; the
3×3 basis products may contract in another order), masks bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (jax_random_drop_draws,  # noqa: F401
                           jax_synthesis_draws, single_thread,
                           smpl_clips, t)
from renderloom.ops import pose as JP
from renderloom_torch.ops import pose as TP

ATOL = 1e-5


def _close(name, got, want, atol=ATOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, name
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, atol=atol, err_msg=name)


def test_geometry_matches_jax():
    clips = smpl_clips(3, 12)
    angles = np.random.default_rng(1).uniform(-2, 2, (3, 3)).astype(
        np.float32)
    jit = np.array([0.2, -0.1, 0.35], np.float32)
    for b in range(3):
        m, a = jnp.asarray(clips[b]), jnp.asarray(angles[b])
        _close("joints_to_openpose", TP.joints_to_openpose(t(clips))[b],
               JP.joints_to_openpose(m))
        _close("centralize", TP.centralize(t(clips))[b], JP.centralize(m))
        _close("body_basis", TP.body_basis(t(clips))[b], JP.body_basis(m))
        _close("body_basis view", TP.body_basis(t(clips), t(angles))[b],
               JP.body_basis(m, a))
        rot = TP.rotate_motion_3d(t(clips), t(angles))
        _close("rotate_motion_3d", rot[b], JP.rotate_motion_3d(m, a))
        for mode in ("perspective", "orthogonal"):
            got = TP.project_2d(rot, 4.0, 4.0, 1.5, mode, t(jit), t(-jit))
            want = JP.project_2d(JP.rotate_motion_3d(m, a), 4.0, 4.0, 1.5,
                                 mode, jit[b], -jit[b])
            _close(f"project_2d {mode}", got[b], want)


@pytest.mark.parametrize("mode", ["linear", "quadratic"])
@pytest.mark.parametrize("L", [17, 19])      # (L - 1) % 4: 0, then 2
def test_keyframe_interpolate_matches_jax(mode, L):
    x = np.random.default_rng(L).normal(size=(2, 3, L)).astype(np.float32)
    got = TP.keyframe_interpolate(t(x), 4, mode)
    _close(f"{mode} L={L}", got, JP.keyframe_interpolate(jnp.asarray(x), 4,
                                                         mode))
    if L == 19 and mode == "linear":
        # the last partial segment runs toward the final frame: its
        # keyframe index 20 is clamped to 18
        np.testing.assert_allclose(got[..., 17].numpy(),
                                   x[..., 16] / 4 * 3 + x[..., 18] / 4,
                                   atol=ATOL)
    if mode == "quadratic":
        # the first segment's stand-in is the negated next keyframe
        tt = 0.5
        want = x[..., 0] + ((x[..., 4] - x[..., 0]) + (-x[..., 4] - x[..., 0])
                            ) / 2 * tt ** 2 + ((x[..., 4] - x[..., 0])
                                               - (-x[..., 4] - x[..., 0])
                                               ) / 2 * tt
        np.testing.assert_allclose(got[..., 2].numpy(), want, atol=ATOL)


def test_random_drop_and_decoder_mask_match_jax():
    B, L, rate = 3, 33, 4
    data = np.random.default_rng(2).normal(size=(B, 19, 2, L)).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    per = [jax_random_drop_draws(k, 19, 2, L, rate) for k in keys]
    draws = {k: torch.from_numpy(np.stack([d[k] for d in per]))
             for k in per[0]}
    got = TP.random_drop(t(data), rate, draws, 0.5, 3, 2, 2)
    for b in range(B):
        _close("random_drop", got[b], JP.random_drop(
            keys[b], jnp.asarray(data[b]), rate, 0.5, 3, 2, 2))
    enc = TP.encoder_mask_from_pad(torch.arange(L) >= 30, rate)
    idx = [np.asarray(jax.random.randint(k, (6,), 0, L)) for k in keys]
    got = TP.decoder_mask_from_encoder(enc.expand(B, L).clone(),
                                       torch.from_numpy(np.stack(idx)))
    for b in range(B):
        _close("decoder_mask", got[b], JP.decoder_mask_from_encoder(
            keys[b], jnp.asarray(enc.numpy()), 6))


@pytest.mark.parametrize("variant", ["2d", "3d", "clean"])
def test_synthesize_batch_matches_jax(variant):
    B, L = 3, 33
    p = JP.SynthesisParams(rate=8, sample_size=8, noise_rate=2,
                           joint_drop_rate=2, flip_rate=1)
    if variant == "3d":
        p = dataclasses.replace(p, return_3d=True)
    if variant == "clean":
        p = dataclasses.replace(p, rotation_aug=False, projection_noise=False,
                                train_noise=False)
    J, D = (52, 3) if p.return_3d else (19, 2)
    rng = np.random.default_rng(3)
    mean = rng.normal(scale=0.1, size=(J, D)).astype(np.float32)
    std = rng.uniform(0.5, 2.0, (J, D)).astype(np.float32)
    clips = smpl_clips(B, L, seed=4)
    pad = np.zeros((B, L), bool)
    pad[1, 25:] = True
    clips[1, :, :, 25:] = 0.0
    key = jax.random.PRNGKey(11)
    want = JP.synthesize_batch(key, jnp.asarray(clips), jnp.asarray(pad),
                               jnp.asarray(mean), jnp.asarray(std), p)
    draws = jax_synthesis_draws(key, B, L, p)
    got = TP.synthesize_batch(t(clips), t(pad), t(mean), t(std),
                              TP.SynthesisParams(**dataclasses.asdict(p)),
                              draws)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(k, got[k], want[k])
    # one clip: the JAX synthesize_sample on the key batch row 1 used
    k1 = jax.random.split(key, B)[1]
    one = TP.synthesize_sample(t(clips[1]), t(pad[1]), t(mean), t(std),
                               TP.SynthesisParams(**dataclasses.asdict(p)),
                               {k: v[1:2] for k, v in draws.items()})
    ref = JP.synthesize_sample(k1, jnp.asarray(clips[1]), jnp.asarray(pad[1]),
                               jnp.asarray(mean), jnp.asarray(std), p)
    for k in ref:
        _close(f"sample {k}", one[k], ref[k])


def test_draw_synthesis_shapes_and_ranges():
    p = TP.SynthesisParams(rate=8, sample_size=8)
    B, L = 4, 33
    d = TP.draw_synthesis(torch.Generator().manual_seed(0), B, L, p)
    assert d["view"].shape == (B, 3)
    assert (d["view"].abs() <= torch.tensor(p.rotation_axes) * np.pi).all()
    assert d["focal"].abs().max() <= 0.4 and d["depth"].shape == (B,)
    assert d["noise"].shape == (B, 19, 2, L)
    assert ((0 <= d["noise"]) & (d["noise"] < 1)).all()
    for k, n in (("noise_frames", 5), ("noise_joints", 12),
                 ("drop_joints", 13)):
        assert (d[k].sort(dim=1).values == torch.arange(n)).all(), k
    assert d["dec_idx"].shape == (B, 8) and d["dec_idx"].max() < L
    again = TP.draw_synthesis(torch.Generator().manual_seed(0), B, L, p)
    assert all(torch.equal(d[k], again[k]) for k in d)
    off = TP.draw_synthesis(torch.Generator().manual_seed(0), B, L,
                            dataclasses.replace(p, rotation_aug=False,
                                                projection_noise=False,
                                                train_noise=False))
    assert sorted(off) == ["dec_idx"]
