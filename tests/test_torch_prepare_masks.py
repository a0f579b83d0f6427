"""The deterministic ``prepare_batch`` of the PyTorch port returns the
human mask ``fg_mask`` (the JAX ``want_masks=True`` default), equal bit
for bit to the JAX package's ``prepare_batch(None, ..., train=False)``
mask, in the identity-warp branch (source at model size) and in the
resize branch; serving asks for no mask and gets none.

Tolerances: masks exact (0/1 from the same capsule tests); labels,
images and backgrounds 1e-5 (the same float32 arithmetic, summed in
another order in the resize).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import single_thread, t  # noqa: F401
from renderloom.data import hsm as JH
from renderloom_torch.data import hsm as TH

H, W = 64, 96          # model and load size


def _poses(n, seed):
    """n frames of 19 joints around the middle of the source frame, some
    with zero confidence."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.25, 0.75, (n, 19, 2)) * np.array([W, H])
    conf = rng.uniform(0.2, 1.0, (n, 19, 1))
    conf[:, ::7] = 0.0
    return np.concatenate([xy, conf], -1)


@pytest.mark.parametrize("src", [(H, W), (80, 120)],
                         ids=["identity", "resize"])
def test_deterministic_fg_mask_matches_jax(src):
    B, F_ = 2, 3
    h0, w0 = src
    rng = np.random.default_rng(4)
    poses = (_poses(B * F_, 5) * np.array([w0 / W, h0 / H, 1.0])).reshape(
        B, F_, 19, 3)
    batch = {"images": rng.uniform(0, 255, (B, F_, h0, w0, 3)),
             "dain": rng.uniform(0, 255, (B, F_, h0, w0, 3)),
             "poses": poses}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    kw = dict(model_width=W, model_height=H, load_width=W, load_height=H)
    jcfg = JC.RendererDataConfig(**kw)
    want = jax.jit(lambda b: JH.prepare_batch(None, b, jcfg, train=False))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = TH.prepare_batch({k: t(v) for k, v in batch.items()},
                           TC.RendererDataConfig(**kw))
    assert set(got) == {"label", "image", "back", "fg_mask"}
    mask = np.asarray(want["fg_mask"], np.float32)
    assert got["fg_mask"].shape == (B, F_, H, W, 1) == mask.shape
    assert got["fg_mask"].dtype == torch.float32
    assert 0 < mask.mean() < 1          # people and background
    np.testing.assert_array_equal(got["fg_mask"].numpy(), mask)
    for k in ("label", "image", "back"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)
    served = TH.prepare_batch({k: t(v) for k, v in batch.items()},
                              TC.RendererDataConfig(**kw), want_masks=False)
    assert "fg_mask" not in served
    torch.testing.assert_close(served["label"], got["label"], rtol=0, atol=0)
