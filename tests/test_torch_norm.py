"""Instance norm of the PyTorch port (the plain twin of the CUDA kernel
``renderloom_torch/csrc/instance_norm.cu``) against the JAX package:
``models/layers.instance_norm`` and the Pallas kernel
``ops/norm_pallas.instance_norm_fused`` in interpret mode.

Tolerances: 1e-5 absolute in float32 (summation order differs); in
bfloat16 8e-3 absolute plus 8e-3 relative, one bf16 ulp at |y| < 2 —
fp32 values 1e-7 apart can round to neighbouring bf16 values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import single_thread  # noqa: F401
from renderloom.models.layers import LEAKY_SLOPE, instance_norm, leaky
from renderloom.ops.norm_pallas import instance_norm_fused
from renderloom_torch.ops import norm_kernel


def _x(shape, seed, loc=0.0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (loc + scale * rng.normal(size=shape)).astype(np.float32)


def _affine(C, seed):
    rng = np.random.default_rng(seed)
    return ((2.0 + rng.normal(size=C)).astype(np.float32),
            rng.normal(size=C).astype(np.float32))


@pytest.mark.parametrize("affine", [False, True])
def test_twin_matches_layers_instance_norm(affine):
    x = _x((2, 8, 12, 6), 0, loc=3.0)
    s, b = _affine(6, 1) if affine else (None, None)
    want = instance_norm(jnp.asarray(x),
                         scale=None if s is None else jnp.asarray(s),
                         bias=None if b is None else jnp.asarray(b))
    got = norm_kernel.instance_norm(
        torch.from_numpy(x), None if s is None else torch.from_numpy(s),
        None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_twin_large_mean_matches_shift_exact_reference():
    """The fp32 contract of layers._in_moments: mean 4096, std 1e-2
    keeps its variance (the unshifted Pallas moments would lose it).
    Same case and tolerance as tests/test_layers_extra.py."""
    z = np.random.default_rng(0).normal(0, 1, (2, 24, 32, 8))
    x32 = (4096.0 + 1e-2 * z).astype(np.float32)
    x64 = x32.astype(np.float64)
    ref = (x64 - x64.mean(axis=(1, 2), keepdims=True)) / np.sqrt(
        x64.var(axis=(1, 2), keepdims=True) + 1e-5)
    got = norm_kernel.instance_norm(torch.from_numpy(x32)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3)
    # and it is the JAX fp32 path's arithmetic
    np.testing.assert_allclose(
        got, np.asarray(instance_norm(jnp.asarray(x32))), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_pallas_affine_leaky(dtype):
    x = _x((2, 8, 12, 16), 2)
    s, b = _affine(16, 3)
    jx = jnp.asarray(x, dtype)
    want = instance_norm_fused(jx, jnp.asarray(s), jnp.asarray(b),
                               slope=LEAKY_SLOPE, interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = norm_kernel.instance_norm(tx, torch.from_numpy(s),
                                    torch.from_numpy(b), LEAKY_SLOPE)
    assert got.dtype == tx.dtype
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
        ref = leaky(instance_norm(jx, scale=jnp.asarray(s),
                                  bias=jnp.asarray(b)))
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=8e-3, rtol=8e-3)


def test_cpu_tensor_takes_twin_and_cuda_wrapper_refuses_it():
    x = torch.from_numpy(_x((1, 4, 4, 3), 4))
    before = norm_kernel.instance_norm_cuda.launches
    np.testing.assert_array_equal(norm_kernel.instance_norm(x).numpy(),
                                  norm_kernel.instance_norm_plain(x).numpy())
    assert norm_kernel.instance_norm_cuda.launches == before
    with pytest.raises(ValueError):
        norm_kernel.instance_norm_cuda(x)


def test_geometry_covers_every_pixel_once():
    """The launch geometry of the serving shapes splits H·W into ranges
    that tile it exactly, with one C tile per 32 channels."""
    for B, n_px, C in [(7, 320 * 480, 16), (7, 40 * 60, 256),
                       (7, 20 * 30, 512), (1, 7, 3)]:
        ct, n_split, rows = norm_kernel._geometry(B, n_px, C)
        assert ct <= 32 and ct >= min(C, 32) and ct & (ct - 1) == 0
        assert (n_split - 1) * rows < n_px <= n_split * rows
