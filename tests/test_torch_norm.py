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

import chip_smoke as CS
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
    # the shifted mode's twin: a bf16 x through instance_norm() takes the
    # r3centered contract instead (tests/test_torch_bf16.py)
    got = norm_kernel.instance_norm_plain(tx, torch.from_numpy(s),
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


# (B, H, W, C) of every instance norm on the port's main paths at full
# width: standard serving (7 segments), the parity norms of the fastpath
# (packed, 4C channels), and one training step (batch 4, the
# discriminators' crops at 8); the keys of chip_smoke.py phases 4, N
# and B, which differ only in affine and leaky.  Last, one input past
# the grid's shared memory, which streams.
SERVE_SHAPES = [(7, 320, 480, 32), (7, 320, 480, 16), (7, 160, 240, 64),
                (7, 160, 240, 32), (7, 80, 120, 128), (7, 80, 120, 64),
                (7, 40, 60, 256), (7, 40, 60, 128), (7, 20, 30, 512),
                (7, 20, 30, 256)]
PARITY_SHAPES = [(7, 160, 240, 128), (7, 160, 240, 64), (7, 80, 120, 256),
                 (7, 80, 120, 128), (7, 40, 60, 512)]
TRAIN_SHAPES = [(4, 320, 480, 32), (4, 160, 240, 64), (4, 320, 480, 16),
                (4, 160, 240, 32), (4, 80, 120, 128), (4, 80, 120, 64),
                (4, 40, 60, 256), (4, 80, 120, 32), (4, 40, 60, 128),
                (4, 20, 30, 512), (4, 19, 29, 512), (4, 40, 60, 64),
                (4, 20, 30, 256), (4, 20, 30, 128), (4, 9, 14, 512),
                (4, 40, 40, 32), (4, 10, 15, 256), (8, 20, 20, 32),
                (4, 20, 20, 64), (4, 9, 9, 256), (8, 10, 10, 64),
                (4, 10, 10, 128), (8, 4, 4, 256), (8, 5, 5, 128)]
STREAM_SHAPE = (1, 1080, 1920, 32)
# (SMs, blocks per SM, shared memory per block): the H100's grid, as
# rl_norm_device reports it, and a smaller card's
H100 = (132, 1, 200 * 1024)
GRIDS = [H100, (108, 2, 96 * 1024)]


def _check_plan(shape, itemsize, n_inputs, grid, parity, dy_itemsize=None,
                n_sums=2):
    """Every (b, c, pixel) covered once, each block's share within its
    shared memory unless the plan streams, and the kernel's invariants
    (``plan_ok`` in csrc/instance_norm.cu)."""
    B, H, W, C = shape
    n_px = H * W
    p = norm_kernel._plan(B, n_px, C, itemsize, n_inputs, *grid,
                          parity=parity, dy_itemsize=dy_itemsize,
                          n_sums=n_sums)
    G, parts, rows = p["group"], p["parts"], p["rows_per_part"]
    assert C % G == 0
    assert G == C or (G * itemsize % 16 == 0 and G * itemsize >= 32)
    if parity:      # the four parity groups of a channel in one slab
        assert G == C and C % 4 == 0
    assert p["grid"] == grid[0] * grid[1]
    assert p["slabs_per_chunk"] * parts <= p["grid"]
    n_tables = 7 if n_inputs == 1 else 7 + n_sums
    dsz = dy_itemsize or itemsize
    x_bytes = p["rows_cap"] * G * itemsize
    row_bytes = x_bytes if n_inputs == 1 else (
        -(-x_bytes // dsz) * dsz + p["rows_cap"] * G * dsz)
    data = -(-row_bytes // 16) * 16
    assert p["rows_cap"] >= 1 and data + 4 * n_tables * G <= grid[2]
    assert p["streaming"] == (rows > p["rows_cap"])
    assert isinstance(p["grid_reduce"], bool)
    ng = C // G
    cover = np.zeros((B, ng, n_px), np.int16)
    for chunk in range(p["n_chunks"]):      # the kernel's struct Work
        for k in range(p["grid"]):
            sl, part = divmod(k, parts)
            s = chunk * p["slabs_per_chunk"] + sl
            if sl >= p["slabs_per_chunk"] or s >= B * ng:
                continue
            p0 = part * rows
            assert p0 < n_px
            cover[s // ng, s % ng, p0:p0 + rows] += 1
    np.testing.assert_array_equal(cover, 1)
    return p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kind", (
    [(s, "serve") for s in SERVE_SHAPES]
    + [(s, "parity") for s in PARITY_SHAPES]
    + [(s, "train") for s in TRAIN_SHAPES] + [(STREAM_SHAPE, "stream")]))
def test_plan_covers_every_element_once(shape, kind, dtype):
    """``_plan`` at every main-path shape, forward (x) and backward (x
    and dy; the parity norm has none), on two grids; for bf16 also the
    r3centered backward at an affine call site (float32 dy, four sums).
    On the H100's grid no main-path call streams, so each input is read
    once."""
    itemsize = 4 if dtype == "float32" else 2
    cases = [(1, None, 2)] if kind == "parity" else [(1, None, 2),
                                                     (2, None, 2)]
    if dtype == "bfloat16" and kind != "parity":
        cases.append((2, 4, 4))
    for n_inputs, dy_itemsize, n_sums in cases:
        for grid in GRIDS:
            p = _check_plan(shape, itemsize, n_inputs, grid,
                            kind == "parity", dy_itemsize, n_sums)
            if grid == H100:
                assert p["streaming"] == (kind == "stream"), p


# The shared memory a cluster-path block may take on the same two cards
# (rl_norm_device): half of the H100's 228 KB of shared memory per SM
# less the runtime's 1 KB per block, and half of 164 KB per SM.
CLUSTER_SMEM = {H100: 233472 // 2 - 1024, GRIDS[1]: 167936 // 2 - 1024}

# The r3centered calls of a shape: (x's inputs, dy's bytes, sums per
# (b, c), float32 output) of K2 without and with affine, K2b without
# affine (bf16 dy) and at an affine call site (float32 dy).
R3_CALLS = ((1, None, 2, False), (1, None, 2, True), (2, None, 2, False),
            (2, 4, 4, False))
# The path of each on the H100 (the key of
# test_cluster_plan_covers_every_element_once).  Every slab of 80x120
# pixels or fewer takes the cluster path; the 160x240 and 320x480 ones
# keep the grid path.
R3_PATHS_H100 = {shape: ("grid",) * 4 for shape in (
    (7, 320, 480, 32), (7, 320, 480, 16), (7, 160, 240, 64),
    (7, 160, 240, 32), (4, 320, 480, 32), (4, 160, 240, 64),
    (4, 320, 480, 16), (4, 160, 240, 32))}


def _check_cluster_plan(shape, n_inputs, dy_itemsize, n_sums, out_f32,
                        grid):
    """The plan of an r3centered call with the cluster path allowed: on
    the cluster path every (b, c, pixel) lies in exactly one block (the
    kernel's struct CBlock), a cluster has 1-8 blocks, every block has
    pixels, and the shared memory a block needs is what the plan
    reserves, within the card's budget."""
    B, H, W, C = shape
    n_px = H * W
    csmem = CLUSTER_SMEM[grid]
    p = norm_kernel._plan(B, n_px, C, 2, n_inputs, *grid,
                          dy_itemsize=dy_itemsize, n_sums=n_sums,
                          cluster_smem=csmem, out_f32=out_f32)
    if p["path"] == "grid":
        return p
    G, k, rows = p["group"], p["cluster"], p["rows_per_block"]
    assert G in (16, 32, 64, 128) and C % G == 0
    assert 1 <= k <= 8
    assert rows * k >= n_px and rows <= norm_kernel._C_MAX_ROWS
    threads = 256 if n_inputs == 2 or out_f32 else 512
    assert p["threads"] == threads
    assert p["smem"] == norm_kernel._cluster_smem(rows, G, n_inputs == 2,
                                                  n_sums, k, threads)
    assert p["smem"] <= csmem
    ng = C // G
    assert p["grid"] == B * ng * k and p["slabs"] == B * ng
    cover = np.zeros((B, ng, n_px), np.int16)
    for blk in range(p["grid"]):        # the kernel's struct CBlock
        s, rank = divmod(blk, k)
        p0 = rank * rows
        nr = max(0, min(n_px, p0 + rows) - p0)
        assert nr > 0
        cover[s // ng, s % ng, p0:p0 + nr] += 1
    np.testing.assert_array_equal(cover, 1)
    return p


@pytest.mark.parametrize("shape", SERVE_SHAPES + TRAIN_SHAPES)
def test_cluster_plan_covers_every_element_once(shape):
    """``_plan``'s cluster path at every bf16 main-path shape, forward
    (bf16 and float32 output) and backward (bf16 dy; float32 dy with
    four sums), on both cards; on the H100 the path of each call is the
    one ``R3_PATHS_H100`` lists (the cluster path where it lists
    nothing)."""
    for grid in GRIDS:
        paths = tuple(_check_cluster_plan(shape, *call, grid)["path"]
                      for call in R3_CALLS)
        if grid == H100:
            assert paths == R3_PATHS_H100.get(shape, ("cluster",) * 4)


def test_cluster_plan_main_path_counts():
    """On the H100 the cluster path takes 108 of a bf16 standard clip's
    162 r3centered forwards, 312 of a bf16 step's 380 and 228 of its 276
    backwards (the calls per clip and step that chip_smoke.py phases R
    and B2 hold the main path to, by shape)."""
    serve = {}
    for (shape, _, _), n in CS.R3_CLIP_CALLS.items():
        serve[shape] = serve.get(shape, 0) + n
    assert set(serve) == set(SERVE_SHAPES)
    on_cluster = lambda shape, i: (
        R3_PATHS_H100.get(shape, ("cluster",) * 4)[i] == "cluster")
    assert sum(serve.values()) == 162
    assert sum(n for s, n in serve.items() if on_cluster(s, 0)) == 108
    for shape in serve:
        for i in (0, 1):
            assert _check_cluster_plan(shape, *R3_CALLS[i], H100)["path"] \
                == ("cluster" if on_cluster(shape, i) else "grid")
    # per training step: (forwards, backwards without and with affine)
    step = {}
    for calls, i in ((CS.R3_STEP_FWD_CALLS, 0), (CS.R3_STEP_BWD_CALLS, 1)):
        for (shape, affine, _), n in calls.items():
            f = step.setdefault(shape, [0, 0, 0])
            f[i + (i and affine)] += n
    assert set(step) == set(TRAIN_SHAPES)
    assert sum(f for f, _, _ in step.values()) == 380
    assert sum(b + a for _, b, a in step.values()) == 276
    assert sum(f for s, (f, _, _) in step.items() if on_cluster(s, 0)) == 312
    assert sum(b * on_cluster(s, 2) + a * on_cluster(s, 3)
               for s, (_, b, a) in step.items()) == 228


def test_dparams_summed_in_batch_order():
    """The cluster path's dgamma/dbeta: the slabs' sums added over b in
    batch order (``batch_order_sums``, the kernel's tail), whichever
    slab finishes last: left to right in float32, bit for bit, on sums
    where the order changes the result."""
    rng = np.random.default_rng(14)
    B, C = 8, 48
    table = (rng.normal(size=(B, 2, C))
             * 10.0 ** rng.integers(-4, 8, size=(B, 2, C))).astype(np.float32)
    dbeta, dgamma = norm_kernel.batch_order_sums(torch.from_numpy(table))
    want = np.zeros((2, C), np.float32)
    for b in range(B):
        want = want + table[b]
    np.testing.assert_array_equal(dbeta.numpy(), want[0])
    np.testing.assert_array_equal(dgamma.numpy(), want[1])
    other = np.zeros((2, C), np.float32)
    for b in reversed(range(B)):
        other = other + table[b]
    assert (other != want).any()    # the data tells the orders apart
