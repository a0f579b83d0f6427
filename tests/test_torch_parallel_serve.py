"""Data-parallel serving of the PyTorch port on the CPU over gloo: the
segment rollout with the clip batch split over two spawned ranks
(``chip_smoke.dp_serve_run``, which phase J runs on the card at full
width: the generator replicated, each rank's contiguous block of clips,
``parallel.mesh.gather_batch`` back in clip order) against world 1 and
against the JAX package's rollout, at tests/test_parallel_infer.py's
configuration (32×48, rate 2, 3 keyframes, B = 8, the same random
prepared batch).

Tolerances, float32: world 2 against world 1 1e-5 of the frames'
largest magnitude (each rank runs half the batch; on the CPU the
convolutions and the norm twins give each clip the same result whatever
its batch); against JAX 1e-4, as tests/test_torch_rollouts.py holds the
rollouts (convolutions summed in another order than XLA's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import generator_trees, single_thread  # noqa: F401
from renderloom.train import gan as JG
from renderloom_torch.parallel import mesh

H, W, RATE, K, B = 32, 48, 2, 3, 8


def cfg(C):
    """tests/test_parallel_infer.py's renderer config."""
    return C.RendererConfig(gen=C.GeneratorConfig(
        num_filters=4, max_num_filters=16, num_layers=6,
        num_downsamples=4, do_checkpoint=False,
        mask=C.MaskNetConfig(num_filters=4, max_num_filters=16,
                             num_downsamples=3, num_res_blocks=1),
        embed=C.EmbedConfig(num_filters=4, max_num_filters=16,
                            num_downsamples=4)),
        data=C.RendererDataConfig(model_width=W, model_height=H,
                                  load_width=W, load_height=H))


def batch():
    rng = np.random.default_rng(0)
    L = (K - 1) * RATE + 1
    return {k: rng.uniform(-1, 1, (B, L, H, W, c)).astype(np.float32)
            for k, c in (("label", 22), ("back", 3), ("key_img", 3))}


@pytest.fixture(scope="module")
def runs():
    trees = generator_trees(cfg(JC), H, W, seed=4)
    clips = batch()
    gen, folded = JG.make_inference_pair(cfg(JC), *trees)
    want = JG.make_segment_rollout(gen, cfg(JC), RATE)(
        folded, {}, {k: jnp.asarray(v) for k, v in clips.items()})
    one = CS.dp_serve_run(cfg(TC), trees, clips, RATE, "cpu")
    two = mesh.run_ranks(CS.dp_serve_run, 2, "cpu",
                         args=(cfg(TC), trees, clips, RATE, "cpu"))
    return [np.asarray(w) for w in want], one, two


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("part", [0, 1])
def test_world_2_equals_world_1(runs, part):
    _, one, two = runs
    key = ("fused", "masks")[part]
    assert [r["world"] for r in two] == [2, 2] and one["world"] == 1
    assert [r["local"] for r in two] == [B // 2] * 2 and one["local"] == B
    assert "fused" not in two[1]            # only rank 0 keeps the gather
    assert two[0][key].shape == one[key].shape
    assert _rel(two[0][key], one[key]) <= 1e-5


@pytest.mark.parametrize("part", [0, 1])
def test_world_2_equals_jax(runs, part):
    want, _, two = runs
    got = two[0][("fused", "masks")[part]]
    assert got.shape == want[part].shape
    assert _rel(got, want[part]) <= 1e-4


def test_replicate_makes_every_rank_rank_0s():
    """Without weights each rank draws its own (seed 1 + rank), so rank
    1's clips come out right only through ``replicate``; the raw clips
    are prepared on each rank (the K1 twin)."""
    spec = (4, (K - 1) * RATE + 1, H, W, 5)
    one = CS.dp_serve_run(cfg(TC), None, spec, RATE, "cpu")
    two = mesh.run_ranks(CS.dp_serve_run, 2, "cpu",
                         args=(cfg(TC), None, spec, RATE, "cpu"))
    for key in ("fused", "masks"):
        assert _rel(two[0][key], one[key]) <= 1e-5
    assert np.isfinite(one["fused"]).all()


def test_gather_batch_without_a_group_is_the_identity():
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.gather_batch(x) is x
