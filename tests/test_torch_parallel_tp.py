"""Tensor-parallel splitting in the PyTorch port
(``renderloom_torch/parallel/mesh.py:shard_params_tp``) against the JAX
package's ``shard_params_tp`` over the ``model`` axis of a 4×2 mesh of
the tier-1 run's 8 CPU devices (tests/conftest.py), on the serving
generator of tests/test_torch_parallel_serve.py's tiny config at 32×48
(``chip_smoke.tp_run``, which phase TP runs on the card at full width):
the same leaves are split, and one forward at B = 2 on two spawned gloo
ranks equals world 1 and JAX's forward on the same weights.

Each rank's gradient of a split weight is its slice of world 1's.

Tolerances, float32, of the output's (or gradient's) largest magnitude:
world 2 against world 1 1e-5 (each split conv computes half the output
channels; on the CPU each channel's sum is the same whatever the split:
reading 0);
world 1 against JAX 1e-4, as tests/test_torch_parallel_serve.py holds
the generator's rollout (convolutions summed in another order than
XLA's: reading 1.09e-5 on the image, 1e-5 would not hold it).
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke as CS
import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import generator_trees, single_thread  # noqa: F401
from renderloom.parallel import make_mesh
from renderloom.parallel import shard_params_tp as jax_shard
from renderloom.train import gan as JG
from renderloom_torch.parallel import mesh
from test_torch_parallel_serve import H, W, cfg

MIN_ELEMS = 256                 # tests/test_parallel_tp.py's
B, SEED = 2, 7


@pytest.fixture(scope="module")
def runs():
    trees = generator_trees(cfg(JC), H, W, seed=4)
    one = CS.tp_run(cfg(TC), trees, B, SEED, "cpu", MIN_ELEMS, True)
    two = mesh.run_ranks(CS.tp_run, 2, "cpu",
                         args=(cfg(TC), trees, B, SEED, "cpu", MIN_ELEMS,
                               True))
    return trees, one, two


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_split_leaves_equal_jax(runs):
    trees, _, two = runs
    _, folded = JG.make_inference_pair(cfg(JC), *trees)
    sharded = jax_shard(make_mesh(data=4, model=2), folded,
                        min_elems=MIN_ELEMS)
    want = sorted(
        "/".join(str(k.key) for k in path)
        for path, leaf in jax.tree_util.tree_flatten_with_path(sharded)[0]
        if not leaf.sharding.is_fully_replicated)
    got = sorted(n[:-len(".weight")].replace(".", "/") + "/kernel"
                 for n in two[0]["split"])
    assert got == want and len(got) > 20
    assert two[1]["split"] == two[0]["split"]


@pytest.mark.parametrize("part", ["img", "mask"])
def test_world_2_equals_world_1_and_jax(runs, part):
    trees, one, two = runs
    assert one["world"] == 1 and [r["world"] for r in two] == [2, 2]
    assert one["split"] == []
    gen, folded = JG.make_inference_pair(cfg(JC), *trees)
    x = CS.tp_inputs(B, H, W, SEED)
    want = jax.jit(lambda p, *a: gen.apply({"params": p}, *a))(folded, *x)
    want = np.asarray(want[0 if part == "img" else 1])
    for r in two:
        assert r[part].shape == one[part].shape == want.shape
        assert _rel(r[part], one[part]) <= 1e-5
    print(f"{part}: world 2 vs 1 {[_rel(r[part], one[part]) for r in two]}, "
          f"world 1 vs JAX {_rel(one[part], want):.3e}")
    assert _rel(one[part], want) <= 1e-4


def test_gradients_equal_world_1(runs):
    """Each rank's gradient of a split weight is its slice of world 1's
    gradient (not the world size times it); a whole weight's is world
    1's."""
    _, one, two = runs
    split = set(two[0]["split"])
    for rank, r in enumerate(two):
        assert r["grads"].keys() == one["grads"].keys()
        for name, want in one["grads"].items():
            if name in split:
                n = want.shape[0] // 2
                want = want[rank * n:(rank + 1) * n]
            got = r["grads"][name]
            assert got.shape == want.shape, name
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), \
                name


def test_ranks_hold_their_slices(runs):
    _, one, two = runs
    full, kept = one["bytes"][0], [r["bytes"][1] for r in two]
    assert one["bytes"] == (full, full)
    assert kept[0] == kept[1] and full / 2 < kept[0] < full


def test_group_of_size_one_is_a_no_op():
    from renderloom_torch.train.gan import make_inference_pair

    gen = make_inference_pair(cfg(TC), None, None, "cpu")
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    mesh.shard_params_tp(gen, min_elems=MIN_ELEMS)       # no process group
    assert mesh.tp_split(gen) == []
    mesh.init(0, 1, f"tcp://localhost:{mesh._free_port()}", "cpu")
    try:
        mesh.shard_params_tp(gen, min_elems=MIN_ELEMS)
        assert mesh.tp_split(gen) == []
    finally:
        mesh.shutdown()
    after = gen.state_dict()
    assert before.keys() == after.keys()
    assert all(torch.equal(before[k], after[k]) for k in before)
