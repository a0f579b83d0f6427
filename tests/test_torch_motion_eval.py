"""``MotionEvaluator`` of the PyTorch port
(``renderloom_torch/eval/motion_eval.py``) against the JAX package's on
the same weights and a tiny AMASS h5: the metrics to 1e-5 relative with
``evaluate_noise`` off, and on, with each sample's corruption draws
taken from JAX's ``fold_in(PRNGKey(0), i)`` (the port's evaluator draws
from a generator seeded i; the test replaces ``drop_draws``).  Batches
of 3 over 5 samples: a full batch and a short last one, clips shorter
and longer than ``max_seq_length``.
"""

import dataclasses

import h5py
import jax
import numpy as np
import pytest
import torch

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import (jax_random_drop_draws, motion_cfg,  # noqa: F401
                           motion_tree, single_thread, write_amass_h5)
from renderloom.data.amass import AmassReader as JReader
from renderloom.eval import motion_eval as JE
from renderloom.models.motion_transformer import build_motion_model
from renderloom_torch import convert
from renderloom_torch.data.amass import AmassReader as TReader
from renderloom_torch.eval import motion_eval as TE
from renderloom_torch.models import motion_transformer as TM

GROUPS = {"HumanEva": (40, 25, 70), "SFU": (33, 52)}


def cfg_of(C, noise):
    c = motion_cfg(C)
    return dataclasses.replace(c, dataset=C.MotionDatasetConfig(
        max_seq_length=33, test_sample_rate=8, noise_rate=2,
        joint_drop_rate=2, flip_rate=1, evaluate_noise=noise,
        test_split=("HumanEva", "SFU")))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("meval")
    h5 = write_amass_h5(str(root / "j.h5"), GROUPS, seed=1)
    rng = np.random.default_rng(2)
    mean = rng.normal(scale=0.1, size=(19, 2)).astype(np.float32)
    std = rng.uniform(0.2, 1.0, (19, 2)).astype(np.float32)
    return root, h5, mean, std, motion_tree(motion_cfg(JC), seed=3)


@pytest.mark.parametrize("noise", [False, True])
def test_evaluator_matches_jax(setup, noise):
    root, h5, mean, std, tree = setup
    views = str(root / f"views_{noise}.npy")
    jcfg, tcfg = cfg_of(JC, noise), cfg_of(TC, noise)
    split = jcfg.dataset.test_split
    jev = JE.MotionEvaluator(jcfg, JReader(h5, split), mean, std, views)
    tev = TE.MotionEvaluator(tcfg, TReader(h5, split), mean, std, views)
    np.testing.assert_array_equal(tev.views, jev.views)
    tev.drop_draws = lambda i, J, D, L: {
        k: torch.from_numpy(v)[None] for k, v in jax_random_drop_draws(
            jax.random.fold_in(jax.random.PRNGKey(0), i), J, D, L,
            tev.rate).items()}
    want = jev.evaluate(build_motion_model(jcfg), tree, batch_size=3)
    model = convert.load_flax_params(TM.build_motion_model(tcfg),
                                     tree).eval()
    dump = str(root / f"dump_{noise}.h5")
    got = tev.evaluate(model, batch_size=3, dump_h5=dump)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    with h5py.File(dump, "r") as f:
        assert sorted(f) == ["HumanEva", "SFU"]
        grp = f["HumanEva/m2"]                 # 70 frames: center crop
        assert grp["pred"].shape == grp["gt"].shape == (19, 2, 33)
        assert f["HumanEva/m1"]["interp"].shape == (19, 2, 17)   # 25 → 17
    limited = tev.evaluate(model, limit=2, batch_size=3)
    assert limited != got


def test_views_relocate_and_metrics_match_jax(tmp_path):
    path = str(tmp_path / "sub" / "views.npy")
    got = TE.load_or_create_views(path, (0.2, 0.0, 1.0), n=7)
    np.testing.assert_array_equal(got, JE.load_or_create_views(
        str(tmp_path / "v2.npy"), (0.2, 0.0, 1.0), n=7))
    np.testing.assert_array_equal(TE.load_or_create_views(path, ()), got)
    rng = np.random.default_rng(0)
    gt, pred, interp = (rng.normal(size=(19, 2, 9)).astype(np.float32)
                        for _ in range(3))
    np.testing.assert_array_equal(TE.relocate(gt, 8), JE.relocate(gt, 8))
    assert TE.global_metrics(gt, pred, interp) == \
        JE.global_metrics(gt, pred, interp)


def test_eval_step_matches_jax(setup):
    """``make_eval_step``: the deterministic forward on a synthesized
    batch, (B, C, L) in and out."""
    from renderloom.train.motion import make_eval_step as jax_eval_step
    from renderloom_torch.train.motion import make_eval_step

    _, _, mean, std, tree = setup
    rng = np.random.default_rng(5)
    batch = {"input": rng.normal(size=(2, 38, 17)).astype(np.float32),
             "interp": rng.normal(size=(2, 38, 17)).astype(np.float32),
             "src_mask": (np.arange(17) % 4 != 0)[None].repeat(2, 0),
             "mask": np.zeros((2, 17), bool)}
    batch["mask"][1, 13:] = True
    batch["src_mask"] |= batch["mask"]
    jcfg = cfg_of(JC, False)
    want = jax_eval_step(build_motion_model(jcfg), jcfg, mean, std, 4)(
        tree, batch)
    model = convert.load_flax_params(TM.build_motion_model(cfg_of(TC, False)),
                                     tree)
    got = make_eval_step(4)(model, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    for g, w in zip(got, want):
        assert g.shape == (2, 38, 17)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
