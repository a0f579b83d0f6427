"""Data-parallel training of the port (``renderloom_torch/parallel``) on
the CPU over gloo.

* Both train steps at world size 2, two spawned processes each taking
  its block of the global batch, against world size 1 on the same
  global batches and weights (``chip_smoke.dp_gan_run`` /
  ``dp_motion_run``, which phase Z runs on the card at full width): the
  GAN step at 64×96, B = 2, L = 3 with four discriminators and the hand
  crops' weights; the motion step at hidden 32, 2+2 layers, L 33, B 4,
  dropout 0, with pad masks that differ per sample.  Tolerances
  (``chip_smoke.dp_hold``): every metric, ``grad_norm`` included, to
  1e-6 relative; the parameters after 2 steps to 1e-6, but for the
  elements AMSGrad moves by ±lr from a rounding difference (a gradient
  below 1e-6, or a leaf whose gradient vanishes in exact arithmetic),
  held to 2·lr per update and at most 2% (G, motion) or 5% (D) of a
  network's elements.  Measured: metrics 2.3e-7, parameters 9.3e-8;
  472 of G's 84,268, 96 of D's 12,572 and 55 of the motion model's
  45,382 elements beyond 1e-6.
* ``gan_lr0`` also runs phase Z's witnesses: world 2 as two threads of
  one process (``chip_smoke._ThreadWorld``) equals the gloo world 2 bit
  for bit here, and the planted faults (no gradient mean; each rank's
  own counts) fail the hold.
* ``process_shard`` against the JAX package's; an uneven split raises;
  ``torchrun``'s environment at world size 1 trains as without it.
* Both training CLIs at world size 2 over gloo, one epoch on a tiny h5:
  the ranks read disjoint samples and take the same steps, end with the
  same parameters, and only rank 0 writes the metrics, the checkpoint
  and the evaluation; ``rank_zero_first`` orders the ranks.
"""

import dataclasses
import json
import os
import socket
import time
from collections import Counter

import numpy as np
import pytest
import torch

import chip_smoke as CS
from _torch_parity import (single_thread, write_amass_h5,  # noqa: F401
                           write_hsm_h5)
from renderloom.parallel import process_shard as jax_process_shard
from renderloom_torch.cli import train_motion, train_renderer
from renderloom_torch.core import config as C
from renderloom_torch.parallel import mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _motion_cfg():
    return dataclasses.replace(C.MotionConfig(
        transformer=C.TransformerConfig(hidden_dim=32, nheads=4,
                                        dim_feedforward=64, enc_layers=2,
                                        dec_layers=2, dropout=0.0),
        pos_encode=C.PosEncodeConfig(hidden_dim=32),
        dataset=C.MotionDatasetConfig(max_seq_length=33, train_sample_rate=8,
                                      train_sample_size=8, noise_rate=2,
                                      joint_drop_rate=2, flip_rate=1)),
        batch_size=4)


@pytest.mark.parametrize("model", ["motion", "gan", "gan_lr0"])
def test_world_2_step_matches_world_1(model, monkeypatch):
    """``gan_lr0`` is the hold phase Z puts on the card's GAN step (whose
    backward there is not reproducible to the bit): learning rates 0,
    every metric, and the first moments within 3e-3 of their largest
    (measured here 2.3e-6 G, 7.0e-6 D)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the spawned ranks
    if model == "motion":
        cfg = _motion_cfg()
        args = (cfg, *CS._dp_motion_case(cfg, CS.DP_CHECK_AFTER))
        run, lrs = CS.dp_motion_run, {"m": cfg.optim.lr}
    else:
        cfg = CS._tiny_train_cfg()
        if model == "gan_lr0":
            cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
                cfg.optim, lr=0.0, lr_d=0.0))
        args = (cfg, CS._dp_gan_raws(cfg, CS.DP_CHECK_AFTER))
        run, lrs = CS.dp_gan_run, {"g": cfg.optim.lr, "d": cfg.optim.lr_d}
    one = run(*args, "cpu")
    two = mesh.run_ranks(run, 2, "cpu", args=args + ("cpu",))
    assert one["world"] == 1 and [r["world"] for r in two] == [2, 2]
    held = (CS.dp_hold_gradients(model, one, two) if model == "gan_lr0"
            else CS.dp_hold(model, one, two, lrs))
    assert held["metrics_rel"] <= CS.DP_RTOL
    if model == "gan_lr0":
        seen = CS._dp_witnesses(*args, one, two, device="cpu")
        assert seen["threads_vs_gloo"]["metrics_rel"] == 0.0
        assert max(seen["threads_vs_gloo"]["moments_rel"].values()) == 0.0
        assert not seen["local counts"]["metrics_ok"]


@pytest.mark.parametrize("n,index,count", [(10, None, None), (10, 1, 3),
                                           (7, 2, 4), (0, 0, 2), (5, 4, 5)])
def test_process_shard_matches_jax(n, index, count):
    np.testing.assert_array_equal(mesh.process_shard(n, index, count),
                                  jax_process_shard(n, index, count))


def test_uneven_split_raises(monkeypatch):
    monkeypatch.setattr(mesh, "world", lambda: (1, 3))
    with pytest.raises(ValueError, match="does not split evenly"):
        mesh.shard_batch({"x": np.zeros((4, 2))})
    with pytest.raises(ValueError, match="does not split evenly"):
        mesh.local_batch(16)
    draws = {"w": np.arange(6), "f": np.arange(18)}     # B = 6, B·F = 18
    got = mesh.shard_batch(draws, 6)
    np.testing.assert_array_equal(got["w"], [2, 3])
    np.testing.assert_array_equal(got["f"], np.arange(6, 12))


def test_init_from_env_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.init_from_env("cuda")


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _lines(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in f]


@pytest.mark.parametrize("cli", ["motion", "renderer"])
def test_cli_under_torchrun_env_at_world_1(cli, tmp_path, monkeypatch,
                                           capsys):
    """``torchrun --nproc_per_node=1``'s environment: the CLI joins a
    gloo group of one (and leaves it), prints its world, and trains as
    without it, to the bit."""
    if cli == "motion":
        module, args = train_motion, [
            "--synthetic", "--config",
            os.path.join(ROOT, "configs", "smoke_motion.yaml"),
            "--steps-per-epoch", "2"]
    else:
        module, args = train_renderer, [
            "--synthetic", "--config",
            os.path.join(ROOT, "configs", "smoke_hsm.yaml"), "--height",
            "64", "--width", "96", "--batch-size", "1",
            "--steps-per-epoch", "1"]
    monkeypatch.setattr(module, "TRAIN_LOG_EVERY", 1)
    args += ["--device", "cpu", "--epochs", "1", "--seed", "3"]
    plain = str(tmp_path / "plain")
    module.main(args + ["--out-dir", plain])
    assert "world:" not in capsys.readouterr().out
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)
    run = str(tmp_path / "torchrun")
    module.main(args + ["--out-dir", run])
    assert "world: 1 backend: gloo" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
    assert _lines(run) == _lines(plain)
    a = torch.load(os.path.join(plain, "checkpoint.pt"))
    b = torch.load(os.path.join(run, "checkpoint.pt"))
    for key in [k for k in a if k.startswith("opt")]:
        assert torch.equal(a[key]["flat"], b[key]["flat"])


def _zero_first_rank(path):
    from renderloom_torch.parallel import rank_zero_first

    rank = mesh.world()[0]
    with rank_zero_first():
        if rank == 0:
            time.sleep(0.5)
            with open(path, "w") as f:
                f.write("rank 0")
        with open(path) as f:
            return f.read()


def test_rank_zero_first_orders_the_ranks(tmp_path):
    path = str(tmp_path / "cache.txt")
    assert mesh.run_ranks(_zero_first_rank, 2, "cpu", args=(path,)) == \
        ["rank 0", "rank 0"]


def _cli_rank(cli, argv):
    """One rank of a training CLI's run: the samples it read in its
    epochs, its steps, what it wrote and its final parameters."""
    from renderloom_torch.data.amass import AmassReader
    from renderloom_torch.data.hsm import HsmReader
    from renderloom_torch.eval.motion_eval import MotionEvaluator

    module = train_motion if cli == "motion" else train_renderer
    reader, method = ((AmassReader, "read_motion") if cli == "motion"
                      else (HsmReader, "read_window"))
    reads, wrote, phase = [], Counter(), ["setup"]

    def wrap(owner, name, before=None):
        real = getattr(owner, name)

        def call(*a, **kw):
            wrote[name] += 1
            if before:
                phase[0] = before
            return real(*a, **kw)
        setattr(owner, name, call)

    read = getattr(reader, method)
    setattr(reader, method, lambda self, *a: (reads.append((phase[0], a)),
                                              read(self, *a))[1])
    for name in ("MetricLogger", "save_checkpoint"):
        wrap(module, name)
    if cli == "motion":
        wrap(MotionEvaluator, "evaluate", "eval")
    real_step = module.make_train_step if cli == "motion" else \
        module.make_gan_train_step

    def make_step(*a, **kw):
        phase[0] = "train"
        return real_step(*a, **kw)
    setattr(module, real_step.__name__, make_step)
    module.TRAIN_LOG_EVERY = 1
    res = module.main(argv)
    opt = res["state"].opt if cli == "motion" else res["state"].opt_g
    return dict(reads=[a for p, a in reads if p == "train"],
                steps=[e["steps"] for e in res["epochs"]],
                wrote=dict(wrote), flat=opt.flat.numpy().copy(),
                step=res["state"].step)


@pytest.mark.parametrize("cli", ["motion", "renderer"])
def test_cli_at_world_2(cli, tmp_path, monkeypatch):
    """One epoch of each training CLI at world size 2 (gloo, two spawned
    ranks) on a tiny h5, as ``torchrun --nproc_per_node=2`` runs it: a
    global batch of 2, one sample a rank a step."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the spawned ranks
    out = str(tmp_path / "run")
    if cli == "motion":
        h5 = write_amass_h5(str(tmp_path / "amass.h5"),
                            {"CMU": (40, 25, 70), "KIT": (36,),
                             "HumanEva": (45, 20), "SFU": (50,)})
        with open(os.path.join(ROOT, "configs", "smoke_motion.yaml")) as f:
            text = f.read().replace("eval_step: 1000", "eval_step: 1")
        cfg = tmp_path / "motion.yaml"
        cfg.write_text(text + f"\ndata_root: {tmp_path / 'data'}\n")
        argv = ["--h5", h5, "--config", str(cfg)]
        n_samples = 4                           # CMU and KIT: 2 steps
    else:
        h5 = write_hsm_h5(str(tmp_path / "hsm.h5"), {"clip_a": 4,
                                                      "clip_b": 5}, 48, 72,
                          seed=1, phases=("train",))
        with open(os.path.join(ROOT, "configs", "smoke_hsm.yaml")) as f:
            text = f.read()
        cfg = tmp_path / "hsm.yaml"
        cfg.write_text(text.replace(
            "  eval_frames: 3", "  eval_frames: 3\n"
            "  train_video_list: [clip_a, clip_b]\n"
            "  test_video_list: []"))
        argv = ["--h5", h5, "--config", str(cfg), "--height", "64",
                "--width", "96", "--allow-random-vgg"]
        n_samples = None
    argv += ["--device", "cpu", "--epochs", "1", "--seed", "3",
             "--out-dir", out]
    ranks = mesh.run_ranks(_cli_rank, 2, "cpu", args=(cli, argv))
    a, b = ranks
    assert a["steps"] == b["steps"] == [2] and a["step"] == b["step"] == 2
    assert set(a["reads"]).isdisjoint(b["reads"])
    assert min(len(r["reads"]) for r in ranks) >= 2
    if n_samples:
        assert len(set(a["reads"]) | set(b["reads"])) == n_samples
    np.testing.assert_array_equal(a["flat"], b["flat"])
    assert a["wrote"]["MetricLogger"] == a["wrote"]["save_checkpoint"] == 1
    assert "MetricLogger" not in b["wrote"] and \
        "save_checkpoint" not in b["wrote"]
    if cli == "motion":
        assert a["wrote"]["evaluate"] == 1 and "evaluate" not in b["wrote"]
    train = [r for r in _lines(out) if any(k.startswith("train/")
                                           for k in r)]
    assert [r["step"] for r in train] == [1, 2]
    assert os.path.exists(os.path.join(out, "checkpoint.pt"))
