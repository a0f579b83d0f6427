"""The port's serving export (``renderloom_torch/eval/export.py``) on the
CPU at tests/test_export.py's sizes (64×96, rate 2, 3 keyframes): the
float32 pipeline on numpy-seeded weights, exported with ``torch.export``,
saved, and loaded and served by a fresh process that imports none of
the port's models, configs or checkpoints.

* the frozen frames equal the live pipeline's bit for bit;
* they equal the JAX package's ``build_pipeline`` + ``export_pipeline``
  + ``load_exported`` frames on the same weights within
  tests/test_torch_pipeline.py's 1e-4 (float32 through the motion
  transformer, LK flow, the raster and the generator, summed in other
  orders than XLA's);
* the meta has the JAX meta's keys, ``device`` in place of ``platforms``;
* the program calls K1, K2 and the fused upsample-and-convolution of
  the mask net's up blocks through the registered operators, as often
  as the live pipeline launches them;
* an artifact for the CUDA device refuses to load without one;
* both operators pass ``torch.library.opcheck`` (schema, fake tensor,
  autograd registration, AOT dispatch) at their layouts and modes.

The export CLI's run is tests/test_torch_export_cli.py.
"""

import json
import os
import subprocess
import sys
import zipfile
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import (blobs, generator_trees, motion_cfg,  # noqa: F401
                           motion_tree, renderer_cfg, single_thread, t)
from renderloom_torch.eval.export import (export_pipeline, load_exported,
                                          save_exported)
from renderloom_torch.eval.pipeline import build_pipeline
from renderloom_torch.models.layers import InstanceNorm, Spade
from renderloom_torch.ops import rasterize_kernel as RK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 96
RATE, K = 2, 3

# the loaded program may import the operators' modules and what they
# import, nothing of the models, configs, checkpoints or the live pipeline
FORBIDDEN = ("renderloom_torch.models", "renderloom_torch.core",
             "renderloom_torch.eval.pipeline", "renderloom_torch.train",
             "renderloom_torch.data", "renderloom_torch.convert")

_CHILD = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from renderloom_torch.eval.export import load_exported
serve, meta = load_exported(sys.argv[2])
inputs = np.load(sys.argv[3])
fused, sync = serve(inputs["motion"], inputs["conf"], inputs["keys"])
np.save(sys.argv[4], fused.numpy())
print(json.dumps({"meta": meta, "sync": float(sync),
                  "modules": sorted(m for m in sys.modules
                                    if m.startswith(("renderloom", "jax")))}))
"""


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The weights and inputs of tests/test_torch_pipeline.py (one clip),
    the live port pipeline's frames, and the exported program."""
    jm, jr = motion_cfg(JC), renderer_cfg(JC, H, W)
    m_params = motion_tree(jm, seed=3)
    g_params, g_stats = generator_trees(jr, H, W, seed=4)
    rng = np.random.default_rng(0)
    motion = np.stack([rng.uniform(-0.9, -0.7, (1, 19, K)),
                       rng.uniform(-0.9, -0.8, (1, 19, K))], axis=2)
    mean = np.zeros((19, 2), np.float32)
    mean[-1] = (-0.8, -0.85)
    weights = dict(m_params=m_params, g_params=g_params, g_stats=g_stats,
                   mean=mean, std=np.full((19, 2), 0.02, np.float32))
    inputs = {"motion": motion.astype(np.float32),
              "conf": np.full((1, 19, 1, K), 0.9, np.float32),
              "keys": blobs(K, H, W)[None].astype(np.float32)}
    fn, m_model, gen = build_pipeline(motion_cfg(TC), renderer_cfg(TC, H, W),
                                      RATE, K, device="cpu", **weights)
    norm_calls = sum(isinstance(m, (InstanceNorm, Spade))
                     for m in gen.modules()) * (RATE - 1)
    upconv_calls = gen.mask_net.num_downsamples * (RATE - 1)
    live, _ = fn(*(t(inputs[k]) for k in ("motion", "conf", "keys")))
    ep, meta = export_pipeline(fn, m_model, gen, 1, K, H, W, RATE, "cpu")
    tmp = tmp_path_factory.mktemp("export")
    path = str(tmp / "pipeline.pt2")
    nbytes = save_exported(path, ep, meta)
    return dict(weights=weights, inputs=inputs, live=live.numpy(), ep=ep,
                meta=meta, path=path, nbytes=nbytes, tmp=tmp,
                norm_calls=norm_calls, upconv_calls=upconv_calls)


@pytest.fixture(scope="module")
def frozen(case):
    """The artifact served by a fresh process."""
    tmp = case["tmp"]
    np.savez(tmp / "inputs.npz", **case["inputs"])
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, ROOT, case["path"],
         str(tmp / "inputs.npz"), str(tmp / "fused.npy")],
        capture_output=True, text=True, timeout=600, check=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    report = json.loads(out.stdout.strip().splitlines()[-1])
    return dict(report, fused=np.load(tmp / "fused.npy"))


def test_frozen_equals_live_bit_for_bit_in_a_fresh_process(case, frozen):
    assert case["nbytes"] == os.path.getsize(case["path"])
    assert frozen["meta"] == case["meta"]
    assert frozen["fused"].shape == (1, (K - 1) * RATE + 1, H, W, 3)
    np.testing.assert_array_equal(frozen["fused"], case["live"])
    assert np.isfinite(frozen["sync"])
    bad = [m for m in frozen["modules"]
           if m.startswith(FORBIDDEN) or m.split(".")[0] in ("jax",
                                                             "renderloom")]
    assert not bad, bad
    assert "renderloom_torch.ops.norm_kernel" in frozen["modules"]


def test_frozen_matches_the_jax_artifact(case, frozen, tmp_path):
    from renderloom.eval.export import export_pipeline as jax_export
    from renderloom.eval.export import load_exported as jax_load
    from renderloom.eval.export import save_exported as jax_save
    from renderloom.eval.pipeline import build_pipeline as jax_build

    fn, mp, gp = jax_build(motion_cfg(JC), renderer_cfg(JC, H, W), RATE, K,
                           platform="cpu", **case["weights"])
    exported, jmeta = jax_export(fn, mp, gp, 1, K, H, W, RATE, ["cpu"])
    jax_save(str(tmp_path / "jax.rlx"), exported, jmeta)
    serve, _ = jax_load(str(tmp_path / "jax.rlx"))
    want = np.asarray(serve(*(jnp.asarray(case["inputs"][k])
                              for k in ("motion", "conf", "keys")))[0])
    np.testing.assert_allclose(frozen["fused"], want, rtol=0, atol=1e-4)
    meta = case["meta"]
    assert set(meta) == set(jmeta) - {"platforms"} | {"device"}
    assert meta["device"] == "cpu"
    for k in set(jmeta) - {"platforms"}:
        assert meta[k] == jmeta[k], k


def test_program_calls_the_kernels_as_the_live_pipeline_launches(case):
    calls = Counter(str(node.target)
                    for mod in case["ep"].graph_module.modules()
                    if isinstance(mod, torch.fx.GraphModule)
                    for node in mod.graph.nodes
                    if str(node.target).startswith("renderloom"))
    assert calls == {"renderloom.rasterize.default": 1,
                     "renderloom.instance_norm.default": case["norm_calls"],
                     "renderloom.upconv.default": case["upconv_calls"]}


def test_load_refuses_another_device_and_junk(case, monkeypatch):
    """The device is read from the meta before the program is."""
    path = str(case["tmp"] / "cuda.pt2")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("cuda/extra/meta.json",
                    json.dumps({**case["meta"], "device": "cuda"}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        load_exported(path)
    junk = case["tmp"] / "junk.pt2"
    junk.write_bytes(b"NOTANEXPORT")
    with pytest.raises(ValueError, match="not a renderloom export"):
        load_exported(str(junk))


def _norm_args(dtype, affine, slope, parity):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(2, 4, 6, 8)).astype(np.float32))
    s = torch.tensor(rng.normal(size=8).astype(np.float32)) if affine \
        else None
    b = torch.tensor(rng.normal(size=8).astype(np.float32)) if affine \
        else None
    r3 = dtype == torch.bfloat16 and not parity
    return (x.to(dtype), s, b, slope, 1e-5, parity, r3)


@pytest.mark.parametrize("dtype,affine,slope,parity", [
    (torch.float32, True, 0.2, False), (torch.float32, False, None, True),
    (torch.bfloat16, True, 0.2, False), (torch.bfloat16, False, None, False),
    (torch.bfloat16, True, None, True)],
    ids=["f32", "f32-parity", "bf16-r3-affine", "bf16-r3", "bf16-parity"])
def test_opcheck_instance_norm(dtype, affine, slope, parity):
    torch.library.opcheck(torch.ops.renderloom.instance_norm.default,
                          _norm_args(dtype, affine, slope, parity))


@pytest.mark.parametrize("dtype,masks,layout", [
    (torch.float32, False, "nhwc"), (torch.bfloat16, False, "packed"),
    (torch.float32, True, "nhwc"), (torch.bfloat16, True, "packed"),
    (torch.float32, True, "cfhw")],
    ids=["nhwc-f32", "packed-bf16", "nhwc-f32-masks", "packed-bf16-masks",
         "cfhw-f32-masks"])
def test_opcheck_rasterize(dtype, masks, layout):
    rng = np.random.default_rng(1)
    tables = RK.build_tables(
        torch.tensor(rng.uniform(0, 40, (3, 19, 2)).astype(np.float32)),
        torch.tensor(rng.uniform(0, 1, (3, 19)).astype(np.float32)), 16, 24,
        5.0, 0.001, 0.001, None)
    torch.library.opcheck(torch.ops.renderloom.rasterize.default,
                          (*(x.contiguous() for x in tables), 16, 24, dtype,
                           masks, layout))
