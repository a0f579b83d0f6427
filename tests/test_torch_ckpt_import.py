"""Checkpoint import from the reference in the PyTorch port
(``renderloom_torch/data/torch_import.py``, ``train/motion.py:
splice_amsgrad_state``, ``cli/import_checkpoint.py``) against the JAX
package's importer, on the reference-named files
``chip_smoke.write_reference_checkpoints`` writes (seeded values at the
tiny widths of ``_torch_parity.py``; the card's phase CI writes them at
full width), in torch's zip and legacy formats.

Tolerances: the mapped trees, the ``.npz`` files and the spliced AMSGrad
state bit for bit (the same float64 σ division, the same copies); one
AMSGrad update from the spliced state 1e-6 of the largest update (the
port sums the global norm in another order than optax; reading
6.9e-8); the imported generator and motion transformer against JAX's on
JAX's imported trees 1e-4 of the largest output (convolutions and
matmuls summed in another order than XLA's; readings: the image 8.4e-6,
the mask 2.9e-6, the motion outputs 4.3e-7 and 3.3e-7).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import motion_cfg, renderer_cfg, single_thread  # noqa: F401
from renderloom.data import torch_import as JI
from renderloom_torch.cli import import_checkpoint as IC
from renderloom_torch.cli import train_motion as TM
from renderloom_torch.cli import train_renderer as TR
from renderloom_torch.convert import flax_trees, state_dict_from_flax
from renderloom_torch.core.checkpoint import read_params, read_renderer
from renderloom_torch.data import torch_import as TI
from renderloom_torch.train.gan import create_gan_state, make_inference_pair
from renderloom_torch.train.motion import (create_motion_state,
                                           splice_amsgrad_state)

H, W = 64, 96
VGG_TINY = ((0, 32, 8), (3, 8, 8), (6, 8, 5))
FORMATS = ("zip", "legacy")


def rcfg(C):
    """The tiny renderer with tests/test_torch_train_step.py's tiny
    discriminator set."""
    import dataclasses

    tiny = lambda n, layers=2: C.PatchDiscConfig(
        num_filters=4, max_num_filters=16, num_discriminators=n,
        num_layers=layers)
    return dataclasses.replace(
        renderer_cfg(C, H, W),
        dis=C.DiscriminatorConfig(image=tiny(2), face=tiny(1),
                                  hand=tiny(1, layers=1)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Reference files in both formats, plus opt files with string slot
    keys and an int ``step`` (older torch)."""
    root = tmp_path_factory.mktemp("ref")
    out = {fmt: CS.write_reference_checkpoints(
        str(root / fmt), rcfg(TC), motion_cfg(TC), seed=3,
        legacy=fmt == "legacy", vgg_classifier=VGG_TINY) for fmt in FORMATS}
    model = torch.load(out["zip"]["model"], weights_only=True)
    out["opt_old"] = str(root / "opt_epoch399_old.pth")
    torch.save(CS.reference_opt_state(model, 12, 9, str_slots=True,
                                      step_tensor=False), out["opt_old"],
               _use_new_zipfile_serialization=False)
    out["root"] = root
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert np.array_equal(g[k], w[k]), k


def _both(path):
    return TI.flatten_state_dict(TI.read_pth(path)), \
        JI.flatten_state_dict(JI.read_pth(path))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", ["netG", "netD", "model"])
def test_mapped_trees_equal_jax(files, fmt, kind):
    mine, ref = _both(files[fmt][kind])
    assert list(mine) == list(ref)
    fn = {"netG": "map_generator_params", "netD": "map_discriminator_params",
          "model": "map_motion_params"}[kind]
    got, want = getattr(TI, fn)(mine), getattr(JI, fn)(ref)
    if kind == "model":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert_trees_equal(g, w)


@pytest.mark.parametrize("which", ["zip", "legacy", "opt_old"])
def test_opt_moments_equal_jax(files, which):
    """Slot keys as ints (recent torch) or strings, ``step`` a tensor or
    an int."""
    path = files[which] if which == "opt_old" else files[which]["opt"]
    keys = list(_both(files["zip"]["model"])[0])
    got = TI.map_motion_opt_state(TI.read_pth(path), keys)
    want = JI.map_motion_opt_state(JI.read_pth(path), keys)
    assert got[0] == want[0] == (12 if which == "opt_old" else 399 * 7)
    for g, w in zip(got[1:], want[1:]):
        assert_trees_equal(g, w)


@pytest.mark.parametrize("fmt", FORMATS)
def test_vgg19_npz_equal_jax(files, fmt, tmp_path):
    mine, ref = _both(files[fmt]["vgg19"])
    assert TI.vgg19_state_to_npz(mine, str(tmp_path / "a.npz")) == \
        JI.vgg19_state_to_npz(ref, str(tmp_path / "b.npz")) == 16
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        assert list(a.files) == list(b.files)
        assert "features.classifier.0.bias" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def spliced(files):
    """JAX's and the port's motion states with the zip files' moments
    spliced in, and one update from each on the same gradients."""
    from renderloom.train.motion import create_motion_state as jcreate
    from renderloom.train.motion import splice_amsgrad_state as jsplice

    m_state = TI.flatten_state_dict(TI.read_pth(files["zip"]["model"]))
    params = TI.map_motion_params(m_state)
    moments = TI.map_motion_opt_state(TI.read_pth(files["zip"]["opt"]),
                                      list(m_state))
    _, tx, jstate = jcreate(jax.random.PRNGKey(0), motion_cfg(JC))
    jparams = jax.tree.map(jnp.asarray, JI.map_motion_params(
        JI.flatten_state_dict(JI.read_pth(files["zip"]["model"]))))
    jopt = jsplice(jstate.opt_state, *JI.map_motion_opt_state(
        JI.read_pth(files["zip"]["opt"]), list(m_state)))
    state = create_motion_state(motion_cfg(TC), "cpu", params=params)
    splice_amsgrad_state(state.opt, state.model, *moments)
    rng = np.random.default_rng(5)
    grads = jax.tree.map(lambda x: rng.normal(
        0, 1e-2, x.shape).astype(np.float32), params)
    updates, _ = tx.update(jax.tree.map(jnp.asarray, grads), jopt, jparams)
    updates = jax.tree.map(np.asarray, updates)
    # the update does not read the parameters: from zero parameters the
    # new ones are the update itself, unrounded by a parameter's ulp
    with torch.no_grad():
        state.opt.flat.zero_()
    sd = state_dict_from_flax(grads)
    state.opt.step([sd[n] for n, _ in state.model.named_parameters()])
    return dict(state=state, jopt=jopt, moments=moments, updates=updates,
                delta=state.opt.flat.clone())


def _ams(opt_state):
    import optax

    found = []

    def walk(node):
        if isinstance(node, optax.ScaleByAmsgradState):
            found.append(node)
        elif isinstance(node, tuple):
            for c in node:
                walk(c)

    walk(opt_state)
    assert len(found) == 1
    return found[0]


def test_spliced_amsgrad_state_equals_jax(spliced):
    ams = _ams(spliced["jopt"])
    model = spliced["state"].model
    flat = lambda tree: CS._flat_moment(jax.tree.map(np.asarray, tree),
                                        model)
    # before the update: the moments as spliced (the fixture's step
    # comes after; rebuild them from the trees the port spliced)
    count, mu, nu, nu_max = spliced["moments"]
    assert int(ams.count) == count
    for name, tree in (("mu", mu), ("nu", nu), ("nu_max", nu_max)):
        assert torch.equal(CS._flat_moment(tree, model),
                           flat(getattr(ams, name))), name


def test_update_from_spliced_state_equals_jax(spliced):
    """One clipped AMSGrad update from the spliced state, the schedule at
    its fresh count as in JAX."""
    state = spliced["state"]
    want = CS._flat_moment(spliced["updates"], state.model)
    got = spliced["delta"]
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert int(state.opt.count) == spliced["moments"][0] + 1
    assert int(state.opt.schedule_count) == 1


@pytest.fixture(scope="module")
def imported(files):
    """The port's CLI run on the legacy files for each kind."""
    root = files["root"] / "imported"
    # 33-frame windows keep the resumed motion CLI's step short
    mcfg = motion_cfg(TC)
    mcfg = dataclasses.replace(mcfg, dataset=dataclasses.replace(
        mcfg.dataset, max_seq_length=33))
    m_yaml = CS._yaml_cfg(str(files["root"] / "motion.yaml"), mcfg)
    r_yaml = CS._yaml_cfg(str(files["root"] / "renderer.yaml"), rcfg(TC))
    ref = files["legacy"]
    out = {"motion": str(root / "motion" / "checkpoint.pt"),
           "renderer": str(root / "renderer" / "checkpoint.pt"),
           "vgg19": str(root / "vgg19_features.npz")}
    IC.main(["--kind", "motion", "--pth", ref["model"], "--opt", ref["opt"],
             "--config", m_yaml, "--out", out["motion"]])
    IC.main(["--kind", "renderer", "--pth", ref["netG"], "--pth-d",
             ref["netD"], "--config", r_yaml, "--out", out["renderer"]])
    IC.main(["--kind", "vgg19", "--pth", ref["vgg19"], "--out",
             out["vgg19"]])
    return dict(out, m_yaml=m_yaml, r_yaml=r_yaml, ref=ref)


def test_cli_round_trip(imported):
    ref = imported["ref"]
    m_state, _ = _both(ref["model"])
    assert_trees_equal(read_params(imported["motion"]),
                       TI.map_motion_params(m_state))
    params_g, stats_g = read_renderer(imported["renderer"])
    want_p, want_s = TI.map_generator_params(_both(ref["netG"])[0])
    assert_trees_equal(params_g, want_p)
    assert_trees_equal(stats_g, want_s)
    # the training CLIs' loaders: steps, moments, both networks
    mstate = create_motion_state(motion_cfg(TC), "cpu")
    TM.load_checkpoint(imported["motion"], mstate)
    count, mu, _, nu_max = TI.map_motion_opt_state(
        TI.read_pth(ref["opt"]), list(m_state))
    assert mstate.step == CS.REF_EPOCH_M and int(mstate.opt.count) == count
    assert int(mstate.opt.schedule_count) == 0
    assert torch.equal(mstate.opt.mu, CS._flat_moment(mu, mstate.model))
    assert torch.equal(mstate.opt.nu_max,
                       CS._flat_moment(nu_max, mstate.model))
    gstate = create_gan_state(rcfg(TC), "cpu")
    TR.load_checkpoint(imported["renderer"], gstate)
    assert gstate.step == CS.REF_EPOCH_G
    assert_trees_equal(flax_trees(gstate.gen)[0], want_p)
    assert_trees_equal(flax_trees(gstate.dis)[0], TI.map_discriminator_params(
        _both(ref["netD"])[0])[0])


def test_motion_cli_resumes_from_import(imported, tmp_path):
    import shutil

    run = tmp_path / "motion"
    shutil.copytree(os.path.dirname(imported["motion"]), run)
    res = TM.main(["--synthetic", "--resume", "--config", imported["m_yaml"],
                   "--out-dir", str(run), "--epochs",
                   str(CS.REF_EPOCH_M + 1), "--steps-per-epoch", "1",
                   "--batch-size", "2", "--device", "cpu"])
    assert res["state"].step == CS.REF_EPOCH_M + 1
    assert [e["epoch"] for e in res["epochs"]] == [CS.REF_EPOCH_M]
    assert int(res["state"].opt.total_notfinite) == 0


def test_renderer_cli_resumes_from_import(imported, tmp_path):
    import shutil

    run = tmp_path / "renderer"
    shutil.copytree(os.path.dirname(imported["renderer"]), run)
    res = TR.main(["--synthetic", "--resume", "--config",
                   imported["r_yaml"], "--out-dir", str(run), "--epochs",
                   str(CS.REF_EPOCH_G + 1), "--steps-per-epoch", "1",
                   "--batch-size", "1", "--device", "cpu"])
    st = res["state"]
    assert st.step == CS.REF_EPOCH_G + 1
    assert int(st.opt_g.total_notfinite) + int(st.opt_d.total_notfinite) == 0
    assert bool(torch.isfinite(st.opt_g.flat).all())


def test_imported_generator_matches_jax(imported):
    from renderloom.train import gan as JG

    jp, js = JI.map_generator_params(_both(imported["ref"]["netG"])[1])
    jgen, folded = JG.make_inference_pair(rcfg(JC), jp, js)
    rng = np.random.default_rng(2)
    x = [rng.uniform(-1, 1, (2, H, W, c)).astype(np.float32)
         for c in (22, 22, 3, 3)]
    want = jax.jit(lambda p, *a: jgen.apply({"params": p}, *a))(folded, *x)
    gen = make_inference_pair(rcfg(TC), *read_renderer(imported["renderer"]),
                              "cpu")
    with torch.no_grad():
        got = gen(*(torch.from_numpy(a) for a in x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_imported_motion_transformer_matches_jax(imported):
    from renderloom.models.motion_transformer import build_motion_model as jb
    from renderloom_torch.models.motion_transformer import build_motion_model

    jparams = JI.map_motion_params(_both(imported["ref"]["model"])[1])
    cfg = motion_cfg(JC)
    rng = np.random.default_rng(4)
    L, C = 17, cfg.transformer.input_joints
    src = rng.normal(0, 0.5, (2, L, C)).astype(np.float32)
    interp = rng.normal(0, 0.5, (2, L, C)).astype(np.float32)
    mask = np.zeros((2, L), bool)
    mask[1, -3:] = True
    want = jax.jit(lambda p, a, b, m: jb(cfg).apply(
        {"params": p}, a, m, b, m, 4, deterministic=True))(
        jparams, src, interp, mask)
    model = build_motion_model(motion_cfg(TC))
    from renderloom_torch.convert import load_flax_params
    load_flax_params(model, read_params(imported["motion"]))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(src), torch.from_numpy(mask),
                           torch.from_numpy(interp), torch.from_numpy(mask),
                           4)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_tree_diff_refuses_a_misshapen_leaf(files, tmp_path):
    state = torch.load(files["zip"]["model"], weights_only=True)
    w = state["input_embed.weight"]
    state["input_embed.weight"] = torch.zeros(w.shape[0], w.shape[1] + 1)
    bad = str(tmp_path / "model_epoch001.pth")
    torch.save(state, bad)
    m_yaml = CS._yaml_cfg(str(tmp_path / "m.yaml"), motion_cfg(TC))
    with pytest.raises(SystemExit, match="does not match the model tree"
                       r"(.|\n)*input_embed/kernel"):
        IC.main(["--kind", "motion", "--pth", bad, "--config", m_yaml,
                 "--out", str(tmp_path / "out" / "checkpoint.pt")])
    with pytest.raises(SystemExit, match="missing"):
        IC._tree_diff({"a": {"kernel": np.zeros(2)}}, {}, "x")
