"""Shared pieces of the PyTorch-port parity tests (``test_torch_*.py``):
tiny configs built from either package's config module, numpy-seeded
flax param trees, and a one-thread torch fixture.

The trees are the JAX models' own structure (``jax.eval_shape`` of their
``init``, which traces without compiling) filled from a numpy seed, so
both sides of a test run the same weights and the port's converter
sees exactly the tree a JAX checkpoint has.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    """Small torch ops on a shared CPU run tens of times slower across
    threads than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def renderer_cfg(C, H: int, W: int):
    """Tiny-width renderer config (tests/test_pipeline_e2e.py's widths)
    from config module ``C``."""
    return C.RendererConfig(
        gen=C.GeneratorConfig(
            num_filters=4, max_num_filters=16, num_layers=6,
            num_downsamples=4, do_checkpoint=False,
            mask=C.MaskNetConfig(num_filters=4, max_num_filters=16,
                                 num_downsamples=3, num_res_blocks=2),
            embed=C.EmbedConfig(num_filters=4, max_num_filters=16,
                                num_downsamples=4)),
        data=C.RendererDataConfig(model_width=W, model_height=H,
                                  load_width=W, load_height=H))


def motion_cfg(C):
    return C.MotionConfig(
        transformer=C.TransformerConfig(hidden_dim=32, nheads=4,
                                        dim_feedforward=64, enc_layers=2,
                                        dec_layers=2, dropout=0.0),
        pos_encode=C.PosEncodeConfig(hidden_dim=32))


def fill_tree(shapes, rng: np.random.Generator) -> dict:
    """numpy values for an ``eval_shape`` tree: lecun-scaled kernels,
    small random biases and norm scales near 1 (so the affines are not
    the identity), normal power-iteration vectors."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = fill_tree(v, rng)
            continue
        shape = v.shape
        if k == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            val = rng.normal(size=shape) / np.sqrt(fan_in)
        elif k == "bias":
            val = 0.1 * rng.normal(size=shape)
        elif k == "scale":
            val = 1.0 + 0.1 * rng.normal(size=shape)
        elif k.endswith("/u"):
            val = rng.normal(size=shape)
        else:                                   # sn sigma: unused
            val = np.ones(shape)
        out[k] = val.astype(np.float32)
    return out


def generator_trees(jcfg, H: int, W: int, seed: int = 0):
    """(params, batch_stats) of the JAX spectral generator of renderer
    config ``jcfg``."""
    from renderloom.models.renderer import Generator

    label = jnp.zeros((1, H, W, 22))
    img = jnp.zeros((1, H, W, 3))
    shapes = jax.eval_shape(Generator(jcfg.gen).init,
                            jax.random.PRNGKey(0), label, label, img, img)
    rng = np.random.default_rng(seed)
    return (fill_tree(shapes["params"], rng),
            fill_tree(shapes["batch_stats"], rng))


def motion_tree(jcfg, seed: int = 0) -> dict:
    from renderloom.models.motion_transformer import build_motion_model

    src = jnp.zeros((1, 17, jcfg.transformer.input_joints))
    mask = jnp.zeros((1, 17), bool)
    shapes = jax.eval_shape(build_motion_model(jcfg).init,
                            jax.random.PRNGKey(0), src, mask, src, mask, 4)
    return fill_tree(shapes["params"], np.random.default_rng(seed))


def blobs(K, H, W, seed=0):
    """Keyframes with a bright blob moving a few pixels per frame over a
    textured background, so LK has structure to lock on."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = 0.3 + 0.1 * np.sin(xx / 3.0)[..., None] * np.cos(yy / 5.0)[..., None]
    frames = []
    for k in range(K):
        cx, cy = W / 3 + 3 * k, H / 2 + k
        blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 40.0)[..., None]
        frames.append(base + 0.6 * blob * rng.uniform(0.8, 1.0, 3))
    return np.stack(frames).astype(np.float32)


def t(x) -> torch.Tensor:
    """numpy / jax array → CPU torch tensor."""
    return torch.from_numpy(np.array(x))


def bf16(cfg):
    """A motion or renderer config with ``compute_dtype: bfloat16``."""
    return dataclasses.replace(cfg, compute_dtype="bfloat16")


def hold_bf16(name, got, jax_bf16, jax_f32, mean_tol):
    """A bf16 output of the port against the JAX package's
    (tests/test_torch_bf16.py): its mean |port − JAX bf16| within
    ``mean_tol``, and its largest error against the JAX float32 output at
    most 1.5× the JAX bf16 output's own plus 1e-3."""
    got = np.asarray(got, np.float32)
    want, ref = (np.asarray(a, np.float32) for a in (jax_bf16, jax_f32))
    assert got.shape == want.shape == ref.shape, name
    mean_err = np.abs(got - want).mean()
    assert mean_err <= mean_tol, f"{name}: mean |port - JAX bf16| {mean_err}"
    err, own = np.abs(got - ref).max(), np.abs(want - ref).max()
    assert err <= 1.5 * own + 1e-3, \
        f"{name}: {err} from float32, JAX bf16 {own}"


def png_bytes(img: np.ndarray) -> np.ndarray:
    """An (H, W, 3) uint8 image as PNG bytes, the h5's vlen-uint8 row."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return np.frombuffer(buf.getvalue(), np.uint8)


def write_hsm_h5(path: str, clips: dict, H: int, W: int, seed: int = 0,
                 phases=("train", "gt")) -> str:
    """A HumanSloMo h5 in the reference's layout
    (``gen_dataset_h5.py:57-174``): per clip and phase, PNG frames
    ``<phase>_images`` and ``<phase>_dain`` (the train DAIN has one row
    fewer, as the reference's) and float64 ``<phase>_poses`` (n, 19, 3)
    with joints inside the frame.  ``clips`` maps a clip name to its
    frame count."""
    import h5py

    rng = np.random.default_rng(seed)
    vlen = h5py.vlen_dtype(np.uint8)
    with h5py.File(path, "w") as f:
        for name, n in clips.items():
            grp = f.create_group(name)
            for phase in phases:
                for key, rows in (("images", n), ("dain", n - (phase ==
                                                               "train"))):
                    ds = grp.create_dataset(f"{phase}_{key}", (rows,),
                                            dtype=vlen)
                    for i in range(rows):
                        ds[i] = png_bytes(rng.integers(
                            0, 256, (H, W, 3), dtype=np.uint8))
                poses = np.stack([rng.uniform(5, W - 5, (n, 19)),
                                  rng.uniform(5, H - 5, (n, 19)),
                                  rng.uniform(0.5, 1.0, (n, 19))], axis=-1)
                grp.create_dataset(f"{phase}_poses", data=poses)
    return path


def smpl_clips(B, L, seed=0):
    """Smooth SMPL-like (B, 52, 3, L) joint paths around a standing body,
    so the body basis is well defined."""
    rng = np.random.default_rng(seed)
    tt = np.linspace(0, 2 * np.pi, L)
    base = rng.normal(0, 0.3, (B, 52, 3, 1))
    base[:, [1, 16], 0] -= 0.3          # left hip / shoulder
    base[:, [2, 17], 0] += 0.3          # right hip / shoulder
    wave = 0.1 * np.sin(tt + rng.uniform(0, 6, (B, 52, 3, 1)))
    return (base + wave).astype(np.float32)


def jax_random_drop_draws(k_drop, J, D, L, rate):
    """The draws of JAX's ``random_drop(k_drop, ...)`` on one (J, D, L)
    clip: its six sub-keys' permutations and noise."""
    k_nf, k_df, k_ff, k_noise, k_nj, k_dj = jax.random.split(k_drop, 6)
    n_keys = len(range(0, L, rate))
    perm = lambda k, n: np.array(jax.random.permutation(k, n))
    return {"noise_frames": perm(k_nf, n_keys),
            "drop_frames": perm(k_df, n_keys),
            "flip_frames": perm(k_ff, n_keys),
            "noise_joints": perm(k_nj, 12),
            "drop_joints": perm(k_dj, 13),
            "noise": np.array(jax.random.uniform(k_noise, (J, D, L)))}


def jax_synthesis_draws(key, B, L, p):
    """The draws JAX's ``synthesize_batch(key, ...)`` makes, batched as
    ``renderloom_torch.ops.pose.draw_synthesis`` returns them (``p``: the
    JAX ``SynthesisParams``)."""
    per = []
    J, D = (52, 3) if p.return_3d else (19, 2)
    for k in jax.random.split(key, B):
        k_view, k_focal, k_depth, k_drop, k_dec = jax.random.split(k, 5)
        d_min = 0.1 * p.depth
        u = lambda kk: np.asarray(jax.random.uniform(
            kk, (), minval=-d_min, maxval=d_min))
        one = {"view": np.asarray(jax.random.uniform(
                   k_view, (3,), minval=-1.0, maxval=1.0)
                   * (jnp.asarray(p.rotation_axes) * jnp.pi)),
               "focal": u(k_focal), "depth": u(k_depth),
               "dec_idx": np.asarray(jax.random.randint(
                   k_dec, (p.sample_size,), 0, L))}
        one.update(jax_random_drop_draws(k_drop, J, D, L, p.rate))
        per.append(one)
    return {k: torch.from_numpy(np.stack([d[k] for d in per]))
            for k in per[0]}


def write_amass_h5(path: str, groups: dict, seed: int = 0) -> str:
    """An AMASS joints h5 in the reference's layout
    (``gen_amass_h5.py:60-74``): ``<group>/<motion>/joints`` float64
    (T, 52, 3) smooth paths around a standing body.  ``groups`` maps a
    group name to its motions' frame counts."""
    import h5py

    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        for name, lengths in groups.items():
            grp = f.create_group(name)
            for i, T in enumerate(lengths):
                clip = smpl_clips(1, T, seed=int(rng.integers(1 << 30)))[0]
                grp.create_group(f"m{i}").create_dataset(
                    "joints", data=clip.transpose(2, 0, 1).astype(np.float64))
    return path


def host_copy(tree):
    """numpy copies of a JAX pytree's leaves (a donating step may reuse
    the buffers)."""
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def load_adam_state(opt, model, params, opt_state):
    """Set the port's ``AmsgradIfFinite(amsgrad=False)`` ``opt`` over
    ``model``'s parameters to a JAX state: the numpy param tree
    ``params`` and the ``apply_if_finite(chain(clip_by_global_norm,
    adam))`` state ``opt_state``, so a port step starts where a JAX step
    did."""
    from renderloom_torch import convert

    adam = opt_state.inner_state[1][0]
    names = [n for n, _ in model.named_parameters()]

    def flat(tree):
        sd = convert.state_dict_from_flax(tree)
        return torch.cat([sd[n].reshape(-1) for n in names])

    with torch.no_grad():
        opt.flat.copy_(flat(params))
    opt.mu, opt.nu = flat(adam.mu), flat(adam.nu)
    opt.count = torch.tensor(int(adam.count), dtype=torch.int32)
    opt.notfinite_count = torch.tensor(int(opt_state.notfinite_count),
                                       dtype=torch.int32)
