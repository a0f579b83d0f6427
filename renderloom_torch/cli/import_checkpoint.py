"""Import the reference's PyTorch checkpoints as the port's checkpoints.

Port of the JAX package's ``renderloom/cli/import_checkpoint.py``.  The
reference's inference story rests on its published files
(``Human_Motion_Modelling/configs/config.yaml``: ``model_epoch399.pth``
and ``opt_epoch399.pth``; ``Pose_Guided_Neural_Rendering/configs/
HSM.yaml:2-3``: ``netG/netD_epoch006.pth``; torchvision's VGG19 for the
perceptual loss).  This CLI maps them (``data/torch_import.py``) into
the files the port's CLIs read:

    python -m renderloom_torch.cli.import_checkpoint --kind motion \\
        --pth model_epoch399.pth --opt opt_epoch399.pth \\
        --config configs/motion.yaml --out runs/motion_ref/checkpoint.pt
    python -m renderloom_torch.cli.import_checkpoint --kind renderer \\
        --pth netG_epoch006.pth --pth-d netD_epoch006.pth \\
        --config configs/hsm.yaml --out runs/renderer_ref/checkpoint.pt
    python -m renderloom_torch.cli.import_checkpoint --kind vgg19 \\
        --pth vgg19-dcbb9e9d.pth --out data/vgg19_features.npz

``--kind motion`` writes the layout of ``train_motion.save_checkpoint``
and ``--kind renderer`` that of ``train_renderer.save_checkpoint``, so
``train_* --resume --out-dir runs/..._ref`` continues from the file and
``core.checkpoint.read_params`` / ``read_renderer`` (the serving CLIs)
read it.  The step is the epoch in the file's name.  The mapped trees
are checked against the port model's own (``convert.flax_trees``): a
missing, extra or misshapen leaf stops the CLI.  What the reference
does not ship starts fresh, as in the JAX package: the motion
optimizer's skip counters and schedule count (its moments and update
count come from ``--opt``), the dropout generator (seeded from the
config), the renderer's optimizers, and the discriminator without
``--pth-d`` (the port's seeded initialisation).  It computes on the
host only.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Mapping

import numpy as np

from renderloom_torch.convert import flax_trees, load_flax_params
from renderloom_torch.data.torch_import import (flatten_state_dict,
                                                map_discriminator_params,
                                                map_generator_params,
                                                map_motion_opt_state,
                                                map_motion_params, read_pth,
                                                vgg19_state_to_npz)


def _shapes(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + str(k)] = tuple(np.shape(v))
    return out


def _tree_diff(expected: Mapping, got: Mapping, where: str):
    """Stop when ``got`` does not have ``expected``'s leaves and shapes."""
    exp, act = _shapes(expected), _shapes(got)
    missing = sorted(set(exp) - set(act))[:10]
    extra = sorted(set(act) - set(exp))[:10]
    shape = sorted(k for k in set(exp) & set(act) if exp[k] != act[k])[:10]
    if missing or extra or shape:
        raise SystemExit(
            f"{where}: mapped checkpoint does not match the model tree\n"
            f"  missing: {missing}\n  extra: {extra}\n"
            f"  shape mismatches: {[(k, exp[k], act[k]) for k in shape]}")


def _epoch_from_name(path: str) -> int:
    m = re.search(r"epoch(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else 0


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--kind", required=True,
                   choices=("motion", "renderer", "vgg19"))
    p.add_argument("--pth", required=True,
                   help="reference .pth (netG for --kind renderer)")
    p.add_argument("--pth-d", default=None,
                   help="netD .pth (renderer only, optional)")
    p.add_argument("--opt", default=None,
                   help="opt_epochNNN.pth (motion only): import the "
                        "AMSGrad moments so resumed training continues "
                        "faithfully (trainer.py:100-118)")
    p.add_argument("--out", required=True,
                   help="the port's checkpoint file (npz path for vgg19)")
    p.add_argument("--config", default=None, help="yaml config")
    return p.parse_args(argv)


def _import_motion(args, state_dict: dict, epoch: int):
    from renderloom_torch.cli import train_motion
    from renderloom_torch.core.config import MotionConfig, load_motion_config
    from renderloom_torch.models.motion_transformer import build_motion_model
    from renderloom_torch.train.motion import (create_motion_state,
                                               splice_amsgrad_state)

    cfg = load_motion_config(args.config) if args.config else MotionConfig()
    params = map_motion_params(state_dict)
    model_tree = flax_trees(build_motion_model(cfg))[0]
    _tree_diff(model_tree, params, "motion")
    state = create_motion_state(cfg, "cpu", cfg.seed, params=params)
    if args.opt:
        # the flattened model checkpoint's key order is torch's
        # parameters() order, which the optimizer's slots follow
        count, mu, nu, nu_max = map_motion_opt_state(read_pth(args.opt),
                                                     list(state_dict))
        _tree_diff(model_tree, mu, "opt exp_avg")
        splice_amsgrad_state(state.opt, state.model, count, mu, nu, nu_max)
        print(f"read {args.opt}: AMSGrad moments at step {count}")
    state.step = epoch
    state.dropout_rng = None        # the device's generator starts fresh
    train_motion.save_checkpoint(args.out, state)


def _import_renderer(args, state_dict: dict, epoch: int):
    from renderloom_torch.cli import train_renderer
    from renderloom_torch.core.config import (RendererConfig,
                                              load_renderer_config)
    from renderloom_torch.train.gan import create_gan_state

    cfg = load_renderer_config(args.config) if args.config \
        else RendererConfig()
    state = create_gan_state(cfg, "cpu", cfg.seed)
    params_g, stats_g = map_generator_params(state_dict)
    want_p, want_s = flax_trees(state.gen)
    _tree_diff(want_p, params_g, "netG params")
    _tree_diff(want_s, stats_g, "netG spectral stats")
    load_flax_params(state.gen, params_g, stats_g)
    if args.pth_d:
        sd_d = flatten_state_dict(read_pth(args.pth_d))
        params_d, stats_d = map_discriminator_params(sd_d)
        want_p, want_s = flax_trees(state.dis)
        _tree_diff(want_p, params_d, "netD params")
        _tree_diff(want_s, stats_d, "netD spectral stats")
        load_flax_params(state.dis, params_d, stats_d)
        print(f"read {args.pth_d}: {len(sd_d)} tensors")
    state.step = epoch
    train_renderer.save_checkpoint(args.out, state)


def main(argv=None) -> str:
    args = parse_args(argv)
    state_dict = flatten_state_dict(read_pth(args.pth))
    print(f"read {args.pth}: {len(state_dict)} tensors")
    if args.kind == "vgg19":
        n = vgg19_state_to_npz(state_dict, args.out)
        print(f"wrote {n} conv layers -> {args.out} "
              f"(use via VGG19_NPZ={args.out})")
        return args.out
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    epoch = _epoch_from_name(args.pth)
    if args.kind == "motion":
        _import_motion(args, state_dict, epoch)
    else:
        _import_renderer(args, state_dict, epoch)
    print(f"imported epoch {epoch} -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
