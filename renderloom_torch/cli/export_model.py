"""Export the full serving pipeline as a ``torch.export`` artifact.

Port of the JAX package's ``renderloom/cli/export_model.py``: freezes
motion upsampling → flow backgrounds → label rasterization → segment
rollout (one program, weights embedded; :mod:`renderloom_torch.eval.
export`) for serving without the port's models, configs or checkpoints.
The program runs on the device it is exported on: ``--device`` (the
CUDA device unless ``--device cpu`` is given; without a CUDA device a
CUDA export refuses to run).  ``--fastpath`` exports the parity-layout
configuration (packed bf16 label, K2 parity); with both configs'
``compute_dtype: bfloat16`` it is the configuration ``bench.py`` serves.

Usage:
  python -m renderloom_torch.cli.export_model \\
      --motion-ckpt runs/motion_torch/checkpoint.pt \\
      --renderer-ckpt runs/renderer_torch/checkpoint.pt \\
      --rate 4 --keyframes 8 --clips 1 --fastpath --out pipeline_h100.pt2
"""

from __future__ import annotations

import argparse

from renderloom_torch.cli import cli_device
from renderloom_torch.cli.infer_motion import CKPT_HELP as MOTION_HELP
from renderloom_torch.cli.infer_motion import load_stats
from renderloom_torch.cli.infer_renderer import CKPT_HELP as RENDERER_HELP
from renderloom_torch.core.checkpoint import read_params, read_renderer
from renderloom_torch.core.config import (MotionConfig, RendererConfig,
                                          load_motion_config,
                                          load_renderer_config)
from renderloom_torch.eval.export import export_pipeline, save_exported
from renderloom_torch.eval.pipeline import build_pipeline


def main(argv=None) -> dict:
    """Export; returns the artifact's meta (with its ``bytes``)."""
    p = argparse.ArgumentParser(
        description="renderloom_torch serving-pipeline export")
    p.add_argument("--motion-ckpt", type=str, default=None,
                   help=MOTION_HELP + " (random init if omitted — smoke "
                        "use only)")
    p.add_argument("--renderer-ckpt", type=str, default=None,
                   help=RENDERER_HELP)
    p.add_argument("--motion-config", type=str, default=None)
    p.add_argument("--renderer-config", type=str, default=None)
    p.add_argument("--rate", type=int, default=4,
                   help="upsampling factor (power of two)")
    p.add_argument("--keyframes", type=int, default=8,
                   help="keyframes per served clip (output length is "
                        "(K-1)*rate+1)")
    p.add_argument("--clips", type=int, default=1,
                   help="clips per batch in the frozen program; export "
                        "one artifact per planner program size")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device the program is exported for and runs "
                        "on (cuda, or cpu when asked)")
    p.add_argument("--fastpath", action="store_true",
                   help="the parity-layout generator on a packed bf16 "
                        "label")
    p.add_argument("--src-size", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="accept keyframes at this on-disk resolution "
                        "(e.g. 512 768, the reference's frame format) "
                        "and resize on device at ingest; default: "
                        "model resolution")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--seed", type=int, default=0,
                   help="recorded in the meta; random weights come from "
                        "the port's fixed seeds (motion 0, generator 1)")
    args = p.parse_args(argv)

    device = cli_device("export_model", args.device)
    mcfg = load_motion_config(args.motion_config) if args.motion_config \
        else MotionConfig()
    rcfg = load_renderer_config(args.renderer_config) \
        if args.renderer_config else RendererConfig()
    H, W = rcfg.data.model_height, rcfg.data.model_width
    m_params = read_params(args.motion_ckpt) if args.motion_ckpt else None
    g_params = g_stats = None
    if args.renderer_ckpt:
        g_params, g_stats = read_renderer(args.renderer_ckpt)
    mean, std = load_stats(mcfg.dataset)

    src_size = tuple(args.src_size) if args.src_size else None
    fn, m_model, gen = build_pipeline(
        mcfg, rcfg, args.rate, args.keyframes, m_params=m_params,
        g_params=g_params, g_stats=g_stats, mean=mean, std=std,
        src_size=src_size, device=device, fastpath=args.fastpath)
    exported, meta = export_pipeline(
        fn, m_model, gen, args.clips, args.keyframes, H, W, args.rate,
        device, src_size=src_size)
    meta["seed"] = args.seed
    meta["fastpath"] = args.fastpath
    meta["compute_dtype"] = {"motion": mcfg.compute_dtype,
                             "renderer": rcfg.compute_dtype}
    meta["trained"] = bool(args.motion_ckpt and args.renderer_ckpt)
    n = save_exported(args.out, exported, meta)
    print(f"exported {meta['inputs']} -> {meta['output']} for "
          f"{device.type} ({n / 1e6:.1f} MB) to {args.out}")
    return {**meta, "bytes": n}


if __name__ == "__main__":
    main()
