"""Ahead-of-time serving export: freeze the serving pipeline
(``eval.pipeline``) as one ``torch.export`` program file.

Port of the JAX package's ``renderloom/eval/export.py``.  The frozen
program holds the motion transformer's and the generator's weights and
every constant the pipeline builds at trace time (resize matrices, the
motion statistics), and calls the port's kernels through their
registered operators ``renderloom::rasterize`` (K1),
``renderloom::instance_norm`` (K2 in every mode),
``renderloom::upconv`` (the float32 mask net's fused upsample and
convolution), ``renderloom::shift_warp`` and
``renderloom::shift_warp_blend`` (the float32 LK backgrounds' warps and
blend), so a loaded artifact launches the same hand-written kernels as
the live pipeline.  Loading it touches no model code, config
or checkpoint of the port: only the modules that register those
operators.

Artifact: the ``torch.export.save`` archive with the meta JSON as its
extra file ``meta.json``.  The program runs on the device it was
exported for; on another device :func:`load_exported` raises.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Callable, Dict, Optional, Tuple

import torch

META_FILE = "meta.json"


def export_pipeline(fn: Callable, motion_model: torch.nn.Module,
                    gen: torch.nn.Module, n_clips: int, keyframes: int,
                    height: int, width: int, rate: int, device,
                    src_size: Optional[Tuple[int, int]] = None
                    ) -> Tuple[torch.export.ExportedProgram, Dict[str, Any]]:
    """Freeze ``fn`` (a :func:`~renderloom_torch.eval.pipeline.
    make_pipeline_fn` callable built on ``device``) with the modules it
    runs, ``motion_model`` and ``gen`` (what ``build_pipeline`` returns
    beside it).

    The program's signature is ``(motion, conf, keys) -> (fused, sync)``
    at the static serving shape: N = ``n_clips`` clips of K =
    ``keyframes`` keyframes, as the batched-serving planner
    (``utils.serving``) schedules requests over fixed program sizes.
    ``src_size=(src_h, src_w)``: the program takes keyframes at that
    resolution (``fn`` built with the same ``src_size`` resizes them at
    ingest)."""
    from renderloom_torch.eval.pipeline import PipelineModule

    device = torch.device(device)
    in_h, in_w = src_size if src_size is not None else (height, width)
    zeros = lambda *shape: torch.zeros(shape, device=device)
    args = (zeros(n_clips, 19, 2, keyframes), zeros(n_clips, 19, 1, keyframes),
            zeros(n_clips, keyframes, in_h, in_w, 3))
    module = PipelineModule(fn, motion_model, gen).eval()
    with torch.no_grad():
        exported = torch.export.export(module, args, strict=False)
    L = (keyframes - 1) * rate + 1
    meta = {"format": "renderloom-pipeline", "version": 1,
            "n_clips": n_clips, "keyframes": keyframes, "rate": rate,
            "frames_out": L, "height": height, "width": width,
            "device": device.type,
            "src_size": list(src_size) if src_size is not None else None,
            "inputs": {"motion": [n_clips, 19, 2, keyframes],
                       "conf": [n_clips, 19, 1, keyframes],
                       "keys": [n_clips, keyframes, in_h, in_w, 3]},
            "output": [n_clips, L, height, width, 3]}
    return exported, meta


def save_exported(path: str, exported: torch.export.ExportedProgram,
                  meta: Dict[str, Any]) -> int:
    """Write the single-file artifact; returns bytes written."""
    torch.export.save(exported, path,
                      extra_files={META_FILE: json.dumps(meta)})
    return os.path.getsize(path)


def _read_meta(path: str) -> Dict[str, Any]:
    """The artifact's meta, read without loading the program."""
    try:
        with zipfile.ZipFile(path) as zf:
            name = next((n for n in zf.namelist()
                         if n.endswith("/" + META_FILE)), None)
            if name is not None:
                return json.loads(zf.read(name).decode("utf-8"))
    except zipfile.BadZipFile:
        pass
    raise ValueError(f"{path}: not a renderloom export")


def load_exported(path: str) -> Tuple[Callable, Dict[str, Any]]:
    """Load an artifact → ``(serve, meta)``.

    ``serve(motion, conf, keys) -> (fused, sync)`` runs the frozen
    program on the device it was exported for (inputs are moved there);
    without that device it raises.  It registers the port's
    operators and touches no model code, config or checkpoint.  Like
    ``build_pipeline``, it turns TF32 off for the process."""
    meta = _read_meta(path)
    if meta.get("format") != "renderloom-pipeline":
        raise ValueError(f"{path}: not a renderloom export")
    device = torch.device(meta["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for the CUDA device and "
                           "this machine has none")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{path}: unsupported device {device}")
    # the operators the program calls
    from renderloom_torch.ops import (norm_kernel,  # noqa: F401
                                      rasterize_kernel, shiftwarp_kernel,
                                      upconv_kernel)

    program = torch.export.load(path).module()
    # float32 means float32, as the live pipeline sets it
    # (train.gan.set_float32_precision): cuDNN would run the program's
    # convolutions in TF32 by default
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    @torch.inference_mode()
    def serve(motion, conf, keys):
        as_dev = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                           device=device)
        return program(as_dev(motion), as_dev(conf), as_dev(keys))

    return serve, meta
