"""Build the port's CUDA kernels with ``nvcc`` and load them via ctypes.

The wrappers call the libraries directly; each kernel is also a
registered torch operator, which a ``torch.export`` program calls
instead: :func:`traced` tells a wrapper which of the two a call is.

Each ``renderloom_torch/csrc/<name>.cu`` is compiled on first use into
its own shared library with a plain C interface,
``build/renderloom_torch/lib<name>_<hash>.so`` under the repository
root.  The hash covers the source and the flags, so an edited source
rebuilds and an unchanged one loads from the cache.  Nothing is
prebuilt and nothing comes from outside the repository: the sources
include only the CUDA toolkit's headers.

``--fmad=false`` keeps every multiply and add separately rounded, as
PyTorch's elementwise ops are; the rasterizer's masks compare squared
distances against squared radii and must come out bit-exact against
the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "renderloom_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source (default: all) that is not cached yet.

    One ``nvcc`` process per source, all started together.  Returns the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    per source built; raises with that output if any build fails.
    """
    names = sources() if names is None else list(names)
    started = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        started.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs, failed = {}, []
    for name, tmp, out, proc in started:
        log = proc.communicate()[0].decode(errors="replace")
        logs[name] = log
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)    # atomic: readers never see a partial .so
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def traced(x: torch.Tensor) -> bool:
    """Whether a call on ``x`` is being traced by ``torch.export`` (whose
    tensors are fake subclasses): it must go through the registered
    operator.  Eager calls skip the operator's dispatch (9–14 µs of host
    time a call on the H100) and reach the same kernel."""
    return torch.compiler.is_exporting() or type(x) is not torch.Tensor


def load(name: str) -> ctypes.CDLL:
    """The compiled library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
