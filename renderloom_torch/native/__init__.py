"""The PNG/JPEG decoder of the HumanSloMo h5, in C++ through ctypes.

The port's copy of the JAX package's ``renderloom/native/__init__.py``
and ``decoder.cpp``: host code (libpng/libjpeg worker threads writing
into one numpy array), not a device kernel.  ``decoder.cpp`` is built
with ``g++`` at first use into ``build/renderloom_torch/`` under the
repository root (beside the CUDA kernels, named by a hash of the source
and the flags), never next to the source.  Where it cannot build (no
``g++``, or no libpng/libjpeg headers) the PIL decode runs instead, as
in JAX; :func:`native_available` says which decoder runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "decoder.cpp"
BUILD_DIR = SRC.parent.parent.parent / "build" / "renderloom_torch"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-lpng", "-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS + LIBS).encode()).hexdigest()
    return BUILD_DIR / f"librldecode_{digest[:16]}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)        # atomic: readers never see a partial .so
    return True


def load() -> Optional[ctypes.CDLL]:
    """The decoder library, built if needed; None where it cannot build
    or load."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        lib.rl_decode_batch.restype = ctypes.c_int
        lib.rl_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.rl_image_dims.restype = ctypes.c_int
        lib.rl_image_dims.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True where the C++ decoder runs, False where PIL decodes."""
    return load() is not None


def image_dims(buf: bytes) -> tuple:
    """(width, height) of a PNG/JPEG byte buffer without a full decode."""
    lib = load()
    if lib is not None:
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = lib.rl_image_dims(buf, len(buf), ctypes.byref(w),
                               ctypes.byref(h))
        if rc == 0:
            return w.value, h.value
    from PIL import Image
    with Image.open(io.BytesIO(buf)) as im:
        return im.size


def _pil_decode(buf: bytes) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(buf)).convert("RGB"))


def batch_decode(buffers: Sequence[bytes], height: int, width: int,
                 threads: Optional[int] = None) -> np.ndarray:
    """Decode PNG/JPEG byte buffers to one (n, height, width, 3) uint8
    array, in parallel through the C++ decoder (PIL where it did not
    build)."""
    bufs: List[bytes] = [b.tobytes() if isinstance(b, np.ndarray) else
                         bytes(b) for b in buffers]
    n = len(bufs)
    out = np.empty((n, height, width, 3), dtype=np.uint8)
    if n == 0:
        return out
    lib = load()
    if lib is not None:
        ptrs = (ctypes.c_void_p * n)(
            *[ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p) for b in bufs])
        lens = (ctypes.c_size_t * n)(*[len(b) for b in bufs])
        if threads is None:
            threads = min(n, os.cpu_count() or 1)
        rc = lib.rl_decode_batch(
            ptrs, lens, n, out.ctypes.data_as(ctypes.c_void_p),
            height, width, threads)
        if rc == 0:
            return out
        idx, code = (-rc) // 16, (-rc) % 16
        if code == 3:
            raise ValueError(
                f"image {idx} decoded to unexpected dims "
                f"(want {height}x{width})")
        # corrupt / unknown format: fall through to PIL for a clearer error
    for i, b in enumerate(bufs):
        img = _pil_decode(b)
        if img.shape[:2] != (height, width):
            raise ValueError(f"image {i} has shape {img.shape}, "
                             f"want ({height}, {width}, 3)")
        out[i] = img
    return out
