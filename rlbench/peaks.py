"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit), and the least
time a piece of work can take on it."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {
    "bfloat16": 989e12,     # tensor cores
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,       # outside the tensor cores (TF32 off)
}
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bytes_seconds(n_bytes: float) -> float:
    """Least time to move ``n_bytes`` through device memory."""
    return n_bytes / HBM_BYTES_PER_S


def flops_seconds(n_flops: float, dtype: str) -> float:
    """Least time for ``n_flops`` at the peak of ``dtype``."""
    return n_flops / FLOPS_PER_S[dtype]
