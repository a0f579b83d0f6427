"""Command-line entry points of the port.  Each runs on the CUDA device
unless ``--device cpu`` is given (:func:`cli_device`)."""

import torch


def cli_device(prog: str, name: str) -> torch.device:
    """``--device`` as a device; a CUDA request without a card raises
    (the CLIs never fall back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{prog}: no CUDA device; pass --device cpu to "
                           "run on the CPU")
    return device
