"""Device resolution shared by the port's entry points.

Counterpart of ``archi_tpu/utils/hardware.py`` (``on_tpu``).  Entry points
run on ``cuda`` unless the caller asks for another device; when CUDA is
absent and no device was named, they raise instead of quietly moving the
work to the CPU.
"""

from __future__ import annotations

import torch


def on_cuda() -> bool:
    """True when a CUDA device is visible to PyTorch."""
    return torch.cuda.is_available()


def default_device(device=None) -> torch.device:
    """``device`` if given, else ``cuda``; raises if CUDA is unavailable.

    Pass ``device="cpu"`` to run on the CPU (every kernel wrapper then
    takes its plain PyTorch version)."""
    if device is not None:
        return torch.device(device)
    if not on_cuda():
        raise RuntimeError(
            "archi_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
