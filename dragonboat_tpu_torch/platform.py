"""Device selection for the PyTorch/CUDA port.

Counterpart: ``dragonboat_tpu/hostplatform.py``.  The port runs on a CUDA
device unless the caller names the CPU; it never falls back on its own.
"""
from __future__ import annotations

import torch


def pick_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when ``device`` is None,
    else the named device, which must be a CUDA device or the CPU.  Raises
    when CUDA is asked for (explicitly or by default) and there is none."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions of the kernels"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use a CUDA device or 'cpu'")
    return dev
