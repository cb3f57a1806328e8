"""Device selection for the port's entry points.

Plays the part of ``ramses_tpu/platform.py``: the port runs on the GPU
unless the caller asks for the CPU.  A run that did not ask for the CPU
and finds no GPU raises; it never carries on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` → the current CUDA device (raises
    ``RuntimeError`` when CUDA is absent); anything else is taken as
    given (``"cpu"`` for the tests)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ramses_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev
