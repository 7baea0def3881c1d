"""Device resolution shared by every entry point of the port.

The rule: an entry point runs on ``cuda`` unless its caller asks for the
CPU. When the caller asks for nothing and CUDA is absent, it raises —
it never continues on the CPU without being told to.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); ``"cpu"``/``"cuda"``/
    a ``torch.device`` -> that device (``cuda`` raises without CUDA)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        hint = ("" if device is not None else
                "; pass device='cpu' to run the plain PyTorch versions")
        raise RuntimeError(f"CUDA is not available{hint}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
