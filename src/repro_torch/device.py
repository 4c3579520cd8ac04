"""The port's device rule: the card unless the caller asks for the CPU.

There is no silent fallback.  An entry point called with the default
``device="cuda"`` on a machine without CUDA raises; the CPU runs only when
the caller passes ``device="cpu"`` (as the tests do).
"""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raise if it names CUDA and there
    is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
