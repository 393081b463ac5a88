"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device") -> torch.device:
    """Return ``device`` as a ``torch.device``; a CUDA device needs a card.

    There is no quiet fallback: asking for ``"cuda"`` on a machine without
    a usable card raises instead of running on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
