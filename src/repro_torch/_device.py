"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device") -> torch.device:
    """Return ``device`` as a ``torch.device``; a CUDA device needs a card.

    There is no quiet fallback: asking for ``"cuda"`` on a machine without
    a usable card, or for ``"cuda:k"`` beyond the cards present, raises
    instead of running elsewhere.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is not None \
            and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {str(device)!r} requested but this host has "
            f"{torch.cuda.device_count()} card(s)")
    return dev
