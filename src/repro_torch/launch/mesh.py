"""Production mesh construction (port of ``repro.launch.mesh``): functions,
not module constants, so importing this module never touches a card."""

from __future__ import annotations

import math

import torch

from repro_torch._device import resolve_device
from repro_torch.parallel.sharding import Mesh, make_mesh_compat


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 over ``("data", "model")``, or 2x16x16 over ``("pod", "data",
    "model")``, on the host's cards; raises when there are fewer cards than
    the mesh needs (never a smaller mesh)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"need {n} cards for mesh {shape}, have {have}")
    return make_mesh_compat(shape, axes, devices=[f"cuda:{i}" for i in range(n)])


def make_host_mesh(device: "str | torch.device" = "cuda") -> Mesh:
    """A one-device 1x1 mesh over ``("data", "model")`` for smoke tests."""
    return make_mesh_compat((1, 1), ("data", "model"), devices=[resolve_device(device)])
