"""Production mesh construction (port of ``repro.launch.mesh``): functions,
not module constants, so importing this module never touches a card.

``device="meta"`` gives the production mesh with every entry the ``meta``
device: the dry-run's mesh (``launch/dryrun.py``), the counterpart of the
JAX package's ``XLA_FLAGS=--xla_force_host_platform_device_count``, which
lets its dry-run build a 256- or 512-device mesh on one host.
"""

from __future__ import annotations

import math

import torch

from repro_torch._device import resolve_device
from repro_torch.parallel.sharding import Mesh, abstract_mesh_compat, make_mesh_compat


def make_production_mesh(*, multi_pod: bool = False,
                         device: "str | torch.device" = "cuda") -> Mesh:
    """16x16 over ``("data", "model")``, or 2x16x16 over ``("pod", "data",
    "model")``.  On ``"cuda"`` the host's cards, raising when there are
    fewer than the mesh needs (never a smaller mesh); on ``"meta"`` the
    same layout of ``meta`` entries."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = torch.device(device)
    if dev.type == "meta":
        return abstract_mesh_compat(shape, axes)
    if dev.type != "cuda":
        raise ValueError(f"a production mesh is of cards or of meta entries, not {dev}")
    n = math.prod(shape)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"need {n} cards for mesh {shape}, have {have}")
    return make_mesh_compat(shape, axes, devices=[f"cuda:{i}" for i in range(n)])


def make_host_mesh(device: "str | torch.device" = "cuda") -> Mesh:
    """A one-device 1x1 mesh over ``("data", "model")`` for smoke tests."""
    return make_mesh_compat((1, 1), ("data", "model"), devices=[resolve_device(device)])
