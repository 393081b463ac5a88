"""Elastic re-meshing after node loss or a capacity change (port of
``repro.runtime.elastic``).

The policy layer: given the surviving device count, pick the largest
valid (pod, data, model) mesh that keeps the model-parallel degree (the
TP size is an algorithmic invariant: changing it re-shards every weight),
shrink the data axis, and rescale the per-shard batch so the global batch
stays constant.  :func:`plan_mesh` is a pure function of its arguments;
:func:`build_mesh` lays a plan over a device list the caller observed.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.parallel.sharding import Mesh, make_mesh_compat


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    per_shard_batch: int
    grad_accum: int

    @property
    def data_shards(self) -> int:
        s = dict(zip(self.axes, self.shape))
        return s.get("data", 1) * s.get("pod", 1)


def plan_mesh(
    available_devices: int,
    *,
    model_parallel: int,
    global_batch: int,
    prefer_pods: int = 1,
) -> MeshPlan:
    """Largest data-parallel degree that fits the surviving devices."""
    if available_devices < model_parallel:
        raise RuntimeError(
            f"cannot re-mesh: {available_devices} devices < TP degree "
            f"{model_parallel}")
    data = available_devices // model_parallel
    # data shards must divide the global batch; shrink until they do
    while data > 1 and global_batch % data != 0:
        data -= 1
    pods = prefer_pods if data % prefer_pods == 0 else 1
    if pods > 1:
        shape, axes = (pods, data // pods, model_parallel), ("pod", "data", "model")
    else:
        shape, axes = (data, model_parallel), ("data", "model")
    return MeshPlan(shape=shape, axes=axes, per_shard_batch=global_batch // data,
                    grad_accum=1)


def build_mesh(plan: MeshPlan, devices) -> Mesh:
    """Lay a plan over an explicit device list (its first
    ``prod(plan.shape)`` entries): re-planning after a failure is a
    function of the device set the caller observed, not of discovery at
    build time."""
    n = math.prod(plan.shape)
    return make_mesh_compat(plan.shape, plan.axes, devices=list(devices)[:n])
