"""Parameter-spec system and common layers.

A model is declared as a nested dict of :class:`ParamSpec` (shape + logical
axes + init), as in the JAX package.  From the one spec tree come, without
duplication:

  * materialized parameters                   (init_params)
  * ``meta`` tensors for the dry-run          (abstract_params: no allocation)
  * the logical axes and NamedShardings       (axes_tree, specs_to_shardings)

Parameters keep the JAX package's nested-dict layout, so converting weights
between the packages stays a rename.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch._device import resolve_device
from repro_torch.parallel.sharding import Mesh, NamedSharding, logical_to_spec

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float = 1.0          # multiplier on the fan-in init
    dtype: str | None = None    # None = model dtype (caches may pin f32)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def spec_leaves(specs: Any, prefix: str = "") -> list[tuple[str, ParamSpec]]:
    """``(path, spec)`` of every leaf, keys sorted as ``jax.tree`` orders
    a dict; ``path`` joins the keys with ``/``."""
    if isinstance(specs, ParamSpec):
        return [(prefix, specs)]
    out = []
    for k in sorted(specs):
        out += spec_leaves(specs[k], f"{prefix}/{k}" if prefix else k)
    return out


def init_params(specs: Any, generator: torch.Generator, dtype: torch.dtype,
                device: "str | torch.device" = "cuda") -> Any:
    """Materialize a spec tree into parameters on ``device``.

    Leaves are drawn in ``jax.tree`` order from ``generator``, which draws
    on its own device (a CUDA generator draws on the card); the values are
    the port's own, not the JAX package's.  Same rule as the JAX package:
    ``normal`` is a fan-in scaled normal over the second-to-last dim,
    ``embed`` a plain normal times ``scale``; both drawn in f32, then cast.
    """
    dev = resolve_device(device)

    def one(spec: ParamSpec) -> Tensor:
        dt = getattr(torch, spec.dtype) if spec.dtype else dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        z = torch.randn(spec.shape, generator=generator,
                        dtype=torch.float32, device=generator.device)
        if spec.init == "embed":
            std = spec.scale
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = spec.scale / math.sqrt(max(fan_in, 1))
        return (z * std).to(device=dev, dtype=dt)

    return _map_specs(one, specs)


def _map_specs(fn, specs: Any) -> Any:
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: _map_specs(fn, specs[k]) for k in sorted(specs)}


def abstract_params(specs: Any, dtype: torch.dtype) -> Any:
    """``meta`` tensors of each spec's shape (nothing allocated): the
    spec's own ``dtype`` where it pins one, else ``dtype``."""
    return _map_specs(lambda s: torch.empty(
        s.shape, dtype=getattr(torch, s.dtype) if s.dtype else dtype,
        device="meta"), specs)


def axes_tree(specs: Any) -> Any:
    return _map_specs(lambda s: s.axes, specs)


def specs_to_shardings(specs: Any, mesh: Mesh, mode: str) -> Any:
    return _map_specs(lambda s: NamedSharding(
        mesh, logical_to_spec(s.axes, s.shape, mesh, mode)), specs)


def spec_param_count(specs: Any) -> int:
    return sum(int(math.prod(s.shape)) for _, s in spec_leaves(specs))


# -- layers -------------------------------------------------------------------


def rms_norm(x: Tensor, gamma: Tensor, eps: float) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def layer_norm(x: Tensor, gamma: Tensor, beta: Tensor, eps: float) -> Tensor:
    """Mean and (biased) variance in f32, normalized, cast back, then
    ``* gamma + beta`` in x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * gamma + beta


def swiglu(gate: Tensor, up: Tensor) -> Tensor:
    return torch.nn.functional.silu(gate) * up


def dense(x: Tensor, w: Tensor) -> Tensor:
    """x [..., d_in] @ w [d_in, ...out], accumulated in f32, in x's dtype.

    The JAX package asks for an f32 product and casts it back.  A bf16
    GEMM accumulates in f32 and rounds its output once, so the product
    runs in the operands' own dtype (on the card, PyTorch's
    ``allow_bf16_reduced_precision_reduction`` also lets cuBLAS round
    split-K partial sums).
    """
    out_shape = w.shape[1:]
    y = torch.matmul(x, w.reshape(w.shape[0], -1))
    return y.reshape(*x.shape[:-1], *out_shape).to(x.dtype)


def nll_sum(logits: Tensor, labels: Tensor, ignore: int = -100
            ) -> tuple[Tensor, Tensor]:
    """``(sum of the NLL over labels other than ignore, their count)``; the
    log-sum-exp and the picked logit in float32."""
    mask = labels != ignore
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, safe[..., None])[..., 0]
    return ((logz - picked) * mask).sum(), mask.sum()


def cross_entropy(logits: Tensor, labels: Tensor, ignore: int = -100
                  ) -> tuple[Tensor, Tensor]:
    """Mean CE over non-ignored labels.  Returns (loss, token_count)."""
    total, n = nll_sum(logits, labels, ignore)
    n = n.clamp(min=1)
    return total / n, n
