"""Carry state across from numpy arrays into the port's types.

Any object with the right attributes works as a source (numpy arrays, or
anything ``numpy.asarray`` reads), so state exported by another
implementation of the twin starts the port from identical values.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import flatten, leaves
from repro_torch.configs.base import ModelConfig
from repro_torch.core.power import PowerParams
from repro_torch.core.state import TwinConfig, TwinState, state_from_leaves
from repro_torch.models.common import ParamSpec
from repro_torch.models.encdec import encdec_specs
from repro_torch.models.lm import model_specs
from repro_torch.optim.adamw import OptState
from repro_torch.traces.schema import Workload


def _t(x, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(np.asarray(x), dtype=dtype), device=dev)


def workload_from_numpy(w, device: "str | torch.device" = "cuda") -> Workload:
    """A :class:`Workload` from an object with the trace's array attributes."""
    dev = resolve_device(device)
    return Workload(
        submit_bin=_t(w.submit_bin, np.int32, dev),
        duration_bins=_t(w.duration_bins, np.int32, dev),
        cores=_t(w.cores, np.int32, dev),
        util_levels=_t(w.util_levels, np.float32, dev),
        valid=_t(w.valid, bool, dev),
        deferrable=(None if getattr(w, "deferrable", None) is None
                    else _t(w.deferrable, bool, dev)),
    )


def power_params_from_numpy(p, device: "str | torch.device" = "cuda") -> PowerParams:
    """:class:`PowerParams` of float32 tensors from ``p_idle/p_max/r`` arrays."""
    dev = resolve_device(device)
    return PowerParams(p_idle=_t(p.p_idle, np.float32, dev),
                       p_max=_t(p.p_max, np.float32, dev),
                       r=_t(p.r, np.float32, dev))


def twin_state_from_numpy(leaves, cfg: TwinConfig) -> TwinState:
    """A :class:`TwinState` on ``cfg.device`` from flat state leaves.

    ``leaves`` is the state's flat leaf list: ``params``, ``base_params``
    and ``cand`` as three ``(p_idle, p_max, r)`` groups, then ``hist_u``,
    ``hist_p``, ``hist_n``, ``window``, ``slo_samples``, ``slo_compliant``,
    ``bias_under``, ``bias_over``, ``bias_ties`` (18 arrays), and with
    ``cfg.sim_bins > 0`` the resident DES field ``sim_u`` (19 arrays).
    A fleet's leaves (the JAX package's ``stack_twin_states``) lead with
    ``[D]`` and give a fleet state.
    """
    return state_from_leaves(leaves, cfg)


def lm_params_from_numpy(tree, cfg: ModelConfig,
                         device: "str | torch.device" = "cuda",
                         dtype: "torch.dtype | str | None" = None) -> dict:
    """The LM's parameters from a nested dict of arrays.

    ``tree`` has the layout of ``model_specs(cfg)`` (the JAX package's
    parameter tree, leaves as numpy arrays: any decoder-only family, MoE
    with its padded experts, MLA and VLM included); every leaf must have
    its spec's shape.  Leaves go through float32, which holds bfloat16
    values (``ml_dtypes`` arrays, which ``torch.from_numpy`` refuses)
    exactly, then to ``dtype`` (default: ``cfg.dtype``) on ``device``.
    """
    return _params_from_numpy(tree, model_specs(cfg), cfg, device, dtype)


def encdec_params_from_numpy(tree, cfg: ModelConfig,
                             device: "str | torch.device" = "cuda",
                             dtype: "torch.dtype | str | None" = None) -> dict:
    """The enc-dec backbone's parameters from a nested dict of arrays of
    the layout of ``encdec_specs(cfg)``, as :func:`lm_params_from_numpy`."""
    return _params_from_numpy(tree, encdec_specs(cfg), cfg, device, dtype)


def _params_from_numpy(tree, specs, cfg: ModelConfig, device, dtype) -> dict:
    dev = resolve_device(device)
    if not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, dtype or cfg.dtype)

    def convert(node, spec, path):
        if isinstance(spec, ParamSpec):
            x = np.asarray(node)
            if x.shape != spec.shape:
                raise ValueError(f"parameter {path!r}: shape {x.shape}, "
                                 f"expected {spec.shape}")
            return torch.from_numpy(np.array(x, dtype=np.float32)).to(
                device=dev, dtype=dtype)
        missing = sorted(set(spec) - set(node))
        if missing:
            raise KeyError(f"parameters {missing} missing under {path or '/'!r}")
        return {k: convert(node[k], spec[k], f"{path}/{k}" if path else k)
                for k in spec}

    return convert(tree, specs, "")


def opt_state_from_numpy(tree, params, device: "str | torch.device" = "cuda"
                         ) -> OptState:
    """An :class:`OptState` on ``device`` from ``(step, mu, nu)`` arrays.

    ``tree`` is the JAX package's ``OptState`` as numpy (or its
    checkpointed form, a ``[step, mu, nu]`` list); ``mu`` and ``nu`` have
    the layout of ``params`` (the port's parameter tree, whose leaves give
    the shapes).  The moments keep their own dtype (bfloat16 moments go
    through float32, which holds them exactly), the step is int32.
    """
    dev = resolve_device(device)
    step, mu, nu = tree
    shapes = [tuple(p.shape) for p in leaves(params)]
    _, unflatten = flatten(params)

    def moments(node, what):
        flat = leaves(node)
        if [tuple(np.shape(x)) for x in flat] != shapes:
            raise ValueError(f"{what} does not have the parameters' layout")
        out = []
        for x in flat:
            a = np.asarray(x)
            dt = getattr(torch, str(a.dtype))
            out.append(torch.from_numpy(np.array(a, dtype=np.float32)).to(
                device=dev, dtype=dt))
        return unflatten(out)

    return OptState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                      device=dev),
                    mu=moments(mu, "mu"), nu=moments(nu, "nu"))
