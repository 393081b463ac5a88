"""Multi-model / meta-model simulation (paper §2.2, M3SA; port of
``repro.core.metamodel``).

Runs the OpenDC model zoo (opendc / linear / sqrt / cubic) over the same
utilization field and combines their power predictions: mean, median, or
inverse-MAPE weighting (models that tracked recent telemetry better get
more weight).  The predictions run on the field's device; the combination
is host-side numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.power import PowerParams, datacenter_power, mape


@dataclasses.dataclass(frozen=True)
class MultiModelOutput:
    per_model: dict[str, np.ndarray]   # model name -> [T] power
    combined: np.ndarray               # [T] meta-model power
    weights: dict[str, float]


def run_multi_model(
    u_th: torch.Tensor,
    params: PowerParams,
    models: tuple[str, ...] = ("opendc", "linear", "sqrt", "cubic"),
) -> dict[str, np.ndarray]:
    """``[T]`` total power of each model over ``u_th [T, H]``, as numpy."""
    return {
        m: datacenter_power(u_th, params, model=m).detach().cpu().numpy()
        for m in models
    }


def combine(
    per_model: dict[str, np.ndarray],
    how: str = "mean",
    reference: np.ndarray | None = None,
) -> MultiModelOutput:
    """Combine the models' predictions (``reference``: measured power for
    ``how="inv_mape"``)."""
    names = sorted(per_model)
    stack = np.stack([per_model[n] for n in names])    # [M, T]
    if how == "mean":
        weights = {n: 1.0 / len(names) for n in names}
        comb = stack.mean(axis=0)
    elif how == "median":
        weights = {n: float("nan") for n in names}
        comb = np.median(stack, axis=0)
    elif how == "inv_mape":
        if reference is None:
            raise ValueError("inv_mape weighting needs reference telemetry")
        errs = np.array([
            float(mape(torch.as_tensor(np.asarray(reference, np.float32)),
                       torch.as_tensor(np.asarray(per_model[n], np.float32))))
            for n in names
        ])
        w = 1.0 / np.maximum(errs, 1e-6)
        w = w / w.sum()
        weights = dict(zip(names, w.tolist()))
        comb = (w[:, None] * stack).sum(axis=0)
    else:
        raise ValueError(f"unknown combiner {how!r}")
    return MultiModelOutput(per_model=per_model, combined=comb, weights=weights)
