"""Grid-search MAPE kernel (the Self-Calibrator's hot spot), CUDA for Hopper.

Replaces: ``repro/kernels/calib_mape.py:calib_mape_grid_pallas`` (body
``_kernel``), the Pallas TPU kernel behind ``calibrate.evaluate_candidates``.

Bound on an H100: operations, not bytes.  The utilization window is read
once (T*H floats, 160 KB for the E2 history of 144 bins x 277 hosts), while
every candidate evaluates one ``expf`` per (bin, host): B*T*H*C
exponentials, 2.6 M for the r-only grid of 64 candidates and 368 M for the
joint grid of 9216.  ``expf`` runs on the special-function units, so the
special-function throughput sets the floor.

Design: one thread per candidate, a grid of ``(ceil(C/128), B)`` blocks, so
a batch of windows (the per-host refit, B = H problems of ``[T, 1]``) is one
launch.  Each block walks the bins in order, stages ``log(u)`` and ``2u``
of a bin's hosts in shared memory once for all its 128 candidates, and
every thread keeps its error sum in a register: nothing ``[C, T]``-shaped
exists, and with no float atomics the sums are bitwise reproducible, so the
argmin downstream cannot flip between runs.  The price of that simplicity
is parallelism: with C = 64 the launch is one block.  Sharing ``sum_h u^r``
between candidates with equal ``r`` (the joint grid has 64 distinct values
among 9216 candidates) and splitting the bins across blocks with a
fixed-order second pass are the next steps.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

#: largest batch the kernel's grid y-dimension takes
MAX_BATCH = 65535


def _check(name: str, x: Tensor, device: torch.device, shape: tuple) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def calib_mape_grid_cuda(u_th: Tensor, real_power: Tensor, p_idle: Tensor,
                         p_max: Tensor, r: Tensor) -> Tensor:
    """``[B, C]`` MAPE [%] of every candidate, on the card.

    ``u_th`` ``[B, T, H]``, ``real_power`` ``[B, T]`` and the candidate rows
    ``[C]`` must be contiguous float32 CUDA tensors on one device.
    """
    dev = u_th.device
    if dev.type != "cuda":
        raise ValueError(f"calib_mape_grid_cuda needs CUDA tensors, got {dev}")
    if u_th.dim() != 3:
        raise ValueError(f"u_th must be [B, T, H], got {tuple(u_th.shape)}")
    b, t, h = u_th.shape
    c = r.shape[0] if r.dim() == 1 else -1
    _check("u_th", u_th, dev, (b, t, h))
    _check("real_power", real_power, dev, (b, t))
    for name, x in (("p_idle", p_idle), ("p_max", p_max), ("r", r)):
        _check(name, x, dev, (c,))
    if not 0 < b <= MAX_BATCH:
        raise ValueError(f"batch {b} outside [1, {MAX_BATCH}]")
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    lib = _build.load("calib_mape")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.calib_mape_grid_launch(
            u_th.data_ptr(), real_power.data_ptr(), p_idle.data_ptr(),
            p_max.data_ptr(), r.data_ptr(), out.data_ptr(), b, t, h, c, stream)
    if err != 0:
        raise RuntimeError(f"calib_mape_grid launch failed: CUDA error {err}")
    n_nz = (real_power.abs() > 1e-9).sum(dim=1)
    scaled = out * (100.0 / n_nz.clamp(min=1).float())[:, None]
    return torch.where(n_nz[:, None] > 0, scaled,
                       torch.full_like(scaled, float("nan")))
