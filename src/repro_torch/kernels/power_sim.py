"""Fused fleet power / energy / TFLOP/s map, CUDA for Hopper.

Replaces: ``repro/kernels/power_sim.py:power_sim_pallas`` (body
``_kernel``), the Pallas TPU kernel behind ``repro.kernels.ops.power_sim``.

Bound on an H100: bytes.  The kernel reads the ``[T, H]`` utilization
field once and writes three ``[T]`` rows; per element it does a clip, a
``logf``/``expf`` pair and a few adds.  At the E2 horizon (2016 bins x 277
hosts, 2.2 MB) that is 0.67 us of HBM time and 0.27 us of the
special-function units.

Design (``csrc/power_sim.cu``), the DES readout's: blocks of 8 warps, a
warp per bin with lanes striding over the hosts and several loads in
flight, an xor-shuffle butterfly, and each row of the block's results
written as consecutive floats; where the bins are too few to fill the
card, :func:`repro_torch.kernels._launch.warp_split` gives each bin 2,
4 or 8 warps, whose totals add in warp order.  No float atomics, so
results are bitwise repeatable.  The scalar constants come folded in
double from :func:`repro_torch.kernels.ref.power_sim_constants`, as the
TPU kernel folds its static Python floats.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import warp_split

Tensor = torch.Tensor

#: largest bin count (the kernel's grid x-dimension)
MAX_BINS = 2 ** 31 - 1


def power_sim_cuda(u_th: Tensor, *, r: float, base: float, span: float,
                   e_factor: float, peak: float) -> tuple[Tensor, Tensor, Tensor]:
    """``(power, energy, tflops)``, three ``[T]`` f32 rows, on the card.

    ``u_th`` must be a contiguous ``[T, H]`` float32 CUDA tensor with H > 0.
    """
    dev = u_th.device
    if dev.type != "cuda":
        raise ValueError(f"power_sim_cuda needs CUDA tensors, got {dev}")
    if u_th.dim() != 2 or u_th.shape[1] == 0:
        raise ValueError(f"u_th must be [T, H] with H > 0, got {tuple(u_th.shape)}")
    if u_th.dtype != torch.float32:
        raise TypeError(f"u_th must be float32, got {u_th.dtype}")
    if not u_th.is_contiguous():
        raise ValueError("u_th must be contiguous")
    t, h = u_th.shape
    if t > MAX_BINS:
        raise ValueError(f"{t} bins exceed {MAX_BINS}")
    out = torch.empty((3, t), dtype=torch.float32, device=dev)
    if t:
        lib = _build.load("power_sim")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.power_sim_launch(
                u_th.data_ptr(), out.data_ptr(), t, h, warp_split(1, t, h),
                float(r), float(base), float(span), float(e_factor),
                float(peak), stream)
        if err != 0:
            raise RuntimeError(f"power_sim launch failed: CUDA error {err}")
    return out[0], out[1], out[2]
