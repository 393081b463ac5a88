"""Fused DES readout kernel: the per-bin metric pipeline, CUDA for Hopper.

Replaces: ``repro/kernels/des_readout.py:des_readout_pallas`` (body
``_tile_readout``), the Pallas TPU kernel behind ``desim.predict_metrics``.

Bound on an H100: bytes at the main path's shape.  The kernel reads the
``[T, H]`` utilization field once plus a few ``[H]`` rows and ``[T]``
columns and writes 9 ``[T]`` leaves; per element it does a handful of
flops and one ``expf``/``logf`` pair (opendc model).  At the twin's window
(36 bins x 277 hosts, 40 KB) that is far below a microsecond of HBM time,
so in practice the launch itself is the floor.

Design: one block per bin row, 256 threads striding over the hosts with
four register sums (IT demand, idle floor, sum u*on, sum on), a
shared-memory tree reduction in fixed order, and one thread for the per-bin
tail (PUE, cap, throttle, energy, tflops/efficiency, gCO2, cost).  The
field is read once and no ``[T, H]`` intermediate (power map, online mask)
is ever written.  The failure-aware online mask is rebuilt from the bin
index and the per-host failure rows, as the TPU kernel does with iota.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import READOUT_FIELDS

Tensor = torch.Tensor

#: power model -> kernel parameter
MODEL_IDS = {"opendc": 0, "linear": 1, "sqrt": 2, "cubic": 3}

#: precision policy -> kernel parameter (1 = bf16 tflops/efficiency)
PRECISION_IDS = {"f32": 0, "bf16": 1}


def des_readout_cuda(u_th: Tensor, *, p_idle: Tensor, p_max: Tensor,
                     r: Tensor, mask: Tensor, fail_start: Tensor,
                     fail_end: Tensor, fail_kill: Tensor, cap: Tensor,
                     intensity: Tensor, ambient: Tensor, price: Tensor,
                     peak_tflops: float, pue_base: float,
                     pue_load_coeff: float, pue_amb_coeff: float,
                     pue_amb_ref: float, model: str, precision: str,
                     dt_seconds: float) -> dict[str, Tensor]:
    """The 9 readout leaves ``[T]`` on the card (operands as in the ref)."""
    dev = u_th.device
    if dev.type != "cuda":
        raise ValueError(f"des_readout_cuda needs CUDA tensors, got {dev}")
    if u_th.dim() != 2:
        raise ValueError(f"u_th must be [T, H], got {tuple(u_th.shape)}")
    t, h = u_th.shape
    rows = dict(p_idle=p_idle, p_max=p_max, r=r, mask=mask,
                fail_start=fail_start, fail_end=fail_end, fail_kill=fail_kill)
    cols = dict(cap=cap, intensity=intensity, ambient=ambient, price=price)
    for name, x in dict(u_th=u_th, **rows, **cols).items():
        want = (t, h) if name == "u_th" else (h,) if name in rows else (t,)
        dtype = torch.int32 if name in ("fail_start", "fail_end") else torch.float32
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != want \
                or not x.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor of shape {want} "
                f"on {dev}; got {x.dtype} {tuple(x.shape)} on {x.device}")
    out = torch.empty((len(READOUT_FIELDS), t), dtype=torch.float32, device=dev)
    lib = _build.load("des_readout")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.des_readout_launch(
            u_th.data_ptr(), p_idle.data_ptr(), p_max.data_ptr(), r.data_ptr(),
            mask.data_ptr(), fail_start.data_ptr(), fail_end.data_ptr(),
            fail_kill.data_ptr(), cap.data_ptr(), intensity.data_ptr(),
            ambient.data_ptr(), price.data_ptr(), out.data_ptr(), t, h,
            MODEL_IDS[model], PRECISION_IDS[precision], float(peak_tflops),
            float(pue_base), float(pue_load_coeff), float(pue_amb_coeff),
            float(pue_amb_ref), float(dt_seconds / 3600.0), stream)
    if err != 0:
        raise RuntimeError(f"des_readout launch failed: CUDA error {err}")
    return dict(zip(READOUT_FIELDS, out.unbind(0)))
