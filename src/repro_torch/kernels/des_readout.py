"""Fused DES readout kernel: the per-bin metric pipeline, CUDA for Hopper.

Replaces: ``repro/kernels/des_readout.py:des_readout_pallas`` (body
``_tile_readout``), the Pallas TPU kernel behind ``desim.predict_metrics``,
and its ``jax.vmap`` over scenarios in ``scenarios._scenario_lanes``: the
kernel takes the scenario (lane) axis itself, ``u`` ``[S, T, H]`` with
per-lane host rows, caps and scalars, in one launch.

Bound on an H100: bytes where the field is large.  The kernel reads the
``[S, T, H]`` utilization field once plus the operands' own elements and
writes 9 ``[S, T]`` leaves; per element it does a handful of flops and,
under the opendc model, one ``logf`` and one ``expf``.  A week of the
paper's cluster under 64 what-if lanes (143 MB) is about 44 us of HBM
time and 17 us of the special-function units; the twin's window (36 bins
x 277 hosts, 40 KB) is far below the launch floor.  The kernel's
instructions an element (the accurate ``logf`` and ``expf``, the float64
sums, the staged rows) make it bound by instruction issue at that size,
not by bytes (PERF.md).

Design (``csrc/des_readout.cu``): blocks of 8 warps over (bins, lanes); a
warp per (lane, bin), lanes striding over the hosts with several loads of
``u`` in flight, an xor-shuffle butterfly, no barrier between bins; the
lane's host rows staged once per block in shared memory (chunks of
``HOST_CHUNK`` hosts), or not at all where every row is one number (the
twin's window: 1.0 us less at the E2 window, 1.7 us at the horizon, than
staging them, PERF.md); the block's results written field by field as
consecutive floats.  Where lanes x bins are too few to fill the card,
:func:`warp_split` gives each bin 2, 4 or 8 warps, whose totals add in
warp order.  The four host sums are float64 (exact terms, rounded once),
as the plain version's.  No
``[T, H]`` intermediate (power map, online mask) is ever written; the
online mask is rebuilt from the bin index and the outage window, as the
TPU kernel does with iota.

An operand that is the same for every lane and host stays a kernel
argument (no device tensor); one shared by the lanes or hosts is a
stride-0 view.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import warp_split
from repro_torch.kernels.ref import READOUT_FIELDS

Tensor = torch.Tensor

#: power model -> kernel parameter
MODEL_IDS = {"opendc": 0, "linear": 1, "sqrt": 2, "cubic": 3}

#: precision policy -> kernel parameter (1 = bf16 tflops/efficiency)
PRECISION_IDS = {"f32": 0, "bf16": 1}

#: the kernel's staging limits, as ``csrc/des_readout.cu`` states them:
#: hosts staged a round, lanes (the grid's y-dimension)
HOST_CHUNK = 1024
MAX_LANES = 65535

#: the readout's operands by kind: host rows ``[S, H]``, bin columns
#: ``[S, T]``, lane scalars ``[S]``
ROWS = ("p_idle", "p_max", "r", "mask", "fail_start", "fail_end", "fail_kill")
COLUMNS = ("cap", "intensity", "ambient", "price")
LANE_SCALARS = ("peak_tflops", "pue_base", "pue_load_coeff", "pue_amb_coeff",
                "pue_amb_ref")

#: int32 operands (bin indices); every other operand is float32
INT_OPERANDS = ("fail_start", "fail_end")


class Operand(ctypes.Structure):
    """``Operand`` of ``csrc/des_readout.cu``: a pointer with its lane and
    host/bin strides in elements, or no pointer and a uniform value."""

    _fields_ = [("ptr", ctypes.c_void_p), ("lane_stride", ctypes.c_longlong),
                ("stride", ctypes.c_longlong), ("value", ctypes.c_float),
                ("ivalue", ctypes.c_int)]


class ReadoutArgs(ctypes.Structure):
    """``ReadoutArgs`` of ``csrc/des_readout.cu``, field for field."""

    _fields_ = ([("u", ctypes.c_void_p), ("out", ctypes.c_void_p)]
                + [(name, Operand) for name in ROWS + COLUMNS + LANE_SCALARS]
                + [(name, ctypes.c_int) for name in
                   ("S", "T", "H", "model", "bf16", "split")]
                + [("dt_factor", ctypes.c_float)])


def _operand(name: str, x, shape: tuple, dev: torch.device) -> Operand:
    """The descriptor of operand ``x``: a tensor of ``shape`` (any strides)
    on ``dev``, or a Python number."""
    dtype = torch.int32 if name in INT_OPERANDS else torch.float32
    if isinstance(x, Tensor):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name} must be a {dtype} tensor of shape {shape} on {dev}; "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        strides = x.stride() + (0,) * (2 - x.dim())
        return Operand(x.data_ptr(), strides[0], strides[1], 0.0, 0)
    if dtype == torch.int32:
        return Operand(None, 0, 0, 0.0, int(x))
    return Operand(None, 0, 0, float(x), 0)


def des_readout_cuda(u_th: Tensor, **operands) -> dict[str, Tensor]:
    """The 9 readout leaves ``[S, T]`` on the card, in one launch.

    ``u_th`` is a contiguous ``[S, T, H]`` float32 CUDA tensor; the other
    operands are as :func:`repro_torch.kernels.ops.pack_readout` gives
    them: host rows ``[S, H]``, bin columns ``[S, T]`` and lane scalars
    ``[S]`` (float32, ``fail_start``/``fail_end`` int32, any strides), or
    Python numbers.
    """
    dev = u_th.device
    if dev.type != "cuda":
        raise ValueError(f"des_readout_cuda needs CUDA tensors, got {dev}")
    if u_th.dim() != 3 or u_th.dtype != torch.float32 or not u_th.is_contiguous():
        raise ValueError(f"u_th must be a contiguous float32 [S, T, H] tensor, "
                         f"got {u_th.dtype} {tuple(u_th.shape)}")
    s, t, h = u_th.shape
    if not 0 < s <= MAX_LANES:
        raise ValueError(f"{s} lanes outside [1, {MAX_LANES}]")
    entry = _build.load("des_readout").des_readout_launch
    out = launch(entry, u_th, operands)
    return dict(zip(READOUT_FIELDS, out.unbind(0)))


def launch(entry, u_th: Tensor, operands: dict, split: int | None = None) -> Tensor:
    """Run the C entry point ``entry`` (``des_readout_launch`` of a built
    library) on ``u_th`` ``[S, T, H]`` and ``operands``; the output
    ``[9, S, T]`` is made here, the split is :func:`warp_split`'s unless
    given.  Raises if an operand does not fit or the launch fails."""
    dev = u_th.device
    s, t, h = u_th.shape
    shapes = {**{k: (s, h) for k in ROWS}, **{k: (s, t) for k in COLUMNS},
              **{k: (s,) for k in LANE_SCALARS}}
    descs = {k: _operand(k, operands[k], shape, dev) for k, shape in shapes.items()}
    out = torch.empty((len(READOUT_FIELDS), s, t), dtype=torch.float32, device=dev)
    args = ReadoutArgs(
        u=u_th.data_ptr(), out=out.data_ptr(), **descs, S=s, T=t, H=h,
        model=MODEL_IDS[operands["model"]],
        bf16=PRECISION_IDS[operands["precision"]],
        split=warp_split(s, t, h) if split is None else split,
        dt_factor=operands["dt_seconds"] / 3600.0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f"des_readout launch failed: CUDA error {err}")
    return out
