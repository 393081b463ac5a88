"""Mamba2 / SSD intra-chunk term and chunk-end states, CUDA for Hopper.

Replaces: ``repro/kernels/ssd_chunk.py:ssd_chunk_pallas`` (body
``_kernel``), the Pallas TPU kernel whose function ``models/mamba2``'s
``ssd_chunked`` computes for every chunk of every Mamba2 layer's prefill.

Bound on an H100 at Mamba2-370M's prefill shape (BC=64, Q=128, H=32,
P=64, G=1, N=128): the least work, ``C B^T`` once per (chunk, group) over
the causal triangle, is 6.70 GFLOP against 210.8 MB of operands.  At the
f32 rate outside the tensor cores (67 TFLOP/s) that is 0.0999 ms, bound by
operations; on this kernel's route, TF32 tensor cores in three passes
(495 / 3 = 165 TFLOP/s), 0.0629 ms, bound by bytes (3.35 TB/s).

The first design, one block per (chunk, head) with f32 products on the
CUDA cores, recomputed ``C B^T`` for every head of a group (14.0 GFLOP)
and ran at 18 TFLOP/s (0.78 ms).  Now one block per (chunk, group, slice
of up to 8 of the group's heads) forms ``C B^T`` once for the slice, tile
by causal tile, and keeps it in shared memory; each head applies its
decay to it (the exponential only where ``j <= i``) and accumulates
``att @ x``; the states are ``(x w)^T B``.  Every product runs on the
tensor cores as a 3xTF32 split (``a = a_hi + a_lo``, both TF32, and
``a_lo b_hi + a_hi b_lo + a_hi b_hi`` in f32), about 2^-21 relative per
product, which keeps the 1e-4 parity that one TF32 pass would break.
Sums run in a fixed order without atomics (bitwise repeatable).  The
chunk length is capped by shared memory (:func:`limits`), well above the
255 rows that ``ssd_chunked`` makes at most.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

#: largest product of chunks and heads (at least the kernel's grid size)
MAX_BLOCKS = 2 ** 31 - 1


@functools.lru_cache(maxsize=None)
def limits(device_index: int) -> tuple[int, int]:
    """``(longest chunk, largest head dim)`` the kernel takes on the card
    ``device_index``, as its library states them (the chunk length is set
    by the card's shared memory per block)."""
    lib = _build.load("ssd_chunk")
    max_q = lib.ssd_chunk_max_q(device_index)
    if max_q < 0:
        raise RuntimeError(f"ssd_chunk_max_q failed: CUDA error {-max_q}")
    return max_q, lib.ssd_chunk_max_p()


def ssd_chunk_cuda(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor,
                   c: Tensor, d_skip: Tensor) -> tuple[Tensor, Tensor]:
    """``(y_intra [BC, Q, H, P], states [BC, H, P, N])``, f32, on the card.

    ``x [BC, Q, H, P]``, ``dt [BC, Q, H]``, ``b/c [BC, Q, G, N]``: contiguous
    float32 CUDA tensors on one device, ``H % G == 0``, ``Q`` and ``P``
    within :func:`limits`.  ``a_log [H]`` and
    ``d_skip [H]`` may be in any float dtype: they are cast to float32.
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk_cuda needs CUDA tensors, got {dev}")
    if x.dim() != 4:
        raise ValueError(f"x must be [BC, Q, H, P], got {tuple(x.shape)}")
    bc, q, h, p = x.shape
    if b.dim() != 4 or b.shape[:2] != (bc, q):
        raise ValueError(f"b must be [{bc}, {q}, G, N], got {tuple(b.shape)}")
    g, n = b.shape[2], b.shape[3]
    for name, t, shape in (("dt", dt, (bc, q, h)), ("c", c, (bc, q, g, n)),
                           ("a_log", a_log, (h,)), ("d_skip", d_skip, (h,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if min(bc, q, h, p, g, n) == 0:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, b {tuple(b.shape)}")
    if h % g:
        raise ValueError(f"heads {h} must be a multiple of groups {g}")
    max_q, max_p = limits(dev.index if dev.index is not None
                          else torch.cuda.current_device())
    if p > max_p:
        raise ValueError(f"head dim {p} exceeds the kernel's {max_p}")
    if q > max_q:
        raise ValueError(f"chunk length {q} exceeds the kernel's {max_q} "
                         "(shared memory)")
    if bc * h > MAX_BLOCKS:
        raise ValueError(f"{bc} chunks x {h} heads exceed {MAX_BLOCKS} blocks")
    for name, t in (("x", x), ("dt", dt), ("b", b), ("c", c),
                    ("a_log", a_log), ("d_skip", d_skip)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    for name, t in (("x", x), ("dt", dt), ("b", b), ("c", c)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (a_log.is_floating_point() and d_skip.is_floating_point()):
        raise TypeError("a_log and d_skip must be floating point")
    a32 = a_log.to(torch.float32).contiguous()
    d32 = d_skip.to(torch.float32).contiguous()
    y = torch.empty((bc, q, h, p), dtype=torch.float32, device=dev)
    st = torch.empty((bc, h, p, n), dtype=torch.float32, device=dev)
    lib = _build.load("ssd_chunk")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_chunk_launch(
            x.data_ptr(), dt.data_ptr(), a32.data_ptr(), b.data_ptr(),
            c.data_ptr(), d32.data_ptr(), y.data_ptr(), st.data_ptr(),
            bc, q, h, p, g, n, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk launch failed: CUDA error {err}")
    return y, st
