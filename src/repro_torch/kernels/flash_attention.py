"""Causal GQA flash-attention forward, CUDA for Hopper.

Replaces: ``repro/kernels/flash_attention.py:flash_attention_pallas``
(body ``_kernel``), the Pallas TPU kernel behind
``models/attention.chunked_attention``.

Bound on an H100: operations.  At the prefill shape of SmolLM-360M
(B=4, Hq=15, Hkv=5, S=2048, D=64, causal) the two products take
4*B*Hq*S^2*D/2 = 32 GFLOP against 25 MB of q/k/v/o, so the floor is the
tensor cores' bf16 rate (about 33 us at 989 TFLOP/s).

Design (simple first, as the TPU kernel's blocking): one block of 128
threads per (64-row query tile, query head, batch row), two threads per
query row, each holding half of the row's scaled q and of its f32
accumulator in registers, with the row's running max ``m`` and sum ``l``.
The block walks the 64-row K/V tiles up to the causal diagonal (tiles
strictly above it are skipped, as ``pl.when`` skips them), staging each
tile in shared memory as f32; the query head ``hq`` reads KV head
``hq / group`` in place, with no head expansion.  The two threads of a
row add their half dot products with one shuffle, in a fixed order, so
results are bitwise repeatable.  The products run on the CUDA cores in
f32; tensor cores (``mma``/``wgmma``) and TMA are the next step.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)

#: rows of a query tile and of a K/V tile
Q_TILE = 64
KV_TILE = 64

#: largest grid y/z dimension (query heads, batch)
MAX_GRID_YZ = 65535

#: input dtype -> kernel parameter
DTYPE_IDS = {
    torch.float32: 0,
    torch.bfloat16: 1,  # tracecheck: disable=TC005 — attention operand dtype of the LM, not twin math
}


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                         scale: float) -> Tensor:
    """``[B, Hq, Sq, D]`` attention output on the card, in q's dtype.

    q ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Skv, D]``: contiguous CUDA tensors
    of one dtype (float32 or bfloat16) on one device, ``Hq % Hkv == 0``
    and ``D`` in :data:`HEAD_DIMS`.
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, H, S, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, hkv, skv, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must both be [{b}, Hkv, Skv, {d}]; got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if skv == 0:
        raise ValueError("k and v hold no keys (Skv = 0)")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"query heads {hq} must be a multiple of KV heads {hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPE_IDS:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hq > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"Hq {hq} and B {b} must be at most {MAX_GRID_YZ}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, skv, d, DTYPE_IDS[q.dtype], int(bool(causal)),
            float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out
