"""Causal GQA flash-attention forward, CUDA for Hopper.

Replaces: ``repro/kernels/flash_attention.py:flash_attention_pallas``
(body ``_kernel``), the Pallas TPU kernel behind
``models/attention.chunked_attention``.

Bound on an H100: operations.  At the prefill shape of SmolLM-360M
(B=4, Hq=15, Hkv=5, S=2048, D=64, causal) the two products take
4*B*Hq*S^2*D/2 = 32.2 GFLOP against 25 MB of q/k/v/o, so the floor is the
tensor cores' bf16 rate: 0.0326 ms at 989 TFLOP/s.

The QK head dim ``D`` and the V head dim ``Dv`` are separate template
parameters of both routes, and the output is ``[B, Hq, Sq, Dv]``: MLA
(MiniCPM3-4B, DeepSeek-V2-Lite) attends with QK ``qk_nope + qk_rope`` and
V ``v_head_dim``.  The TPU kernel tiles V with K's width; the JAX package
runs MLA on its XLA route, which takes the two dims natively.  Every pair
with ``1 <= D, Dv <= 256`` runs: the :data:`HEAD_DIM_PAIRS` on their own
instantiations, any other padded, on the instantiation
:func:`instantiation_for` picks (the pair of :data:`PADDED_PAIRS` of least
``Dp + Dvp`` that holds it), which takes the true widths as arguments,
zero-fills the padding columns of Q, K and V in shared memory and stores
only the first ``Dv`` output columns (``reduce_config`` gives such pairs:
MiniCPM3-4B's (16, 8) at ``--reduce 8`` runs on (16, 16), StableLM-3B's
(40, 40) at ``--reduce 2`` on (64, 64)).  A padded pair does the products
of its instantiation: more than ``ops.flash_attention_flops`` counts.

The library picks a route by dtype.  bfloat16, which every prefill hands
it, runs on the tensor cores: one block of 4 warps per (64-row query
tile, query head, batch row), K/V tiles kept bf16 in shared memory in a
two-stage ``cp.async`` ring, ``S = Q K^T`` and ``P V`` as
``mma.sync.m16n8k16`` with f32 accumulation, the online softmax on the
accumulator fragments, and ``P`` rounded to bf16 in registers as ``P V``'s
A operand.  The first design (kept for float32) staged K/V as f32 and
formed scalar dot products on the CUDA cores, two threads per query row:
at 21 TFLOP/s it took 1.51 ms, 16x SDPA, because the tensor cores never
ran.  float32 stays on that kernel: the card-vs-CPU checks hold f32
logits at 1e-4, which bf16 products cannot meet.  Both routes skip KV
tiles above the causal diagonal, read KV head ``hq / group`` in place and
sum in a fixed order (bitwise repeatable).  bf16 numerics against the TPU
kernel: ``P`` is rounded to bf16 before ``P V``, the scale multiplies
``S`` in f32 instead of ``q``, and the sums run in another order.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

#: (QK head dim, V head dim) pairs the kernel is instantiated for exactly:
#: equal dims of the GQA configs (SmolLM, Zamba2 64; StableLM-3B 80; 128),
#: and the MLA pairs of MiniCPM3-4B (96, 64) and DeepSeek-V2-Lite (192, 128)
#: (the source's ``FLASH_PAIR`` list)
HEAD_DIM_PAIRS = ((16, 16), (32, 32), (64, 64), (128, 128), (80, 80),
                  (96, 64), (192, 128))

#: the largest QK and V head dim the kernel takes
MAX_HEAD_DIM = 256

#: the padded instantiations, in the order the source's ``FLASH_PADDED``
#: list tries them: by ``Dp + Dvp``, then ``Dp``
PADDED_PAIRS = tuple(sorted(HEAD_DIM_PAIRS + ((MAX_HEAD_DIM, MAX_HEAD_DIM),),
                            key=lambda p: (p[0] + p[1], p[0])))

#: largest grid y/z dimension (query heads, batch)
MAX_GRID_YZ = 65535

#: input dtype -> kernel parameter
DTYPE_IDS = {
    torch.float32: 0,
    torch.bfloat16: 1,  # tracecheck: disable=TC005 — attention operand dtype of the LM, not twin math
}


def instantiation_for(d: int, dv: int) -> tuple[int, int]:
    """The instantiated ``(Dp, Dvp)`` that runs head dims ``(d, dv)``: the
    first of :data:`PADDED_PAIRS` with ``Dp >= d`` and ``Dvp >= dv``, the
    one of least ``Dp + Dvp`` (an exact pair is its own).  Raises
    ``ValueError`` outside ``1..256``."""
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims (QK {d}, V {dv}) must lie in 1..{MAX_HEAD_DIM}")
    return next(p for p in PADDED_PAIRS if p[0] >= d and p[1] >= dv)


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                         scale: float, return_lse: bool = False
                         ) -> Tensor | tuple[Tensor, Tensor]:
    """``[B, Hq, Sq, Dv]`` attention output on the card, in q's dtype.

    q ``[B, Hq, Sq, D]``, k ``[B, Hkv, Skv, D]``, v ``[B, Hkv, Skv, Dv]``:
    contiguous CUDA tensors of one dtype (float32 or bfloat16) on one
    device, ``Hq % Hkv == 0`` and ``1 <= D, Dv <= 256`` (a pair outside
    :data:`HEAD_DIM_PAIRS` runs padded, :func:`instantiation_for`; one
    launch either way).  With ``return_lse`` the result is
    ``(out, lse)``: ``lse`` ``[B, Hq, Sq]`` float32 is each row's
    ``m + log(max(l, 1e-30))`` over the scaled logits, from the kernel's
    f32 statistics, written by the same launch.
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, H, S, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(k.shape) != (b, hkv, skv, d) or tuple(v.shape[:3]) != (b, hkv, skv):
        raise ValueError(f"k and v must be [{b}, Hkv, Skv, {d}] and [{b}, Hkv, "
                         f"Skv, Dv]; got {tuple(k.shape)} and {tuple(v.shape)}")
    if skv == 0:
        raise ValueError("k and v hold no keys (Skv = 0)")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"query heads {hq} must be a multiple of KV heads {hkv}")
    instantiation_for(d, dv)             # raises outside 1..MAX_HEAD_DIM
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
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=dev)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if q.dtype != torch.float32 and (d, dv) in HEAD_DIM_PAIRS:
        # an exact pair's bf16 route copies 16-byte chunks: a view that
        # starts off a 16-byte boundary is copied to a fresh (aligned)
        # allocation; a padded pair's copies follow each operand's own
        # alignment (2 bytes at least)
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    lib = _build.load("flash_attention")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, hq, hkv, sq, skv, d, dv,
            DTYPE_IDS[q.dtype], int(bool(causal)), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return (out, lse) if return_lse else out
