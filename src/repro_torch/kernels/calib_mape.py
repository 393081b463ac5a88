"""Grid-search MAPE kernel (the Self-Calibrator's hot spot), CUDA for Hopper.

Replaces: ``repro/kernels/calib_mape.py:calib_mape_grid_pallas`` (body
``_kernel``), the Pallas TPU kernel behind ``calibrate.evaluate_candidates``,
and its ``jax.vmap`` over a fleet's lanes (``core/twin.py``), where every
lane carries its own candidate grid: the candidates come as ``[C]``,
shared by every batch row, or as ``[L, C]`` rows, row ``l`` shared by the
``B / L`` consecutive batch rows of its group (a lane, or a lane's hosts in
the per-host refit), all in one launch.

Bound on an H100: the special-function units.  The utilization window is
read once (T*H floats, 160 KB for the E2 history of 144 bins x 277 hosts),
and each (bin, host) needs one ``logf`` and one ``expf`` per distinct
exponent ``r``: 2.6 M for the E2 window and its 64 values of ``r``, at 16
results a clock per SM on 132 SMs about 0.6 us.  The joint grid has 9216
candidates but only those 64 values of ``r`` (r is the slowest axis of its
meshgrid), so ``sum_h u^r`` is shared between candidates with equal ``r``.

Design (``csrc/calib_mape.cu``), two launches, one count:

- pass 1, a grid of (candidate tiles of 256, bin tiles, B) blocks: each
  block dedups ``r`` within its candidate tile (equal bits share one sum),
  stages ``log u`` and ``2u`` of its bins in shared memory in chunks of
  ``HOST_CHUNK`` hosts, forms every (bin, distinct r) sum and each bin's
  ``S2`` in a fixed order (one warp per sum, lanes over hosts and an
  xor-shuffle tree; one thread per sum when H < 32), and writes each
  candidate's relative errors over its bins, in bin order, to a
  ``[B, bin tiles, C]`` partial;
- pass 2 sums the partials in tile order, counts the nonzero bins of
  ``real`` and writes ``acc * (100 / n)``, or NaN when n = 0.

:func:`bin_tile` picks the bins per block so that pass 1 launches at least
two blocks an SM of an H100 where the window has the bins, counting the
rows of one candidate group (all B rows for shared candidates), so that a
fleet's lane is tiled, and summed, as that lane's call alone: the two give
the same bits.  No float atomics anywhere: the result is bitwise
reproducible, so the argmin downstream cannot flip between runs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

#: largest batch the kernel's grid z-dimension takes
MAX_BATCH = 65535

#: the kernel's tile limits, as ``csrc/calib_mape.cu`` states them: the
#: candidates of a tile, the bins of a block, the hosts staged per round,
#: the staged (bin, host) values, the (bin, slot) sums of a block, and the
#: host count from which one warp (not one thread) forms a sum
CAND_TILE = 256
MAX_BINS = 32
HOST_CHUNK = 512
STAGE = 2048
SUMS = 4096
WARP_HOSTS = 32

#: pass-1 blocks :func:`bin_tile` aims for: two per SM of an H100's 132
TARGET_BLOCKS = 264


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bin_tile(b: int, t: int, h: int, c: int) -> int:
    """Bins per pass-1 block for a ``[b, t, h]`` window and ``c`` candidates.

    As many as the block's shared memory takes, split evenly, unless fewer
    give at least ``TARGET_BLOCKS`` blocks; one bin per block at least.
    """
    if t <= 0:
        return 1
    cap = min(MAX_BINS, STAGE // max(1, min(h, HOST_CHUNK)),
              SUMS // (min(c, CAND_TILE) + 1))
    blocks_per_tile = max(1, b * _cdiv(c, CAND_TILE))
    n_tiles = min(t, max(_cdiv(t, cap), _cdiv(TARGET_BLOCKS, blocks_per_tile)))
    return _cdiv(t, n_tiles)


def _check(name: str, x: Tensor, device: torch.device, shape: tuple) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def candidate_group(b: int, r: Tensor) -> int:
    """Batch rows a candidate row serves: ``b`` for shared ``[C]``
    candidates, ``b / L`` for ``[L, C]`` rows (``L`` must divide ``b``)."""
    if r.dim() == 1:
        return b
    if r.dim() != 2 or r.shape[0] == 0 or b % r.shape[0]:
        raise ValueError(f"candidates must be [C] or [L, C] with L dividing the "
                         f"batch {b}; got {tuple(r.shape)}")
    return b // r.shape[0]


def calib_mape_grid_cuda(u_th: Tensor, real_power: Tensor, p_idle: Tensor,
                         p_max: Tensor, r: Tensor) -> Tensor:
    """``[B, C]`` MAPE [%] of every candidate, on the card.

    ``u_th`` ``[B, T, H]``, ``real_power`` ``[B, T]`` and the candidates,
    ``[C]`` or ``[L, C]`` rows with ``L`` dividing ``B``, must be contiguous
    float32 CUDA tensors on one device.
    """
    dev = u_th.device
    if dev.type != "cuda":
        raise ValueError(f"calib_mape_grid_cuda needs CUDA tensors, got {dev}")
    if u_th.dim() != 3:
        raise ValueError(f"u_th must be [B, T, H], got {tuple(u_th.shape)}")
    b, t, h = u_th.shape
    candidate_group(b, r)
    _check("u_th", u_th, dev, (b, t, h))
    _check("real_power", real_power, dev, (b, t))
    for name, x in (("p_idle", p_idle), ("p_max", p_max), ("r", r)):
        _check(name, x, dev, tuple(r.shape))
    if not 0 < b <= MAX_BATCH:
        raise ValueError(f"batch {b} outside [1, {MAX_BATCH}]")
    entry = _build.load("calib_mape").calib_mape_grid_launch
    return launch(entry, u_th, real_power, p_idle, p_max, r)


def launch(entry, u_th: Tensor, real_power: Tensor, p_idle: Tensor,
           p_max: Tensor, r: Tensor) -> Tensor:
    """Run the C entry point ``entry`` (``calib_mape_grid_launch`` of a
    built library) on checked operands: the bin tile (planned for one
    candidate group's rows), the partial scratch and the output are made
    here.  Raises if the launch fails."""
    dev = u_th.device
    b, t, h = u_th.shape
    c = r.shape[-1]
    group = candidate_group(b, r)
    tile = bin_tile(group, t, h, c)
    partial = torch.empty((b, _cdiv(t, tile), c), dtype=torch.float32, device=dev)
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(u_th.data_ptr(), real_power.data_ptr(), p_idle.data_ptr(),
                    p_max.data_ptr(), r.data_ptr(), partial.data_ptr(),
                    out.data_ptr(), b, t, h, c, tile, group, stream)
    if err != 0:
        raise RuntimeError(f"calib_mape_grid launch failed: CUDA error {err}")
    return out
