"""Launch shape shared by the warp-per-bin kernels, ``csrc/des_readout.cu``
and ``csrc/power_sim.cu``: blocks of ``WARPS`` warps, a warp per bin, and
a bin's hosts split across 2, 4 or 8 warps where the bins are too few to
fill the card.  Both wrappers take their split from :func:`warp_split`.
"""

from __future__ import annotations

#: warps a block and loads of ``u`` a thread has in flight, as both
#: kernels' sources state them (``kWarps``, ``kUnroll``)
WARPS = 8
UNROLL = 8

#: blocks :func:`warp_split` aims for: two per SM of an H100's 132
TARGET_BLOCKS = 264


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def warp_split(s: int, t: int, h: int) -> int:
    """Warps per bin (1, 2, 4 or 8) for ``s`` lanes of ``t`` bins x ``h`` hosts.

    A warp per bin (8 bins a block) unless that launches fewer than
    ``TARGET_BLOCKS`` blocks; then the least split that reaches it, but no
    more warps than the bin has slices of 32 hosts.  The E2 window (1, 36,
    277) gets 8, the E2 horizon (1, 2016, 277) 2, a what-if batch 1.
    """
    most = 1
    while most * 2 <= min(WARPS, cdiv(h, 32)):
        most *= 2
    split = 1
    while split < most and s * cdiv(t, WARPS // split) < TARGET_BLOCKS:
        split *= 2
    return split
