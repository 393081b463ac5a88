"""Seeds of the inputs: every stream of numbers a run draws comes from
``--seed`` and the stream's own number, so one seed gives one set of
inputs, whatever the size of the seed."""

from __future__ import annotations

import numpy as np

#: streams of a run: the weeks of the pool, the hidden power models, the
#: sample the output check takes
WEEKS, TRUTH, SAMPLE = 1, 2, 3


def derive(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit seed for item ``index`` of ``stream``."""
    ss = np.random.SeedSequence([int(seed) % 2**64, stream, index])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, stream))
