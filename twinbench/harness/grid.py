"""Traffic-file helpers: a product of axes, and a seeded reservoir sample."""

from __future__ import annotations

import itertools


def expand(axes: list) -> list[dict]:
    """Every combination of ``axes`` (``[[key, [values...]], ...]``, the
    first key outermost) as dicts, in order."""
    keys = [k for k, _ in axes]
    return [dict(zip(keys, combo)) for combo in itertools.product(*(v for _, v in axes))]


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length
    (Algorithm R), drawn with ``rng``: ``offer`` each item in turn."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen = int(k), rng, 0
        self.items: list = []

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1
