"""Deterministic synthetic LM token pipeline (port of ``repro.data.tokens``).

Seeded, restartable (cursor = step index), and shard-aware: every data
shard computes only its slice of the global batch from (seed, step,
shard), so the step counter is all a checkpoint needs to resume the data.

The stream is skewed-Zipf tokens with local bigram structure (with
p = 0.25 a token repeats the previous one + 1), so training losses move.
The marginal, the bigram rule, the keys, dtypes and shapes are the JAX
package's.  The draws are not: they come from a CPU ``torch.Generator``
seeded from (seed, step, shard), not ``jax.random``, so the same step
gives other tokens than in the JAX package (parity tests feed both the
JAX package's batches).  Tokens are drawn with ``torch.multinomial`` on
the ``[V]`` probabilities, never from ``[B, S+1, V]`` broadcast logits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device

Tensor = torch.Tensor

#: probability that a token repeats the previous token + 1
REPEAT_P = 0.25


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 17
    zipf_a: float = 1.2


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return (p / p.sum()).astype(np.float32)


def _draw_seed(seed: int, step: int, shard: int) -> int:
    """A 63-bit generator seed from (seed, step, shard)."""
    state = np.random.SeedSequence((seed, step, shard)).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


class TokenPipeline:
    """Stateless-per-step batch synthesis: batch(step) is pure."""

    def __init__(self, cfg: DataConfig, device: "str | torch.device" = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._probs = torch.from_numpy(_zipf_probs(cfg.vocab, cfg.zipf_a))

    def batch(self, step: int, shard: int = 0, num_shards: int = 1
              ) -> dict[str, Tensor]:
        """Global batch slice for ``shard``: int32 tokens + next-token labels,
        ``[global_batch / num_shards, seq_len]`` each, on the pipeline's device."""
        cfg = self.cfg
        if cfg.global_batch % num_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not split "
                             f"into {num_shards} shards")
        local = cfg.global_batch // num_shards
        n = cfg.seq_len + 1
        gen = torch.Generator().manual_seed(_draw_seed(cfg.seed, step, shard))
        toks = torch.multinomial(self._probs, local * n, replacement=True,
                                 generator=gen).reshape(local, n)
        rep = torch.rand((local, n), generator=gen) < REPEAT_P
        shifted = torch.roll(toks, 1, dims=1) + 1
        toks = torch.where(rep, shifted % cfg.vocab, toks).to(torch.int32)
        toks = toks.to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def global_batch(self, step: int) -> dict[str, Tensor]:
        return self.batch(step, shard=0, num_shards=1)
