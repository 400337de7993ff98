"""Synthetic tokenized data pipeline.

No HF hub offline, so the SFT corpus is synthetic — but *learnable*: token
streams are generated by a fixed random bigram/Markov chain (per-client
chains differ under non-IID partitioning), so cross-entropy has real
structure to learn and the Fig. 4/5 convergence comparisons are
meaningful (loss decreases toward the chain's entropy, identically for
centralized and FL runs given the same data).
"""
from __future__ import annotations

from collections.abc import Iterator
from typing import Optional

import numpy as np


class SyntheticLMDataset:
    """Markov-chain language modelling dataset."""

    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        *,
        seed: int = 0,
        branching: int = 4,
        num_modes: int = 1,
        mode: int = 0,
    ) -> None:
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        rng = np.random.default_rng(seed)
        # transition table: each token can be followed by `branching`
        # successors; `mode` selects a shifted table (non-IID clients)
        self._succ = rng.integers(0, vocab_size, size=(num_modes, vocab_size, branching))
        self._mode = mode % num_modes
        self._sample_seed = seed + 977 * mode + 1
        self._rng = np.random.default_rng(self._sample_seed)

    def sample(
        self, batch: int, rng: Optional[np.random.Generator] = None
    ) -> dict[str, np.ndarray]:
        succ = self._succ[self._mode]
        gen = self._rng if rng is None else rng
        toks = np.empty((batch, self.seq_len), np.int32)
        toks[:, 0] = gen.integers(0, self.vocab_size, batch)
        choices = gen.integers(0, succ.shape[1], (batch, self.seq_len))
        for t in range(1, self.seq_len):
            toks[:, t] = succ[toks[:, t - 1], choices[:, t]]
        return {"tokens": toks, "labels": toks.copy()}

    def sample_at(self, batch: int, key: int) -> dict[str, np.ndarray]:
        """Stateless sample: the batch is a pure function of ``key`` (and
        the dataset seed), independent of call history. The FL planes key
        by global step (``round * local_steps + step``) so a client that
        restarts, reconnects, or resumes mid-training regenerates the
        identical batch stream — the foundation for bitwise
        chaos-vs-clean and resume-vs-uninterrupted equality."""
        return self.sample(
            batch, rng=np.random.default_rng((self._sample_seed, int(key)))
        )

    def entropy_bound(self) -> float:
        """Per-token entropy of the chain (uniform over successors)."""
        return float(np.log(self._succ.shape[-1]))


def make_batch_iterator(
    dataset: SyntheticLMDataset,
    batch: int,
    *,
    extra: Optional[dict[str, np.ndarray]] = None,
) -> Iterator[dict[str, np.ndarray]]:
    while True:
        b = dataset.sample(batch)
        if extra:
            b.update(extra)
        yield b
