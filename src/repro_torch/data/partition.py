"""Federated data partitioners: IID and Dirichlet non-IID.

For the synthetic Markov corpus, "non-IID" means each client draws from a
different transition-table mode with Dirichlet-weighted mixture — the
standard label-skew analogue for LM streams.
"""
from __future__ import annotations


import numpy as np

from repro_torch.data.pipeline import SyntheticLMDataset


def iid_partition(
    vocab_size: int, seq_len: int, num_clients: int, *, seed: int = 0
) -> list[SyntheticLMDataset]:
    """Every client samples the same chain with the same sample seed.

    Under keyed sampling (:meth:`SyntheticLMDataset.sample_at`, which the
    FL planes use) every client therefore draws identical batches."""
    return [
        SyntheticLMDataset(vocab_size, seq_len, seed=seed, num_modes=1, mode=0)
        for _ in range(num_clients)
    ]


def dirichlet_partition(
    vocab_size: int,
    seq_len: int,
    num_clients: int,
    *,
    alpha: float = 0.5,
    num_modes: int = 4,
    seed: int = 0,
) -> list[SyntheticLMDataset]:
    """Each client's stream comes from a Dirichlet-sampled dominant mode."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(num_clients):
        weights = rng.dirichlet([alpha] * num_modes)
        mode = int(np.argmax(weights))
        out.append(
            SyntheticLMDataset(
                vocab_size, seq_len, seed=seed, num_modes=num_modes, mode=mode
            )
        )
    return out
