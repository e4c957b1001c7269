"""Synthetic language data (a copy of ``MarkovLM`` from
``repro.data.synthetic``, numpy only): a Zipf-weighted order-1 Markov chain
with learnable structure, so CE demonstrably falls. Same seed, same
batches as the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class MarkovLM:
    """Order-1 Markov chain with Zipf-ish sparse transitions."""
    vocab_size: int = 256
    branching: int = 4
    seed: int = 0

    def __post_init__(self):
        r = np.random.RandomState(self.seed)
        V, K = self.vocab_size, self.branching
        self.next_tokens = r.randint(0, V, (V, K))
        p = 1.0 / (np.arange(1, K + 1) ** 1.2)
        self.next_probs = p / p.sum()

    def sample(self, rng: np.random.RandomState, batch: int,
               seq_len: int) -> np.ndarray:
        V, K = self.vocab_size, self.branching
        x = np.empty((batch, seq_len), np.int64)
        x[:, 0] = rng.randint(0, V, batch)
        for t in range(1, seq_len):
            choice = rng.choice(K, size=batch, p=self.next_probs)
            x[:, t] = self.next_tokens[x[:, t - 1], choice]
        return x

    def iterator(self, batch: int, seq_len: int,
                 seed: int = 1) -> Iterator[np.ndarray]:
        rng = np.random.RandomState(seed)
        while True:
            yield self.sample(rng, batch, seq_len)
