"""Synthetic data (copies of ``MarkovLM``, ``GaussianMixtureImages`` and
``MixtureImagesContinuous`` from ``repro.data.synthetic``, numpy only): a
Zipf-weighted order-1 Markov chain with learnable structure, so CE
demonstrably falls (with its true log-likelihood and transition legality for
the masked-diffusion evaluation), class-conditional Gaussian images for the
ViT classifier, and a Gaussian mixture of continuous 'images' for the DiT
adapter. Same seed, same batches as the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

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

    def log_likelihood(self, x: np.ndarray) -> float:
        """Average log2-likelihood per transition under the true chain
        (entropy floor for BPC-style metrics)."""
        V, K = self.vocab_size, self.branching
        probs = np.zeros((V, V))
        for k in range(K):
            np.add.at(probs, (np.arange(V), self.next_tokens[:, k]),
                      self.next_probs[k])
        p = probs[x[:, :-1], x[:, 1:]]
        return float(np.mean(np.log2(np.maximum(p, 1e-12))))

    def transition_accuracy(self, x: np.ndarray) -> float:
        """Fraction of transitions that are legal under the chain — the
        generation-quality proxy (MAUVE stand-in)."""
        legal = (self.next_tokens[x[:, :-1]] == x[:, 1:, None]).any(-1)
        return float(legal.mean())


@dataclasses.dataclass
class GaussianMixtureImages:
    """Class-conditional images: class c has a fixed random mean image +
    noise. Linearly separable at high SNR; difficulty via noise_scale."""
    num_classes: int = 10
    image_size: int = 32
    channels: int = 3
    noise_scale: float = 0.5
    seed: int = 0

    def __post_init__(self):
        r = np.random.RandomState(self.seed)
        self.means = r.randn(self.num_classes, self.image_size,
                             self.image_size, self.channels).astype(np.float32)

    def sample(self, rng: np.random.RandomState,
               batch: int) -> Tuple[np.ndarray, np.ndarray]:
        y = rng.randint(0, self.num_classes, batch)
        x = self.means[y] + self.noise_scale * rng.randn(
            batch, self.image_size, self.image_size,
            self.channels).astype(np.float32)
        return x.astype(np.float32), y

    def iterator(self, batch: int, seed: int = 1):
        rng = np.random.RandomState(seed)
        while True:
            yield self.sample(rng, batch)


@dataclasses.dataclass
class MixtureImagesContinuous:
    """Continuous targets for the DiT image-generation benchmark: samples
    from a K-mode Gaussian mixture over flattened 'images' (tokens of d
    dims). The true score is analytic, so sample quality is measurable via
    moment matching."""
    n_tokens: int = 16
    dim: int = 32
    n_modes: int = 4
    mode_scale: float = 2.0
    noise: float = 0.25
    seed: int = 0

    def __post_init__(self):
        r = np.random.RandomState(self.seed)
        self.modes = (self.mode_scale *
                      r.randn(self.n_modes, self.n_tokens, self.dim)
                      ).astype(np.float32)

    def sample(self, rng: np.random.RandomState, batch: int):
        k = rng.randint(0, self.n_modes, batch)
        x = self.modes[k] + self.noise * rng.randn(
            batch, self.n_tokens, self.dim).astype(np.float32)
        return x.astype(np.float32), k

    def iterator(self, batch: int, seed: int = 1):
        rng = np.random.RandomState(seed)
        while True:
            yield self.sample(rng, batch)

    def mode_assignment(self, x: np.ndarray) -> np.ndarray:
        d = ((x[:, None] - self.modes[None]) ** 2).sum((-1, -2))
        return d.argmin(1)

    def fidelity(self, x: np.ndarray) -> Tuple[float, float]:
        """(mean distance to nearest mode, mode coverage entropy ratio) —
        the FID stand-in."""
        d = np.sqrt(((x[:, None] - self.modes[None]) ** 2).sum((-1, -2)))
        nearest = d.min(1)
        assign = d.argmin(1)
        counts = np.bincount(assign, minlength=self.n_modes) / len(assign)
        ent = -(counts * np.log(np.maximum(counts, 1e-12))).sum()
        return float(nearest.mean()), float(ent / np.log(self.n_modes))
