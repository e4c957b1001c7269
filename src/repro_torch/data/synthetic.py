"""Synthetic data (copies of ``MarkovLM``, ``MarkovStream``,
``arithmetic_stream``, ``GaussianMixtureImages`` and
``MixtureImagesContinuous`` from ``repro.data.synthetic``, numpy only): a
Zipf-weighted order-1 Markov chain with learnable structure, so CE
demonstrably falls (with its true log-likelihood and transition legality for
the masked-diffusion evaluation), its cursor-able stream for fault-tolerant
training, a deterministic arithmetic stream, class-conditional Gaussian
images for the ViT classifier, and a Gaussian mixture of continuous 'images'
for the DiT adapter. Same seed, same batches as the JAX package, and the
same cursor dict, so a cursor written by either package resumes in the
other."""
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

    def stream(self, batch: int, seq_len: int, seed: int = 1,
               start_batch: int = 0) -> "MarkovStream":
        """Cursor-able version of ``iterator`` (fault-tolerant training)."""
        return MarkovStream(self, batch, seq_len, seed=seed,
                            start_batch=start_batch)

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


class MarkovStream:
    """Deterministic, CURSOR-able batch stream over a ``MarkovLM``.

    Batch i depends only on (lm, seed, i), so a resumed run that fast-forwards
    to the delivered-batch count consumes the SAME batches the uninterrupted
    run would have — the property the training resume-parity gate needs. The
    cursor is a small JSON dict (no RandomState pickling), so it lives in the
    checkpoint manifest.
    """

    def __init__(self, lm: "MarkovLM", batch: int, seq_len: int,
                 seed: int = 1, start_batch: int = 0):
        self.lm, self.batch, self.seq_len, self.seed = lm, batch, seq_len, seed
        self.rng = np.random.RandomState(seed)
        self.batches = 0
        for _ in range(start_batch):
            next(self)                   # replay-to-cursor fast-forward

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        x = self.lm.sample(self.rng, self.batch, self.seq_len)
        self.batches += 1
        return x

    def cursor(self) -> dict:
        return {"kind": "markov", "vocab_size": self.lm.vocab_size,
                "branching": self.lm.branching, "lm_seed": self.lm.seed,
                "batch": self.batch, "seq_len": self.seq_len,
                "seed": self.seed, "batches": self.batches}

    @classmethod
    def from_cursor(cls, cur: dict) -> "MarkovStream":
        lm = MarkovLM(vocab_size=cur["vocab_size"],
                      branching=cur["branching"], seed=cur["lm_seed"])
        return cls(lm, cur["batch"], cur["seq_len"], seed=cur["seed"],
                   start_batch=cur["batches"])


def arithmetic_stream(batch: int, seq_len: int, vocab: int,
                      seed: int) -> np.ndarray:
    """Deterministic x_{t+1} = (3 x_t + 1) mod V — exactness checks."""
    r = np.random.RandomState(seed)
    x = np.empty((batch, seq_len), np.int64)
    x[:, 0] = r.randint(0, vocab, batch)
    for t in range(1, seq_len):
        x[:, t] = (3 * x[:, t - 1] + 1) % vocab
    return x


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
