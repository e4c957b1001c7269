"""Block partitioning (paper §3.3 + App. C/D): the port's copy of
``repro.core.partition`` (numpy and scipy only).

Equi-probability partitioning: boundaries σ_b such that every block carries
exactly 1/B of p_noise's probability mass within [σ_min, σ_max]:

    σ_b = exp(P_mean + P_std Φ⁻¹(q_b)),  q_b = q_min + (b/B)(q_max − q_min),
    q_{min/max} = Φ((log σ_{min/max} − P_mean)/P_std).

Uniform partitioning (Table 7 ablation baseline) splits [σ_min, σ_max]
linearly. Overlap (App. C) expands block b's range to [σ_b/α_b, α_b σ_{b-1}]
with α_b = (σ_{b-1}/σ_b)^γ. ``sampling_schedule`` places the sampler's
Euler steps at equal probability-mass quantiles and ``block_of_sigma``
names the block that serves a noise level (the DiT and recurrent-depth
samplers).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy.special import ndtr, ndtri

from repro_torch.configs.base import DBConfig


def q_of_sigma(sigma, db: DBConfig):
    return ndtr((np.log(sigma) - db.p_mean) / db.p_std)


def sigma_of_q(q, db: DBConfig):
    return np.exp(db.p_mean + db.p_std * ndtri(q))


def sigma_edges(db: DBConfig) -> np.ndarray:
    """Descending edges: edges[0] = σ_max … edges[B] = σ_min. Block b
    (0-indexed, b=0 trains/serves the HIGHEST noise) covers
    [edges[b+1], edges[b]]."""
    B = db.num_blocks
    if db.partition == "uniform":
        asc = np.linspace(db.sigma_min, db.sigma_max, B + 1)
        return asc[::-1].copy()
    q_min = q_of_sigma(db.sigma_min, db)
    q_max = q_of_sigma(db.sigma_max, db)
    qs = q_min + (np.arange(B + 1) / B) * (q_max - q_min)
    asc = sigma_of_q(qs, db)
    asc[0], asc[-1] = db.sigma_min, db.sigma_max   # exact endpoints
    return asc[::-1].copy()


def block_sigma_range(db: DBConfig, b: int,
                      with_overlap: bool = True) -> Tuple[float, float]:
    """(σ_lo, σ_hi) for block b, optionally expanded by the overlap γ."""
    edges = sigma_edges(db)
    hi, lo = float(edges[b]), float(edges[b + 1])
    if with_overlap and db.overlap_gamma > 0:
        alpha = (hi / lo) ** db.overlap_gamma
        lo, hi = lo / alpha, hi * alpha
        lo = max(lo, db.sigma_min)
        hi = min(hi, db.sigma_max)
    return lo, hi


def block_qrange(db: DBConfig, b: int,
                 with_overlap: bool = True) -> Tuple[float, float]:
    lo, hi = block_sigma_range(db, b, with_overlap)
    return float(q_of_sigma(lo, db)), float(q_of_sigma(hi, db))


def block_qranges(db: DBConfig, with_overlap: bool = True) -> np.ndarray:
    """(B, 2) float32 rows of (q_lo, q_hi) per block: the array form of
    ``block_qrange`` (JAX's block-parallel engine reads a block's range as
    data; the port's ranks know their block as an int and call
    ``block_qrange``)."""
    return np.asarray([block_qrange(db, b, with_overlap)
                       for b in range(db.num_blocks)], np.float32)


def unit_ranges(n_units: int, num_blocks: int,
                distribution: Sequence[int] | None = None
                ) -> List[Tuple[int, int]]:
    """Contiguous (start, size) unit ranges per block. ``distribution`` gives
    explicit per-block unit counts (Table 7 ablation), default near-equal.
    Block 0 = FIRST units = highest noise (inference starts there)."""
    if distribution is None:
        base = n_units // num_blocks
        rem = n_units % num_blocks
        distribution = [base + (1 if i < rem else 0) for i in range(num_blocks)]
    assert sum(distribution) == n_units, (distribution, n_units)
    assert all(s > 0 for s in distribution)
    ranges, start = [], 0
    for s in distribution:
        ranges.append((start, s))
        start += s
    return ranges


def sampling_schedule(db: DBConfig, num_steps: int | None = None) -> np.ndarray:
    """σ sequence for inference (descending, num_steps+1 points incl. 0 end).

    Steps are placed at equal probability-mass quantiles of p_noise so each
    block serves ≈ num_steps/B steps (paper App. H). The final step targets
    σ = 0 (i.e. returns D exactly)."""
    N = num_steps or db.num_sampling_steps
    q_min = q_of_sigma(db.sigma_min, db)
    q_max = q_of_sigma(db.sigma_max, db)
    qs = q_max - (np.arange(N) / N) * (q_max - q_min)
    sig = sigma_of_q(qs, db)
    sig[0] = db.sigma_max
    return np.concatenate([sig, [0.0]])


def block_of_sigma(db: DBConfig, sigma: float) -> int:
    """Host-side: which block serves noise level σ (non-overlapped ranges)."""
    edges = sigma_edges(db)            # descending
    for b in range(db.num_blocks):
        if sigma >= edges[b + 1]:
            return b
    return db.num_blocks - 1
