# Copy of src/repro/opt/operators.py, kept so repro_torch never imports repro.
"""Seeded, vectorized variation operators over integer genome populations.

Genomes are int64 arrays [P, G]; gene g takes values in
``range(cardinalities[g])`` (binary adjacency genes have cardinality 2).
Every operator draws from a caller-owned ``np.random.Generator``, so an
optimizer's whole trajectory is a pure function of its seed — the property
the checkpoint/resume story relies on.
"""
from __future__ import annotations

import numpy as np


def mutate_genes(genomes: np.ndarray, cardinalities: np.ndarray, rate: float,
                 rng: np.random.Generator) -> np.ndarray:
    """Per-gene resampling mutation over a whole population at once.

    Each gene mutates with probability ``rate``; a mutated gene is shifted by
    a uniform non-zero offset modulo its cardinality, so mutation always
    changes the gene (cardinality-1 genes never mutate)."""
    genomes = np.asarray(genomes, np.int64)
    card = np.asarray(cardinalities, np.int64)[None, :]
    mask = rng.random(genomes.shape) < rate
    # Draw against max(card, 2) so degenerate genes still consume one draw
    # per position (keeps the RNG stream independent of cardinalities).
    shift = rng.integers(1, np.maximum(card, 2), size=genomes.shape)
    mask &= card > 1
    return np.where(mask, (genomes + shift) % np.maximum(card, 1), genomes)


def uniform_crossover(parents_a: np.ndarray, parents_b: np.ndarray,
                      rng: np.random.Generator, p: float = 0.5) -> np.ndarray:
    """Gene-wise uniform crossover of two parent populations [P, G]."""
    a = np.asarray(parents_a, np.int64)
    b = np.asarray(parents_b, np.int64)
    pick = rng.random(a.shape) < p
    return np.where(pick, a, b)


def tournament_select(scores: np.ndarray, n_select: int,
                      rng: np.random.Generator, k: int = 2) -> np.ndarray:
    """k-way tournament selection: returns [n_select] indices into the
    population; lower score wins (ties break toward the first drawn
    candidate)."""
    scores = np.asarray(scores, np.float64)
    cand = rng.integers(0, len(scores), size=(n_select, k))
    winner = np.argmin(scores[cand], axis=1)
    return cand[np.arange(n_select), winner]
