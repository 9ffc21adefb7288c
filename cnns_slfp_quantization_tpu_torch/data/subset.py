"""Stratified train-subset sampling for fine-tune recovery runs (a copy of
the JAX package's ``data/subset.py``: the same indices for the same labels,
fraction and seed).

The reference claims quantized accuracy recovers with "6% of the training
set" of fine-tuning (reference README.md:12) but ships no sampler — the
workflow is operational (run ``--retrain`` briefly, SURVEY.md §5).  Here the
subset is a first-class, reproducible feature: ``--train_subset 0.06``
selects a deterministic class-stratified sample so every class keeps
representation even at small fractions.
"""

from __future__ import annotations

import numpy as np


def stratified_indices(labels: np.ndarray, fraction: float,
                       seed: int = 0) -> np.ndarray:
    """Deterministic class-stratified sample of ``fraction`` of the indices.

    Per class, ``ceil(fraction * class_count)`` examples are drawn without
    replacement (so every non-empty class contributes at least one example).
    Returns sorted indices into ``labels``.
    """
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"fraction must be in (0, 1], got {fraction}")
    labels = np.asarray(labels)
    if fraction == 1.0:
        return np.arange(len(labels))
    rng = np.random.default_rng(seed)
    picked = []
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        k = int(np.ceil(fraction * len(idx)))
        picked.append(rng.choice(idx, size=k, replace=False))
    return np.sort(np.concatenate(picked))
