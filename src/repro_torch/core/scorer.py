"""The generation scoring function g(q, a) — DistilBERT-analogue encoder
with a sigmoid regression head (``repro/core/scorer.py``).

Training (``train_scorer``) is a later slice; this slice scores with
given params (converted from the reference, or seeded).
"""
from __future__ import annotations

import numpy as np

from repro_torch.data import synthetic
from repro_torch.models.classifier import classifier_score, encoder_config

SCORER_CFG = encoder_config("scorer-distilbert", n_layers=4, d_model=128,
                            n_heads=4, d_ff=256, max_seq=256)


def score(params, queries: np.ndarray, answers: np.ndarray,
          batch: int = 512) -> np.ndarray:
    """g(q, a) in [0,1] for each (query, answer) pair (float32)."""
    pairs = synthetic.append_answer(np.asarray(queries), np.asarray(answers))
    out = [classifier_score(params, pairs[i:i + batch], SCORER_CFG)
           .cpu().numpy() for i in range(0, pairs.shape[0], batch)]
    return np.concatenate(out)


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """ROC-AUC via rank statistic."""
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n1, n0 = pos.sum(), (~pos).sum()
    if n1 == 0 or n0 == 0:
        return 0.5
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))
