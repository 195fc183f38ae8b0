"""Synthetic natural-language-like tasks mirroring the paper's datasets.

Each task generates token sequences from a compositional template grammar
with a *known* label function and a tunable difficulty knob (distractor
density, negation), so that models of different capacity land at
heterogeneous accuracies — the neural analogue of the LLM marketplace.

Tasks:
  * headlines  — 4-class commodity-trend classification (HEADLINES)
  * overruling — binary legal overruling detection (OVERRULING)
  * qa         — span-style answer selection over a passage (COQA-like,
                 framed as answer-token prediction)
"""
from __future__ import annotations

import dataclasses

import numpy as np

VOCAB = 512
PAD, CLS, SEP = 0, 1, 2
# token-id regions
UP_TOKENS = list(range(10, 30))        # "surges", "rallies", ...
DOWN_TOKENS = list(range(30, 50))      # "slides", "tumbles", ...
NEUTRAL_TOKENS = list(range(50, 60))   # "steady", "flat"
NEG_TOKENS = list(range(60, 70))       # "despite", "reverses"
OVERRULE_TOKENS = list(range(70, 90))
AFFIRM_TOKENS = list(range(90, 110))
FILLER = list(range(120, VOCAB))
ANSWER_BASE = 200                      # qa answers live in [200, 264)

N_CLASSES = {"headlines": 4, "overruling": 2, "qa": 64}


@dataclasses.dataclass
class TaskBatch:
    tokens: np.ndarray      # (n, L) int32
    labels: np.ndarray      # (n,) int32
    difficulty: np.ndarray  # (n,) float32 in [0,1]


def sample(task: str, n: int, seq_len: int = 64, seed: int = 0) -> TaskBatch:
    rng = np.random.default_rng(seed)
    toks = rng.choice(FILLER, size=(n, seq_len)).astype(np.int32)
    toks[:, 0] = CLS
    labels = np.zeros(n, np.int32)
    diff = rng.uniform(0.0, 1.0, size=n).astype(np.float32)

    if task == "headlines":
        # label: 0=up 1=down 2=neutral 3=none; difficulty adds negations
        for i in range(n):
            lab = rng.integers(0, 4)
            labels[i] = lab
            pos = rng.integers(2, seq_len // 2)
            if lab == 0:
                toks[i, pos] = rng.choice(UP_TOKENS)
            elif lab == 1:
                toks[i, pos] = rng.choice(DOWN_TOKENS)
            elif lab == 2:
                toks[i, pos] = rng.choice(NEUTRAL_TOKENS)
            # difficulty: negation flips the surface signal
            if diff[i] > 0.55 and lab in (0, 1):
                toks[i, pos - 1] = rng.choice(NEG_TOKENS)
                toks[i, rng.integers(seq_len // 2, seq_len)] = rng.choice(
                    UP_TOKENS if lab == 1 else DOWN_TOKENS)
    elif task == "overruling":
        for i in range(n):
            lab = rng.integers(0, 2)
            labels[i] = lab
            pos = rng.integers(2, seq_len - 2)
            toks[i, pos] = rng.choice(OVERRULE_TOKENS if lab else AFFIRM_TOKENS)
            if diff[i] > 0.6:   # distractor from the opposite class
                toks[i, rng.integers(2, seq_len - 2)] = rng.choice(
                    AFFIRM_TOKENS if lab else OVERRULE_TOKENS)
    elif task == "qa":
        # passage contains key->value pairs; question asks for one key's value
        n_pairs = 4
        for i in range(n):
            keys = rng.choice(range(110, 160), size=n_pairs, replace=False)
            vals = rng.integers(0, N_CLASSES["qa"], size=n_pairs)
            for j in range(n_pairs):
                p = 4 + 6 * j
                toks[i, p] = keys[j]
                toks[i, p + 1] = ANSWER_BASE + vals[j]
            qj = rng.integers(0, n_pairs if diff[i] > 0.3 else 1)
            toks[i, seq_len - 2] = SEP
            toks[i, seq_len - 1] = keys[qj]
            labels[i] = vals[qj]
    else:
        raise ValueError(task)
    return TaskBatch(toks, labels, diff)


def append_answer(tokens: np.ndarray, answers: np.ndarray) -> np.ndarray:
    """(query, answer) pairs for the scorer: append SEP + answer token."""
    n, L = tokens.shape
    out = np.concatenate([tokens,
                          np.full((n, 1), SEP, np.int32),
                          (ANSWER_BASE + answers[:, None]).astype(np.int32)],
                         axis=1)
    return out
