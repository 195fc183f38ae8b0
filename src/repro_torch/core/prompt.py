"""Prompt adaptation (paper §3 Strategy 1): prompt selection (Fig. 2a).

Keep only a subset of in-context examples — greedy forward selection
maximizing validation accuracy per token. The cost model is exact
(``ApiCost``); accuracy comes from an evaluator callback.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence


@dataclasses.dataclass
class PromptSpec:
    example_ids: tuple          # which in-context examples are kept
    tokens_per_example: int
    base_tokens: int            # instruction + query tokens

    @property
    def n_tokens(self) -> int:
        return self.base_tokens + self.tokens_per_example * len(self.example_ids)


def select_prompt(candidates: Sequence[int], evaluate: Callable,
                  tokens_per_example: int, base_tokens: int,
                  min_gain: float = 1e-3, max_examples: int | None = None):
    """Greedy forward selection: add the example with the best accuracy
    gain until gains fall below ``min_gain``.

    evaluate(tuple_of_example_ids) -> accuracy on a validation set.
    Returns (PromptSpec, history)."""
    chosen: list[int] = []
    acc = evaluate(tuple(chosen))
    hist = [{"examples": tuple(chosen), "acc": acc}]
    pool = list(candidates)
    while pool and (max_examples is None or len(chosen) < max_examples):
        gains = [(evaluate(tuple(chosen + [c])), c) for c in pool]
        best_acc, best_c = max(gains)
        if best_acc - acc < min_gain:
            break
        chosen.append(best_c)
        pool.remove(best_c)
        acc = best_acc
        hist.append({"examples": tuple(chosen), "acc": acc})
    return PromptSpec(tuple(chosen), tokens_per_example, base_tokens), hist
