"""The FrugalGPT serving pipeline, batch path (``repro/serving/pipeline.py``).

A token batch flows through three stages:

  1. completion cache (§3.2) — queries are embedded with the scorer's
     encoder and answered from the nearest-neighbour cache when the
     similarity clears the threshold;
  2. prompt adaptation (§3.1) — every miss is billed against its tier's
     adapted few-shot prefix (``PromptSpec``) with exact ``ApiCost``
     token accounting;
  3. LLM cascade (§3.3) — misses run tier by tier through
     ``execute_cascade``, chunked to ``batch_size``.

Fresh answers go back into the cache, and each batch returns a
``ServeResult``. Strategy routing, accuracy guarantees, fault injection
and the stream entry points are later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.approx import CompletionCache
from repro_torch.core.cascade import COMPACT_MODES, CascadeTier, execute_cascade
from repro_torch.core.cost import ApiCost
from repro_torch.core.prompt import PromptSpec
from repro_torch.device import resolve_device


def _merge_answers(n: int, parts: Sequence[tuple]) -> np.ndarray:
    """Scatter ``(indices, values)`` parts into one (n,) answers array,
    densified to a numeric dtype when every answer is a scalar."""
    if n == 0:
        return np.zeros(0, np.int32)
    out = np.empty(n, dtype=object)
    for idx, vals in parts:
        idx = np.asarray(idx).ravel()
        vals = np.asarray(vals)
        if vals.dtype == object or vals.ndim != 1:
            for i_local, i_global in enumerate(idx):
                out[i_global] = vals[i_local]
        else:
            out[idx] = vals
    try:                                     # densify when answers are scalar
        dense = np.array([x.item() if isinstance(x, np.generic) else x
                          for x in out])
        if dense.ndim == 1 and dense.dtype != object:
            return dense
    except ValueError:                       # heterogeneous answer objects
        pass
    return out


@dataclasses.dataclass
class TierSpec:
    """One serving tier: ``answer(tokens (b, L)) -> answers (b,)``, its
    exact 3-term price, and its adapted prompt (None = the full one)."""

    name: str
    answer: Callable
    price: ApiCost
    prompt: PromptSpec | None = None
    n_out: int = 1


@dataclasses.dataclass
class ServeResult:
    """Telemetry for one served batch."""

    answers: np.ndarray          # (n,) final answers
    cost: np.ndarray             # (n,) accounted USD per query
    stopped_at: np.ndarray       # (n,) cascade position; -1 = cache hit
    tier_counts: list            # queries reaching each tier (compaction)
    tier_names: list
    cache_hits: int
    cache_misses: int
    prompt_tokens_saved: int     # adapted vs full prompt, summed over calls
    baseline_cost: float         # top tier + full prompt for every query
    latency: dict                # per-stage seconds

    @property
    def n(self) -> int:
        return len(self.answers)

    @property
    def cache_hit_rate(self) -> float:
        t = self.cache_hits + self.cache_misses
        return self.cache_hits / t if t else 0.0

    @property
    def savings_frac(self) -> float:
        if self.baseline_cost <= 0:
            return 0.0
        return 1.0 - float(self.cost.sum()) / self.baseline_cost

    def summary(self) -> str:
        lat = ", ".join(f"{k} {v * 1e3:.0f}ms" for k, v in
                        self.latency.items())
        tiers = ", ".join(f"{nm}: {c}" for nm, c in
                          zip(self.tier_names, self.tier_counts))
        return (
            f"served {self.n} queries | cache hit rate "
            f"{self.cache_hit_rate:.2f} ({self.cache_hits} hits) | "
            f"tier compaction [{tiers}] | prompt tokens saved "
            f"{self.prompt_tokens_saved} | cost ${self.cost.sum():.6f} vs "
            f"${self.baseline_cost:.6f} top-tier baseline "
            f"({100 * self.savings_frac:.0f}% saved) | {lat}")


@dataclasses.dataclass
class ServingPipeline:
    """Completion cache -> prompt adaptation -> LLM cascade, batched."""

    tiers: Sequence[TierSpec]
    thresholds: Sequence[float]          # len = len(tiers) - 1
    scorer: Callable                     # (tokens, answers) -> scores (n,)
    cache: CompletionCache | None = None
    embed: Callable | None = None        # tokens (n, L) -> embeddings (n, d)
    full_prompt_tokens: int = 0          # unadapted few-shot prefix length
    pad_token: int = 0
    batch_size: int = 256
    # economics of the marketplace's top tier, for the savings baseline
    baseline_price: ApiCost | None = None
    baseline_n_out: int = 1
    # pending-set compaction: "host" numpy | "device" compaction kernel
    compact: str = "host"
    # where compact="device" keeps the pending set
    device: object = "cuda"

    def __post_init__(self):
        if self.compact not in COMPACT_MODES:
            raise ValueError(f"unknown compact mode {self.compact!r}; "
                             f"expected one of {COMPACT_MODES}")
        if self.cache is not None and self.embed is None:
            raise ValueError("a completion cache needs an embed function "
                             "(reuse the scorer encoder, see builder)")
        self.device = resolve_device(self.device)

    # -- stage 2: exact per-tier cost with the adapted prompt --------------
    def _query_tokens(self, tokens: np.ndarray) -> np.ndarray:
        return np.asarray((tokens != self.pad_token).sum(-1), np.int64)

    def _tier_cost(self, spec: TierSpec, tokens: np.ndarray) -> np.ndarray:
        prefix = (spec.prompt.n_tokens if spec.prompt is not None
                  else self.full_prompt_tokens)
        n_q = self._query_tokens(tokens)
        n_out = np.full_like(n_q, spec.n_out)
        return np.asarray(spec.price.query_cost(n_q + prefix, n_out),
                          np.float64)

    def _baseline_cost(self, tokens: np.ndarray) -> float:
        """Everything to the marketplace top tier, full prompt, no cache."""
        if self.baseline_price is not None:
            price, n_out = self.baseline_price, self.baseline_n_out
        else:
            price, n_out = self.tiers[-1].price, self.tiers[-1].n_out
        n_q = self._query_tokens(tokens)
        return float(np.asarray(price.query_cost(
            n_q + self.full_prompt_tokens,
            np.full_like(n_q, n_out))).sum())

    def _cascade_tiers(self) -> list[CascadeTier]:
        """The live tiers as cascade stages: one invoke = answer + the
        exact adapted-prompt cost for the same chunk."""
        return [CascadeTier(s.name,
                            lambda q, s=s: (s.answer(q), self._tier_cost(s, q)))
                for s in self.tiers]

    def _pos_scorer(self, q, a, _j):
        return self.scorer(q, a)

    def _prompt_saved(self, tier_counts: Sequence[int]) -> int:
        saved = 0
        for spec, c in zip(self.tiers, tier_counts):
            if spec.prompt is not None:
                saved += c * (self.full_prompt_tokens - spec.prompt.n_tokens)
        return int(saved)

    def _cache_insert(self, emb_rows: np.ndarray, answers, scores=None) -> bool:
        """Insert fresh answers; the cache is int-keyed, so non-integer
        answers are skipped."""
        a = np.asarray(answers)
        if a.dtype == object:
            try:
                a = np.array(a.tolist())
            except ValueError:
                return False
        if a.ndim != 1 or not np.issubdtype(a.dtype, np.integer):
            return False
        self.cache.insert(emb_rows, a, scores)
        return True

    def serve(self, tokens: np.ndarray) -> ServeResult:
        """One closed token batch through all three stages."""
        t0 = time.perf_counter()
        n = tokens.shape[0]
        cost = np.zeros(n, np.float64)
        stopped_at = np.full(n, -1, np.int32)
        latency: dict = {}

        # stage 1: completion cache
        hits = 0
        emb = None
        hit_idx = np.zeros(0, np.int64)
        hit_ans = np.zeros(0, np.int32)
        miss = np.arange(n)
        if self.cache is not None:
            t = time.perf_counter()
            emb = np.asarray(self.embed(tokens))    # host copy syncs the card
            latency["embed"] = time.perf_counter() - t
            t = time.perf_counter()
            hit_mask, cached = self.cache.lookup(emb)
            hit_idx = np.flatnonzero(hit_mask)
            hit_ans = cached[hit_idx]
            hits = len(hit_idx)
            miss = np.flatnonzero(~hit_mask)
            latency["cache"] = time.perf_counter() - t

        # stages 2+3: adapted prompts + cascade over the misses
        t = time.perf_counter()
        tier_counts = [0] * len(self.tiers)
        res_ans = np.zeros(0, np.int32)
        if len(miss):
            res = execute_cascade(self._cascade_tiers(), self.thresholds,
                                  self._pos_scorer, tokens[miss],
                                  batch_size=self.batch_size,
                                  compact=self.compact, device=self.device)
            res_ans = np.asarray(res["answers"])
            cost[miss] = res["cost"]
            stopped_at[miss] = res["stopped_at"]
            tier_counts = res["tier_counts"]
        latency["cascade"] = time.perf_counter() - t
        answers = _merge_answers(n, [(hit_idx, hit_ans), (miss, res_ans)])

        # write fresh answers back into the cache (int-keyed; skip others)
        if self.cache is not None and len(miss):
            t = time.perf_counter()
            self._cache_insert(emb[miss], res_ans, res["scores"])
            latency["insert"] = time.perf_counter() - t

        latency["total"] = time.perf_counter() - t0
        return ServeResult(
            answers=answers, cost=cost, stopped_at=stopped_at,
            tier_counts=list(tier_counts),
            tier_names=[s.name for s in self.tiers],
            cache_hits=hits, cache_misses=len(miss),
            prompt_tokens_saved=self._prompt_saved(tier_counts),
            baseline_cost=self._baseline_cost(tokens),
            latency=latency)
