"""LLM approximation (paper §3 Strategy 2a): the completion cache.

Stores (query-embedding, answer) pairs; a new query reuses a cached
answer when its nearest cached neighbour is within a similarity
threshold. Embeddings come from the scorer's encoder (mean-pooled), so
no extra model is needed. The cache itself is numpy, copied from
``repro/core/approx.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.models.classifier import encode


def embed_queries(params, tokens, cfg: ModelConfig, batch: int = 512):
    """Mean-pooled encoder embedding, L2-normalized. (n, d) float32."""
    out = []
    for i in range(0, tokens.shape[0], batch):
        h = encode(params, tokens[i:i + batch], cfg).mean(1)
        out.append((h / (h.norm(dim=-1, keepdim=True) + 1e-6)).cpu().numpy())
    return np.concatenate(out)


@dataclasses.dataclass
class CompletionCache:
    """Fixed-capacity (embedding, answer) store with pluggable eviction.

    ``policy="fifo"`` keeps the original ring buffer (oldest *insert*
    evicted first); ``policy="lru"`` evicts the least-recently-*used*
    entry — a lookup hit refreshes its entry, so hot queries survive a
    skewed stream that would cycle them out of the ring; ``policy="lfu"``
    evicts the least-frequently-used entry (hit count, ties broken
    least-recently-used), so a steady hot set survives even a long flood
    of one-off queries that would age everything out of an LRU.

    ``ttl`` (seconds) bounds entry lifetime: an entry older than ``ttl``
    at *lookup* time is expired — invalidated and never served — so a
    stale answer can't outlive the world that produced it (tier models
    retrained, prompts reselected). Expiry uses ``time_fn`` (monotonic
    by default, injectable so tests don't sleep).

    ``min_score`` is a score-confidence floor: ``insert`` drops entries
    whose accept-time reliability score falls below it, so answers the
    scorer distrusted are never served to future near-duplicates. NaN
    scores (the cascade's last tier answers without scoring) are
    treated as trusted.
    """

    capacity: int = 4096
    threshold: float = 0.97
    policy: str = "fifo"            # "fifo" ring | "lru" | "lfu"
    min_score: float | None = None  # score-confidence floor for inserts
    ttl: float | None = None        # entry time-to-live, seconds
    time_fn: object = None          # clock for TTL (default time.monotonic)

    def __post_init__(self):
        if self.policy not in ("fifo", "lru", "lfu"):
            raise ValueError(f"unknown eviction policy {self.policy!r}; "
                             "expected 'fifo', 'lru' or 'lfu'")
        if self.ttl is not None and self.ttl <= 0:
            raise ValueError(f"ttl must be > 0 seconds, got {self.ttl}")
        if self.time_fn is None:
            import time
            self.time_fn = time.monotonic
        self._emb = None            # (cap, d)
        self._ans = None            # (cap,)
        self._valid = None
        self._next = 0              # fifo ring head
        self._used = None           # (cap,) last-use tick (lru/lfu ties)
        self._freq = None           # (cap,) hit count (lfu)
        self._born = None           # (cap,) insert time (ttl)
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.skipped_low_score = 0  # inserts dropped by the floor
        self.expired = 0            # entries invalidated by the TTL

    def _expire(self):
        """Invalidate entries older than ``ttl`` (called at lookup, so
        an expired entry is never served even if nothing evicted it)."""
        if self.ttl is None or self._valid is None:
            return
        stale = self._valid & (self.time_fn() - self._born > self.ttl)
        if stale.any():
            self.expired += int(stale.sum())
            self._valid[stale] = False

    def lookup(self, emb: np.ndarray):
        """emb (n, d) -> (hit_mask (n,), answers (n,))."""
        n = emb.shape[0]
        self._expire()
        if self._emb is None or not self._valid.any():
            self.misses += n
            return np.zeros(n, bool), np.zeros(n, np.int32)
        sims = emb @ self._emb.T                       # (n, cap)
        sims = np.where(self._valid[None, :], sims, -1.0)
        best = sims.argmax(1)
        best_sim = sims[np.arange(n), best]
        hit = best_sim >= self.threshold
        if hit.any():
            slots = best[hit]
            if self.policy in ("lru", "lfu"):
                # refresh hit entries; a slot hit twice in this batch
                # keeps the later tick
                self._used[slots] = self._tick + np.arange(len(slots))
                self._tick += len(slots)
            if self.policy == "lfu":
                np.add.at(self._freq, slots, 1)
        self.hits += int(hit.sum())
        self.misses += int((~hit).sum())
        return hit, self._ans[best].astype(np.int32)

    def insert(self, emb: np.ndarray, answers: np.ndarray, scores=None):
        """Insert entries; ``scores`` (optional, (n,)) are accept-time
        reliability scores checked against the ``min_score`` floor."""
        emb = np.asarray(emb)
        answers = np.asarray(answers)
        if self.min_score is not None and scores is not None:
            s = np.asarray(scores, np.float64)
            keep = np.isnan(s) | (s >= self.min_score)
            self.skipped_low_score += int((~keep).sum())
            if not keep.all():
                emb, answers = emb[keep], answers[keep]
        n = len(emb)
        if n == 0:
            return
        # expire before choosing victims: a TTL-stale entry must free
        # its slot rather than sit valid-looking while a LIVE entry
        # (whose tick/frequency merely sorts lower) gets evicted
        self._expire()
        if self._emb is None:
            d = emb.shape[1]
            self._emb = np.zeros((self.capacity, d), emb.dtype)
            self._ans = np.zeros(self.capacity, np.int32)
            self._valid = np.zeros(self.capacity, bool)
            self._used = np.zeros(self.capacity, np.int64)
            self._freq = np.zeros(self.capacity, np.int64)
            self._born = np.zeros(self.capacity, np.float64)
        if self.policy == "fifo":
            # ring semantics: a batch larger than the ring self-overwrites
            # so the NEWEST entries survive and _next keeps advancing
            idx = (self._next + np.arange(n)) % self.capacity
            self._next = int((self._next + n) % self.capacity)
        else:
            if n > self.capacity:            # keep the newest, like the ring
                emb, answers = emb[-self.capacity:], answers[-self.capacity:]
                n = self.capacity
            if self.policy == "lru":
                # victims: empty slots first, then least-recently-used
                prio = np.where(self._valid, self._used, -1)
                idx = np.argsort(prio, kind="stable")[:n]
            else:
                # lfu victims: empty slots first, then lowest hit count,
                # ties least-recently-used (lexsort: last key is primary)
                empty = self._valid.astype(np.int64)        # 0 sorts first
                idx = np.lexsort((self._used, self._freq, empty))[:n]
        self._emb[idx] = emb
        self._ans[idx] = answers
        self._valid[idx] = True
        self._used[idx] = self._tick + np.arange(n)
        self._freq[idx] = 0
        self._born[idx] = self.time_fn()
        self._tick += n

    @property
    def hit_rate(self):
        t = self.hits + self.misses
        return self.hits / t if t else 0.0
