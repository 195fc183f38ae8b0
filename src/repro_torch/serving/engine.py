"""Serving engine (``repro/serving/engine.py``): batched generation with
bucketed shapes, a shared engine pool, and the cascade-server facade.

``GenerationEngine`` rounds batch, prompt length and cache length up to
power-of-two buckets, as the reference does, so the shapes a tier sees
stay O(log range). PyTorch runs eagerly and compiles nothing per shape:
``compile_stats["prefill_compiles"]`` counts the distinct (batch,
prompt, cache) buckets first seen, the count the reference's per-bucket
``jit`` pays and that a per-bucket CUDA graph would pay here, and
``prefill_calls`` counts prefills; both keep the reference's meaning so
the tests compare them.

Exactness of the bucketing (as in the reference):
  * batch padding    — filler rows replicate the last row and are sliced
    off; always exact.
  * cache (max_len)  — decode attends to the filled prefix of a full
    cache, or to the written slots of a ring, so a larger cache is exact.
  * prompt padding   — right-pad tokens, read prefill logits at the true
    last position, start decode at the true length so pad slots are
    overwritten before decode reads them. Exact for attention stacks
    whose ring cache never truncates the padded prompt; otherwise, and
    for any stack with a Mamba layer (``_seq_paddable``), the prompt
    keeps its exact length.
Greedy decoding is therefore the same whatever the bucket, except in
MoE layers: an expert's capacity grows with the padded prompt length
(``models/moe.py::capacity``), in the reference as here, so a padded
prompt may keep a token that its exact length would drop. With
``temperature > 0`` every token, the post-prefill one included, is drawn
from ``softmax(logits / temperature)`` with a ``torch.Generator`` seeded
from ``seed`` on the engine's device, over the padded batch: the same
seed and bucket reproduce, but the draws are not JAX's ``categorical``
bits.

``prefill_async`` launches the prefill (CUDA launches return before the
card finishes) and returns a ``PrefillFuture``; ``decode_from`` consumes
it and runs the decode loop; ``generate`` is exactly their composition.
The decode loop updates the future's KV cache in place
(``models/attention.py``), which is why a future resolves once.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_to
from repro_torch.core.cascade import CascadeTier, execute_cascade
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


def bucket_size(x: int, floor: int) -> int:
    """Next power of two >= x, floored at ``floor`` — keeps the number of
    shape variants O(log range) instead of O(distinct shapes)."""
    b = max(1, floor)
    while b < x:
        b *= 2
    return b


@dataclasses.dataclass
class PrefillFuture:
    """Cancellable handle to one launched prefill.

    Holds the post-prefill token and the KV cache (tensors on the
    engine's device, possibly still being computed), plus the shape and
    sampling state ``decode_from`` needs to continue exactly where
    ``generate`` would. Exactly one of three things happens to a future:
    it is *committed* (``engine.decode_from``: KV handoff into the decode
    loop), *cancelled* (``cancel``: the references are dropped so the
    allocator can reuse the cache's memory), or dropped with the engine.
    Commit and cancel both fire the one-shot ``_retire_cb`` so an owning
    ``EnginePool`` can untrack the speculation.
    """

    engine: "GenerationEngine"
    n_new: int
    b: int                      # true batch rows (callers see [:b])
    b_b: int                    # padded batch bucket
    s: int                      # true prompt length
    max_len: int                # KV-cache bucket length
    seed: int = 0
    cancelled: bool = False
    consumed: bool = False
    _tok: object = None         # (b_b, 1) int64 post-prefill token
    _cache: object = None       # KV cache, one dict per layer (the handoff)
    _gen: object = None         # torch.Generator after the first draw
    _retire_cb: object = None   # pool untrack hook, fired exactly once

    @property
    def live(self) -> bool:
        """Still holding device state: neither committed nor cancelled."""
        return not (self.cancelled or self.consumed)

    def cancel(self):
        """Retire the speculation: drop the KV cache and token references
        and untrack from the owning pool. Idempotent; a no-op on a future
        already consumed by ``decode_from``."""
        if not self.live:
            return
        self.cancelled = True
        self._tok = self._cache = self._gen = None
        self._retire()

    def _retire(self):
        cb, self._retire_cb = self._retire_cb, None
        if cb is not None:
            cb(self)


@dataclasses.dataclass
class GenerationEngine:
    """Batched prefill+decode generation for one model, bucketed."""

    cfg: ModelConfig
    params: dict
    max_new_tokens: int = 16
    temperature: float = 0.0
    batch_floor: int = 8        # batch sizes bucketed to pow2 >= this
    seq_floor: int = 16         # prompt/cache lengths bucketed likewise
    pad_token: int = 0
    # the card (default) or "cpu": params are copied there (a no-op for
    # those already there), and prefill, decode and the KV cache stay there
    device: object = "cuda"

    def __post_init__(self):
        if not self.cfg.decode_supported:
            raise ValueError(f"{self.cfg.name} is encoder-only: no decode")
        self.device = resolve_device(self.device)
        self.params = params_to(self.params, self.device)
        self._buckets: set[tuple[int, int, int]] = set()
        self.compile_stats = {"prefill_compiles": 0, "prefill_calls": 0}

    def _seq_paddable(self, seq_bucket: int) -> bool:
        """Right-padding the prompt is exact iff every mixer is attention
        (a Mamba layer's state would advance over the pad tokens) and no
        sliding-window ring buffer would evict padded-prompt slots before
        decode overwrites them (i.e. the padded prompt fits the window)."""
        specs = self.cfg.layers
        if any(not s.mixer.startswith("attn") for s in specs):
            return False
        if self.cfg.window and any(s.mixer == "attn_sliding" for s in specs):
            return seq_bucket < self.cfg.window
        return True

    def _next(self, logits, gen):
        """(b_b, V) fp32 logits -> (b_b, 1) next tokens."""
        if self.temperature > 0:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)
        return logits.argmax(-1, keepdim=True)

    def prefill_async(self, tokens: np.ndarray, n_new: int | None = None,
                      seed: int = 0) -> PrefillFuture:
        """Launch the prefill for ``tokens`` (B, S) and return a
        cancellable ``PrefillFuture``; the post-prefill token is drawn
        the way ``generate`` draws every token."""
        if n_new is None:                  # NOT `or`: an explicit 0 is 0
            n_new = self.max_new_tokens
        tokens = np.asarray(tokens)
        b, s = tokens.shape
        if n_new <= 0:
            return PrefillFuture(self, n_new=0, b=b, b_b=b, s=s,
                                 max_len=0, seed=seed)
        b_b = bucket_size(b, self.batch_floor)
        s_b = bucket_size(s, self.seq_floor)
        if not self._seq_paddable(s_b):
            s_b = s
        max_len = bucket_size(s_b + n_new, self.seq_floor)

        toks = np.full((b_b, s_b), self.pad_token, tokens.dtype)
        toks[:b, :s] = tokens
        toks[b:, :s] = tokens[-1]          # batch filler: replicate a row

        self.compile_stats["prefill_calls"] += 1
        if (b_b, s_b, max_len) not in self._buckets:
            self._buckets.add((b_b, s_b, max_len))
            self.compile_stats["prefill_compiles"] += 1
        logits, cache = T.prefill(self.params, {"tokens": toks}, self.cfg,
                                  max_len=max_len, last_index=s - 1)
        gen = None
        if self.temperature > 0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        nxt = self._next(logits[:, -1], gen)
        return PrefillFuture(self, n_new=n_new, b=b, b_b=b_b, s=s,
                             max_len=max_len, seed=seed, _tok=nxt,
                             _cache=cache, _gen=gen)

    def decode_from(self, fut: PrefillFuture) -> np.ndarray:
        """Commit a ``PrefillFuture``: take the KV-cache handoff and run
        the decode loop to ``(B, n_new)`` int32 tokens — the second half
        of the ``generate`` call that ``prefill_async`` started."""
        if fut.engine is not self:
            raise ValueError("PrefillFuture belongs to a different engine")
        if fut.cancelled:
            raise RuntimeError("cannot decode a cancelled PrefillFuture "
                               "(its KV cache was retired)")
        if fut.consumed:
            raise RuntimeError("PrefillFuture already consumed")
        fut.consumed = True
        if fut.n_new <= 0:
            fut._retire()
            return np.zeros((fut.b, 0), np.int32)
        nxt, cache, gen = fut._tok, fut._cache, fut._gen
        fut._tok = fut._cache = fut._gen = None
        fut._retire()
        out = [nxt]
        for i in range(fut.n_new - 1):
            logits, cache = T.decode_step(self.params, cache, nxt, fut.s + i,
                                          self.cfg)
            nxt = self._next(logits[:, -1], gen)
            out.append(nxt)
        return torch.cat(out, dim=1)[:fut.b].to(torch.int32).cpu().numpy()

    def generate(self, tokens: np.ndarray, n_new: int | None = None,
                 seed: int = 0) -> np.ndarray:
        """tokens (B, S) -> generated (B, n_new). Exactly
        ``decode_from(prefill_async(...))``."""
        return self.decode_from(self.prefill_async(tokens, n_new, seed))


@dataclasses.dataclass
class EnginePool:
    """Shared ``GenerationEngine`` pool: one engine per (model, weights,
    device), reused by every tier/pipeline that serves that model."""

    max_new_tokens: int = 16
    temperature: float = 0.0

    def __post_init__(self):
        self._engines: dict[tuple, GenerationEngine] = {}
        self._params_refs: dict[tuple, dict] = {}
        # in-flight speculative PrefillFutures, tracked per engine key so
        # an engine's speculations can be cancelled wholesale
        self._speculative: dict[tuple, list] = {}
        self.spec_stats = {"issued": 0, "committed": 0, "cancelled": 0}

    @staticmethod
    def _key(cfg: ModelConfig, params: dict, device) -> tuple:
        # key on weight identity too: two tiers can share an architecture
        # with different weights and must not serve each other's model.
        # The pool pins the caller's params (_params_refs) so id(params)
        # cannot be recycled while the key lives.
        dev = resolve_device(device)
        return (cfg.name, id(params), (dev.type, dev.index))

    def get(self, cfg: ModelConfig, params: dict,
            device="cuda") -> GenerationEngine:
        key = self._key(cfg, params, device)
        eng = self._engines.get(key)
        if eng is None:
            eng = GenerationEngine(cfg, params,
                                   max_new_tokens=self.max_new_tokens,
                                   temperature=self.temperature,
                                   device=device)
            self._engines[key] = eng
            self._params_refs[key] = params
        return eng

    def speculate(self, cfg: ModelConfig, params: dict, tokens: np.ndarray,
                  n_new: int | None = None, seed: int = 0,
                  device="cuda") -> PrefillFuture:
        """Launch a *speculative* prefill on the engine and track the
        future. The caller later resolves it with ``commit`` (runs the
        decode — charged work) or ``cancel`` (retires the KV cache)."""
        key = self._key(cfg, params, device)
        eng = self.get(cfg, params, device=device)
        fut = eng.prefill_async(tokens, n_new, seed)
        fut._retire_cb = lambda f, key=key: self._untrack(key, f)
        self._speculative.setdefault(key, []).append(fut)
        self.spec_stats["issued"] += 1
        return fut

    def commit(self, fut: PrefillFuture) -> np.ndarray:
        """Commit a tracked speculation: the tokens ``generate`` would
        have returned."""
        if not fut.live:
            raise RuntimeError("cannot commit a retired PrefillFuture")
        self.spec_stats["committed"] += 1
        return fut.engine.decode_from(fut)

    def cancel(self, fut: PrefillFuture) -> None:
        """Cancel a tracked speculation, retiring its KV cache."""
        if not fut.live:
            return
        self.spec_stats["cancelled"] += 1
        fut.cancel()

    def cancel_all(self, cfg: ModelConfig = None, params: dict = None,
                   device="cuda") -> int:
        """Cancel every live speculative future — of one engine when
        ``cfg``/``params`` are given, across the pool otherwise. Returns
        how many were cancelled."""
        if cfg is not None:
            keys = [self._key(cfg, params, device)]
        else:
            keys = list(self._speculative)
        n = 0
        for key in keys:
            for fut in list(self._speculative.get(key, ())):
                if fut.live:
                    self.cancel(fut)
                    n += 1
        return n

    def inflight(self) -> int:
        """Live (neither committed nor cancelled) speculative futures."""
        return sum(len(v) for v in self._speculative.values())

    def _untrack(self, key: tuple, fut: PrefillFuture) -> None:
        lst = self._speculative.get(key)
        if lst is not None:
            if fut in lst:
                lst.remove(fut)
            if not lst:
                self._speculative.pop(key, None)

    def __len__(self) -> int:
        return len(self._engines)

    @property
    def compile_stats(self) -> dict:
        """Prefill bucket / call counts summed over the pool."""
        out = {"prefill_compiles": 0, "prefill_calls": 0}
        for eng in self._engines.values():
            for k in out:
                out[k] += eng.compile_stats[k]
        return out


@dataclasses.dataclass
class Tier:
    name: str
    answer: Callable            # tokens (n, L) -> answers (n,)
    cost: Callable              # tokens (n, L) -> per-query cost (n,)


def generation_tier(name: str, engine: GenerationEngine, price,
                    decode_answer: Callable, n_new: int = 1,
                    pad_token: int = 0) -> Tier:
    """A cascade tier backed by a pooled ``GenerationEngine``.

    decode_answer(generated (b, n_new)) -> answer ids (b,);
    price: ``ApiCost`` used for exact token-count accounting.
    """

    def answer(tokens: np.ndarray) -> np.ndarray:
        return np.asarray(decode_answer(engine.generate(tokens, n_new)))

    def cost(tokens: np.ndarray) -> np.ndarray:
        n_in = (tokens != pad_token).sum(-1)
        return np.asarray(price.query_cost(n_in, np.full_like(n_in, n_new)))

    return Tier(name, answer, cost)


@dataclasses.dataclass
class CascadeServer:
    """FrugalGPT cascade as a serving policy (tier-by-tier compaction):
    a thin facade over ``execute_cascade``; ``serving.pipeline`` has the
    full cache + prompt-adaptation + cascade path."""

    tiers: Sequence[Tier]
    thresholds: Sequence[float]         # len = len(tiers) - 1
    scorer: Callable                    # (tokens, answers) -> scores (n,)
    batch_size: int = 256

    def serve(self, tokens: np.ndarray) -> dict:
        t0 = time.time()
        ct = [CascadeTier(t.name, lambda q, t=t: (t.answer(q), t.cost(q)))
              for t in self.tiers]
        res = execute_cascade(ct, self.thresholds,
                              lambda q, a, _j: self.scorer(q, a),
                              tokens, batch_size=self.batch_size)
        return {
            "answers": np.asarray(res["answers"]).astype(np.int32),
            "cost": res["cost"],
            "stopped_at": res["stopped_at"],
            "tier_counts": list(res["tier_counts"]),
            "latency_s": time.time() - t0,
        }
