"""Pipeline assembly: the last step of ``repro``'s ``build_pipeline``
(``repro/serving/builder.py``, step 7).

Training the tiers and the scorer, prompt selection and learning the
cascade (build steps 1-6) are later slices. ``assemble_pipeline`` takes
their results — the marketplace, the cascade's tiers in it, scorer
params, prompts, thresholds — as given.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np

from repro_torch.convert import params_to
from repro_torch.core import scorer as SC
from repro_torch.core.approx import CompletionCache, embed_queries
from repro_torch.core.neural_market import NeuralAPI
from repro_torch.core.prompt import PromptSpec
from repro_torch.data import synthetic
from repro_torch.serving.pipeline import ServingPipeline, TierSpec

#: the unadapted few-shot prompt: 140 base tokens + 8 examples of 110
#: (``repro``'s ``BuildConfig`` defaults, the paper's HEADLINES scale)
FULL_PROMPT_TOKENS = 140 + 8 * 110
#: non-pad tokens of every synthetic query (``synthetic.sample``'s length)
_QUERY_TOKENS = 64


def assemble_pipeline(market: Sequence[NeuralAPI], scorer_params: dict,
                      thresholds: Sequence[float],
                      prompts: Sequence[PromptSpec | None], *,
                      cascade: Sequence[int] | None = None,
                      device="cuda", compact: str = "device",
                      cache_capacity: int = 1024,
                      cache_threshold: float = 0.995,
                      cache_policy: str = "fifo",
                      cache_min_score: float | None = None,
                      cache_ttl: float | None = None) -> ServingPipeline:
    """A ``ServingPipeline`` over the tiers ``[market[i] for i in
    cascade]`` (the learned cascade, in order; default: every tier of
    the marketplace ``market``) on ``device``: every cascade tier's and
    the scorer's params are copied there, and ``compact="device"`` keeps
    the pending set there. ``prompts`` holds one adapted prompt (or
    ``None``, the full prompt) per marketplace tier.

    The savings baseline is the marketplace's priciest tier, as in
    ``build_pipeline``, not the cascade's last tier (a tight budget can
    drop the top tier): the tier whose cost with its own prompt is
    highest for a 64-token query. Every synthetic query has 64 non-pad
    tokens, so this is the reference's argmax of the offline mean cost.
    """
    if len(prompts) != len(market):
        raise ValueError(f"{len(prompts)} prompts for {len(market)} "
                         f"marketplace tiers")
    cascade = list(range(len(market)) if cascade is None else cascade)
    if not cascade or any(not 0 <= i < len(market) for i in cascade):
        raise ValueError(f"cascade {cascade} must index the {len(market)} "
                         f"marketplace tiers")
    apis = [NeuralAPI(market[i].name, market[i].cfg,
                      params_to(market[i].params, device), market[i].price)
            for i in cascade]
    sp = params_to(scorer_params, device)
    cache = CompletionCache(capacity=cache_capacity,
                            threshold=cache_threshold, policy=cache_policy,
                            min_score=cache_min_score, ttl=cache_ttl)
    embed = functools.partial(embed_queries, sp, cfg=SC.SCORER_CFG)
    tiers = [TierSpec(a.name, a.answer, a.price, prompt=prompts[i])
             for a, i in zip(apis, cascade)]
    priced = [float(a.price.query_cost(
        _QUERY_TOKENS + (p.n_tokens if p is not None else FULL_PROMPT_TOKENS),
        1)) for a, p in zip(market, prompts)]
    top = int(np.argmax(priced))
    return ServingPipeline(
        tiers=tiers, thresholds=tuple(thresholds),
        scorer=lambda toks, ans: SC.score(sp, toks, ans),
        cache=cache, embed=embed, full_prompt_tokens=FULL_PROMPT_TOKENS,
        pad_token=synthetic.PAD, baseline_price=market[top].price,
        compact=compact, device=device)
