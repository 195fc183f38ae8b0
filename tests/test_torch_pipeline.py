"""The slice as a whole: the port's batch serve path against the JAX
package's on the same converted weights, thresholds, prompts and cache.

Three tiers (GPT-J, ChatGPT, GPT-4 widths) and the scorer come from
seeded JAX inits, not training. Thresholds sit at midpoints between
sorted JAX scores, and the test asserts that no score lies within 1e-4
of a threshold and that no tier's top-2 logit margin is under 1e-4, so
fp32 noise between XLA and torch cannot flip a row: answers, costs,
``stopped_at``, tier counts and cache hits must then be identical.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import neural_market as JNM
from repro.core import scorer as JSC
from repro.core.approx import CompletionCache as JCompletionCache
from repro.core.approx import embed_queries as jax_embed_queries
from repro.core.cascade import CascadeTier as JCascadeTier
from repro.core.cascade import _accept_threshold as jax_accept_threshold
from repro.core.cascade import execute_cascade as jax_execute_cascade
from repro.core.cost import TABLE1 as JTABLE1
from repro.core.prompt import PromptSpec as JPromptSpec
from repro.data import synthetic
from repro.models.classifier import encoder_config as jax_encoder_config
from repro.models.classifier import init_classifier as jax_init_classifier
from repro.models.classifier import jitted_logits
from repro.serving.pipeline import ServingPipeline as JServingPipeline
from repro.serving.pipeline import TierSpec as JTierSpec
from repro_torch.convert import params_from_numpy
from repro_torch.core import neural_market as NM
from repro_torch.core import scorer as SC
from repro_torch.core.cascade import (CascadeTier, _accept_threshold,
                                      execute_cascade)
from repro_torch.core.cost import TABLE1
from repro_torch.core.prompt import PromptSpec
from repro_torch.serving.builder import FULL_PROMPT_TOKENS, assemble_pipeline

torch.set_num_threads(1)

NAMES = ("GPT-J", "ChatGPT", "GPT-4")
PROMPTS = [((0, 1, 2), 110, 140), ((0, 1), 110, 140), None]
FRAGILE = 1e-4
_jax_init = jax.jit(jax_init_classifier, static_argnums=(1, 2))


def _jax_tier_cfg(name, seq_len=64):
    spec = JNM.TIERS[name]
    return jax_encoder_config(f"api-{name}", n_layers=spec["n_layers"],
                              d_model=spec["d_model"],
                              n_heads=max(2, spec["d_model"] // 32),
                              d_ff=2 * spec["d_model"], max_seq=seq_len + 4)


def _midpoint(scores):
    """Midpoint of the widest gap between sorted scores in the middle
    half, so about half the rows pass and none sits near the threshold."""
    u = np.unique(scores.astype(np.float64))
    lo, hi = len(u) // 4, 3 * len(u) // 4
    k = lo + int(np.argmax(np.diff(u[lo:hi + 1])))
    return float((u[k] + u[k + 1]) / 2)


@pytest.fixture(scope="module")
def market():
    japis, tapis = [], []
    for i, name in enumerate(NAMES):
        jcfg = _jax_tier_cfg(name)
        jp = _jax_init(jax.random.PRNGKey(10 + i), jcfg, 4)
        price = JNM.TIERS[name]["price"]
        japis.append(JNM.NeuralAPI(name, jcfg, jp, JTABLE1[price]))
        cfg = NM.tier_config(name)
        tapis.append(NM.NeuralAPI(
            name, cfg, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         device="cpu"), TABLE1[price]))
    jsp = _jax_init(jax.random.PRNGKey(99), JSC.SCORER_CFG, 1)
    tsp = params_from_numpy(jax.tree.map(np.asarray, jsp), SC.SCORER_CFG,
                            device="cpu")

    # 96 requests, a quarter of them repeats, in seeded order
    base = synthetic.sample("headlines", 72, seed=5).tokens
    rng = np.random.default_rng(5)
    toks = np.concatenate([base, base[rng.choice(72, 24)]])
    toks = toks[rng.permutation(len(toks))]

    thresholds = []
    for j, api in enumerate(japis):
        logits = np.asarray(jitted_logits(api.cfg)(api.params,
                                                   jnp.asarray(toks)))
        top2 = np.sort(logits, -1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > FRAGILE, api.name
        if j < len(japis) - 1:
            s = JSC.score(jsp, toks, api.answer(toks))
            thresholds.append(_midpoint(s))
            assert np.abs(s.astype(np.float64) - thresholds[-1]).min() > FRAGILE
    return dict(japis=japis, tapis=tapis, jsp=jsp, tsp=tsp, toks=toks,
                thresholds=thresholds)


def _jax_pipeline(m):
    tiers = [JTierSpec(a.name, a.answer, a.price,
                       prompt=JPromptSpec(*p) if p else None)
             for a, p in zip(m["japis"], PROMPTS)]
    return JServingPipeline(
        tiers=tiers, thresholds=m["thresholds"],
        scorer=lambda t, a: JSC.score(m["jsp"], t, a),
        cache=JCompletionCache(capacity=1024, threshold=0.995),
        embed=functools.partial(jax_embed_queries, m["jsp"],
                                cfg=JSC.SCORER_CFG),
        full_prompt_tokens=FULL_PROMPT_TOKENS, pad_token=synthetic.PAD,
        baseline_price=m["japis"][-1].price)


@pytest.mark.parametrize("compact", ["host", "device"])
def test_serve_matches_jax(market, compact):
    jpipe = _jax_pipeline(market)
    tpipe = assemble_pipeline(market["tapis"], market["tsp"],
                              market["thresholds"],
                              [PromptSpec(*p) if p else None for p in PROMPTS],
                              device="cpu", compact=compact)
    toks = market["toks"]
    for rnd in range(2):
        ref, got = jpipe.serve(toks), tpipe.serve(toks)
        assert np.array_equal(got.answers, ref.answers)
        assert np.array_equal(got.cost, ref.cost)
        assert np.array_equal(got.stopped_at, ref.stopped_at)
        assert got.tier_counts == ref.tier_counts
        assert (got.cache_hits, got.cache_misses) == (ref.cache_hits,
                                                      ref.cache_misses)
        assert got.prompt_tokens_saved == ref.prompt_tokens_saved
        assert got.baseline_cost == ref.baseline_cost
        if rnd == 0:
            # the cascade really compacted between tiers
            assert got.tier_counts[0] > got.tier_counts[1] > 0
        else:
            assert got.cache_hit_rate == 1.0 and not any(got.tier_counts)
    assert "served 96 queries" in got.summary()


def test_baseline_is_the_marketplaces_priciest_tier(market):
    """A cascade that drops the marketplace's priciest tier keeps it as
    the savings baseline, as ``build_pipeline`` does
    (``repro/serving/builder.py:378-380``): the argmax over the whole
    marketplace of the offline mean cost, each tier with its own prompt,
    not the cascade's last tier."""
    tapis, toks = market["tapis"], market["toks"]
    prompts = [PromptSpec(*p) if p else None for p in PROMPTS]
    # the reference's rule by hand: mean offline cost per marketplace tier
    n_q = (toks != synthetic.PAD).sum(-1)
    mean_cost = [np.asarray(a.price.query_cost(
        n_q + (p.n_tokens if p else FULL_PROMPT_TOKENS), np.ones_like(n_q)),
        np.float64).mean() for a, p in zip(tapis, prompts)]
    top = int(np.argmax(mean_cost))
    assert top == 2 and tapis[2].price != tapis[1].price
    tpipe = assemble_pipeline(tapis, market["tsp"], market["thresholds"][:1],
                              prompts, cascade=[0, 1], device="cpu")
    assert [t.name for t in tpipe.tiers] == list(NAMES[:2])
    assert tpipe.baseline_price == tapis[top].price
    got = tpipe.serve(toks)
    baseline = float(np.asarray(tapis[top].price.query_cost(
        n_q + FULL_PROMPT_TOKENS, np.ones_like(n_q))).sum())
    assert got.baseline_cost == baseline
    assert got.savings_frac == 1.0 - float(got.cost.sum()) / baseline
    # the same two-tier cascade in the JAX package, baseline by its rule
    jtiers = [JTierSpec(a.name, a.answer, a.price,
                        prompt=JPromptSpec(*p) if p else None)
              for a, p in zip(market["japis"][:2], PROMPTS)]
    jpipe = JServingPipeline(
        tiers=jtiers, thresholds=market["thresholds"][:1],
        scorer=lambda t, a: JSC.score(market["jsp"], t, a),
        cache=JCompletionCache(capacity=1024, threshold=0.995),
        embed=functools.partial(jax_embed_queries, market["jsp"],
                                cfg=JSC.SCORER_CFG),
        full_prompt_tokens=FULL_PROMPT_TOKENS, pad_token=synthetic.PAD,
        baseline_price=market["japis"][top].price)
    ref = jpipe.serve(toks)
    assert np.array_equal(got.cost, ref.cost)
    assert got.tier_counts == ref.tier_counts
    assert got.baseline_cost == ref.baseline_cost
    assert got.savings_frac == ref.savings_frac
    # the cascade's own last tier would have been a cheaper baseline
    last = dataclasses.replace(tpipe, baseline_price=tapis[1].price)
    assert got.baseline_cost > last._baseline_cost(toks)


@pytest.mark.parametrize("cascade", [[], [0, 3], [-1]])
def test_assemble_pipeline_refuses_a_cascade_outside_the_market(market,
                                                                cascade):
    with pytest.raises(ValueError, match="cascade"):
        assemble_pipeline(market["tapis"], market["tsp"], [],
                          [None] * len(market["tapis"]), cascade=cascade,
                          device="cpu")


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_accept_threshold_matches_jax(dtype):
    rng = np.random.default_rng(0)
    for t in [0.0, 0.1, 0.5, 0.7, 1 / 3, 0.999, 1.0, *rng.random(50)]:
        got, ref = _accept_threshold(dtype, t), jax_accept_threshold(dtype, t)
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("name", sorted(TABLE1))
def test_query_cost_bit_identical(name):
    n_in = np.arange(0, 3000, 7, dtype=np.int64)
    n_out = (n_in % 5) + 1
    got = TABLE1[name].query_cost(n_in, n_out)
    ref = np.asarray(JTABLE1[name].query_cost(n_in, n_out))
    assert got.dtype == ref.dtype == np.float32
    assert got.tobytes() == ref.tobytes()
    assert (np.float32(TABLE1[name].query_cost(64 + 1020, 1)).tobytes()
            == np.asarray(JTABLE1[name].query_cost(64 + 1020, 1)).tobytes())


def _toy(tier_cls):
    """Three numeric tiers: answers and costs are functions of the row."""
    def make(k):
        return tier_cls(f"t{k}", lambda q, k=k: (
            (q.sum(1) * (k + 3)) % 7, q[:, 0] * 0.001 + k))
    return [make(k) for k in range(3)]


def _toy_scores(q, a, j):
    # float32 scores straddling 0.7, some exactly float32(0.7) < 0.7
    s = ((q[:, 1] * 31 + a * 7 + j) % 20) / 19.0
    s = s.astype(np.float32)
    s[q[:, 2] % 5 == 0] = np.float32(0.7)
    return s


@pytest.mark.parametrize("scorer_kind", ["numpy", "tensor"])
def test_execute_cascade_modes_match_jax(scorer_kind):
    rng = np.random.default_rng(3)
    queries = rng.integers(0, 1000, size=(300, 3))
    ref = jax_execute_cascade(_toy(JCascadeTier), [0.7, 0.7], _toy_scores,
                              queries, batch_size=64)
    scorer = _toy_scores
    if scorer_kind == "tensor":
        scorer = lambda q, a, j: torch.from_numpy(_toy_scores(q, a, j))  # noqa: E731
    for compact in ("host", "device"):
        got = execute_cascade(_toy(CascadeTier), [0.7, 0.7], scorer, queries,
                              batch_size=64, compact=compact, device="cpu")
        for key in ("answers", "cost", "stopped_at"):
            assert np.array_equal(got[key], ref[key]), (compact, key)
        assert np.array_equal(got["scores"], ref["scores"], equal_nan=True)
        assert got["tier_counts"] == ref["tier_counts"]
        assert got["accepted_counts"] == ref["accepted_counts"]


def test_execute_cascade_validation():
    tiers = _toy(CascadeTier)
    with pytest.raises(ValueError, match="compact"):
        execute_cascade(tiers, [0.5, 0.5], _toy_scores, np.zeros((2, 3), int),
                        compact="pallas")
    with pytest.raises(ValueError, match="thresholds"):
        execute_cascade(tiers, [0.5], _toy_scores, np.zeros((2, 3), int))


def test_api_cost_auc_and_prompt_selection_match_jax(market):
    toks = market["toks"].copy()
    toks[::3, -5:] = synthetic.PAD                  # ragged query lengths
    for japi, tapi in zip(market["japis"], market["tapis"]):
        assert (tapi.query_cost(toks).tobytes()
                == np.asarray(japi.query_cost(toks)).tobytes())
    rng = np.random.default_rng(1)
    s, y = rng.random(200), rng.random(200) < 0.4
    assert SC.auc(s, y) == JSC.auc(s, y)
    assert SC.auc(s, np.zeros(200)) == JSC.auc(s, np.zeros(200)) == 0.5
    gains = rng.uniform(0.004, 0.02, size=8)

    def evaluate(ids):
        return 0.6 + sum(float(gains[i]) for i in ids)

    from repro.core.prompt import select_prompt as jax_select_prompt
    from repro_torch.core.prompt import select_prompt
    got, hist = select_prompt(range(8), evaluate, 110, 140, min_gain=0.008)
    ref, ref_hist = jax_select_prompt(range(8), evaluate, 110, 140,
                                      min_gain=0.008)
    assert (got.example_ids, got.n_tokens) == (ref.example_ids, ref.n_tokens)
    assert hist == ref_hist
