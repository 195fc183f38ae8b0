"""Slices 2 and 3 as a whole: generation-backed cascade tiers from the
port's ``EnginePool`` served through the port's ``ServingPipeline``,
against the same pipeline in the JAX package on converted weights
(reduced Gemma-3-1B; and a Mamba2 tier then a Granite-MoE tier, reduced;
fp32, CPU). Answers, cost, ``stopped_at`` and tier counts
must be identical: the answers are greedy tokens mod a small number and
the cost is exact token accounting, so nothing here is compared within
a tolerance. One JAX engine serves every Gemma reference run:
all its calls fall in one (batch 8, prompt 16, cache 32) bucket, so the
reference compiles once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.core.cost import ApiCost as JApiCost
from repro.serving import engine as JE
from repro.serving.pipeline import ServingPipeline as JPipeline
from repro.serving.pipeline import TierSpec as JTierSpec
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.core.cost import ApiCost
from repro_torch.serving import engine as E
from repro_torch.serving.pipeline import ServingPipeline, TierSpec
from test_torch_generation import numpy_params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    jcfg = JARCHS["gemma3-1b"].reduced()
    pcfg = ARCHS["gemma3-1b"].reduced()
    params = numpy_params(jcfg, seed=0)
    tp = params_from_numpy(params, pcfg, device="cpu")
    jeng = JE.GenerationEngine(jcfg, jax.tree.map(jnp.asarray, params))
    return jeng, pcfg, tp


def _toks(seed, n=6, s=12):
    return (np.random.default_rng(seed).integers(0, 1024, size=(n, s))
            .astype(np.int32))


def test_generation_tier_answer_and_cost_match_jax(model):
    jeng, pcfg, tp = model
    toks = _toks(4, n=3)
    jtier = JE.generation_tier("gen", jeng, JApiCost(10.0, 20.0, 0.0),
                               decode_answer=lambda g: g[:, 0] % 7, n_new=2)
    tier = E.generation_tier("gen", E.GenerationEngine(pcfg, tp,
                                                       device="cpu"),
                             ApiCost(10.0, 20.0, 0.0),
                             decode_answer=lambda g: g[:, 0] % 7, n_new=2)
    ans = tier.answer(toks)
    assert ans.shape == (3,) and (ans < 7).all()
    np.testing.assert_array_equal(ans, jtier.answer(toks))
    cost = tier.cost(toks)
    assert cost == pytest.approx(np.full(3, (12 * 1.0 + 2 * 2.0) / 1e6))
    np.testing.assert_array_equal(cost, jtier.cost(toks))


def _pipeline(E_, cost_cls, pipe_cls, spec_cls, engine, **device_kw):
    """test_serving.py's pipeline: a free tier, then a generation tier
    that answers the first generated token mod 3."""
    gen = E_.generation_tier("gen-top", engine, cost_cls(100.0, 100.0, 0.0),
                             decode_answer=lambda g: g[:, 0] % 3, n_new=2)
    cheap = spec_cls("cheap", lambda t: np.zeros(len(t), np.int32),
                     cost_cls(1.0, 1.0, 0.0))
    top = spec_cls(gen.name, gen.answer, cost_cls(100.0, 100.0, 0.0),
                   n_out=2)
    return pipe_cls(
        tiers=[cheap, top], thresholds=[0.5],
        scorer=lambda t, a: np.where(np.arange(len(t)) % 2 == 0, 0.9, 0.1),
        batch_size=4, **device_kw)


@pytest.fixture(scope="module")
def jax_served(model):
    jeng = model[0]
    calls = jeng.compile_stats["prefill_calls"]
    res = _pipeline(JE, JApiCost, JPipeline, JTierSpec, jeng).serve(_toks(5))
    return res, jeng.compile_stats["prefill_calls"] - calls


@pytest.mark.parametrize("compact", ["host", "device"])
def test_pipeline_with_pooled_generation_tier_matches_jax(model, jax_served,
                                                          compact):
    _, pcfg, tp = model
    ref, ref_calls = jax_served
    pool = E.EnginePool(max_new_tokens=2)
    pipe = _pipeline(E, ApiCost, ServingPipeline, TierSpec,
                     pool.get(pcfg, tp, device="cpu"), device="cpu")
    pipe.compact = compact
    res = pipe.serve(_toks(5))
    assert res.tier_counts[0] == 6 and res.tier_counts[1] > 0
    assert (res.answers[res.stopped_at == 1] < 3).all()
    np.testing.assert_array_equal(res.answers, ref.answers)
    np.testing.assert_array_equal(res.cost, ref.cost)
    np.testing.assert_array_equal(res.stopped_at, ref.stopped_at)
    assert res.tier_counts == ref.tier_counts
    assert pool.compile_stats == {"prefill_compiles": 1,
                                  "prefill_calls": ref_calls}


def test_cascade_server_over_generation_tiers_matches_jax(model):
    jeng, pcfg, tp = model

    def server(E_, cost_cls, eng):
        tiers = [E_.generation_tier(f"g{n}", eng, cost_cls(n, 2.0 * n, 0.0),
                                    decode_answer=lambda g: g[:, -1] % 5,
                                    n_new=n) for n in (1, 3)]
        return E_.CascadeServer(
            tiers, [0.5], lambda t, a: np.where(a % 2 == 0, 0.9, 0.1),
            batch_size=4)

    toks = _toks(6, n=7)
    ref = server(JE, JApiCost, jeng).serve(toks)
    got = server(E, ApiCost, E.GenerationEngine(pcfg, tp,
                                                device="cpu")).serve(toks)
    for key in ("answers", "cost", "stopped_at", "tier_counts"):
        np.testing.assert_array_equal(got[key], ref[key])


def test_pipeline_with_ssm_and_moe_generation_tiers_matches_jax():
    """A free tier, a Mamba2 generation tier, then a Granite-MoE one (the
    serve path ``chip_smoke.py`` drives at full width), against the same
    pipeline in the JAX package: answers, cost, ``stopped_at`` and tier
    counts identical."""
    def build(E_, cost_cls, pipe_cls, spec_cls, engines, **device_kw):
        tiers = [spec_cls("cheap", lambda t: np.zeros(len(t), np.int32),
                          cost_cls(1.0, 1.0, 0.0))]
        for name, eng in engines:
            gen = E_.generation_tier(name, eng, cost_cls(50.0, 50.0, 0.0),
                                     decode_answer=lambda g: g[:, 0] % 3,
                                     n_new=3)
            tiers.append(spec_cls(name, gen.answer, cost_cls(50.0, 50.0, 0.0),
                                  n_out=3))
        return pipe_cls(
            tiers=tiers, thresholds=[0.5, 0.5],
            scorer=lambda t, a: np.where(t[:, 0] % 3 == a, 0.9, 0.1),
            batch_size=4, **device_kw)

    names = ("mamba2-1.3b", "granite-moe-1b-a400m")
    jengines, pengines = [], []
    for name in names:
        jcfg, pcfg = JARCHS[name].reduced(), ARCHS[name].reduced()
        params = numpy_params(jcfg, seed=1)
        jengines.append((name, JE.GenerationEngine(
            jcfg, jax.tree.map(jnp.asarray, params), max_new_tokens=3)))
        pengines.append((name, E.EnginePool(max_new_tokens=3).get(
            pcfg, params_from_numpy(params, pcfg, device="cpu"),
            device="cpu")))
    toks = _toks(7, n=10)
    ref = build(JE, JApiCost, JPipeline, JTierSpec, jengines).serve(toks)
    res = build(E, ApiCost, ServingPipeline, TierSpec, pengines,
                device="cpu").serve(toks)
    assert res.tier_counts[1] > 0 and res.tier_counts[2] > 0
    np.testing.assert_array_equal(res.answers, ref.answers)
    np.testing.assert_array_equal(res.cost, ref.cost)
    np.testing.assert_array_equal(res.stopped_at, ref.stopped_at)
    assert res.tier_counts == ref.tier_counts
