"""The port's generation path (``repro_torch.models.transformer`` prefill /
decode and ``repro_torch.serving.engine``) against the JAX package, on
weights converted from JAX params, fp32 on the CPU.

Configs: ``gemma3-1b`` reduced (two sliding layers, window 64); a mixed
local/global Gemma (hd 256, window 8: every decode wraps its ring and
the global layer takes the full-cache path); and the registry's other
dense configs, ``mistral-nemo-12b`` and ``starcoder2-15b``, reduced.

Tolerances: logits atol 1e-4 (fp32 summation order over two to four
layers; logits are of order 0.1-1). Greedy tokens must be identical, and
every greedy step's top-2 logit margin is asserted >= 1e-4 so that
float noise cannot flip a token. Sampled tokens (temperature > 0) are
not compared with JAX: a ``torch.Generator`` cannot give JAX's
``categorical`` bits.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.registry import ARCHS as JARCHS
from repro.models import transformer as JT
from repro.serving.engine import GenerationEngine as JEngine
from repro_torch.configs.base import LayerSpec
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.serving.engine import (EnginePool, GenerationEngine,
                                        bucket_size)

torch.set_num_threads(1)
LOGIT_TOL = 1e-4
MARGIN = 1e-4


def _mixed(archs, spec):
    local, glob = spec("attn_sliding", "dense"), spec("attn", "dense")
    return dataclasses.replace(
        archs["gemma3-1b"], name="gemma3-mixed", n_layers=4, d_model=128,
        d_ff=256, vocab=1024, n_heads=4, n_kv_heads=1, head_dim=256,
        period=(local, local, glob), n_periods=1, suffix=(local,), window=8,
        max_seq=512, dtype="float32")


CONFIGS = {
    "gemma3-1b": lambda: (JARCHS["gemma3-1b"].reduced(),
                          ARCHS["gemma3-1b"].reduced()),
    "gemma3-mixed": lambda: (_mixed(JARCHS, JLayerSpec),
                             _mixed(ARCHS, LayerSpec)),
    "mistral-nemo-12b": lambda: (JARCHS["mistral-nemo-12b"].reduced(),
                                 ARCHS["mistral-nemo-12b"].reduced()),
    "starcoder2-15b": lambda: (JARCHS["starcoder2-15b"].reduced(),
                               ARCHS["starcoder2-15b"].reduced()),
}


def numpy_params(jcfg, seed):
    """Weights for both packages, made with numpy from ``seed`` in the
    reference's tree (its shapes from ``jax.eval_shape``, so no init is
    compiled): N(0, 0.02) matrices, norm scales 1 + N(0, 0.1), biases
    N(0, 0.1)."""
    shapes = jax.eval_shape(functools.partial(JT.init_params, cfg=jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "scale":
            return 1 + 0.1 * x
        return (0.1 if name == "bias" else 0.02) * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _model(name, seed=0):
    jcfg, pcfg = CONFIGS[name]()
    params = numpy_params(jcfg, seed)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, pcfg, device="cpu")
    return jcfg, pcfg, jp, tp


def _toks(b, s, seed, vocab=1024):
    return (np.random.default_rng(seed).integers(1, vocab, size=(b, s))
            .astype(np.int32))


def _jax_layers(cache, cfg):
    """The reference's cache (prefix / scanned period / suffix) as the
    port's list, one {"k", "v"} per layer."""
    out = list(cache["prefix"])
    for i in range(cfg.n_periods):
        for j in range(len(cfg.period)):
            out.append(jax.tree.map(lambda a, i=i: a[i],
                                    cache["period"][f"sub{j}"]))
    return out + list(cache["suffix"])


def _margin(logits):
    top2 = torch.topk(torch.as_tensor(np.array(logits)), 2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


# (prompt length, padded length fed to prefill, cache length): every
# config's decode crosses a ring wrap within the 8 steps where it has a
# ring (window 64 at 60 + 8; window 8 from the start). Padding is exact
# only while the padded prompt fits the window, so the window-8 config
# is not padded (the engine's ``_seq_paddable`` rule).
PREFILL = {"gemma3-1b": (60, 62, 68), "gemma3-mixed": (13, 13, 32),
           "mistral-nemo-12b": (13, 16, 32), "starcoder2-15b": (60, 62, 68)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_cache_and_decode_logits_match_jax(name):
    jcfg, pcfg, jp, tp = _model(name)
    s, s_pad, max_len = PREFILL[name]
    toks = _toks(3, s_pad, seed=s)
    toks[:, s:] = 0                            # right padding, read at s - 1
    jpre = jax.jit(functools.partial(JT.prefill, cfg=jcfg, max_len=max_len))
    jlog, jcache = jpre(jp, {"tokens": jnp.asarray(toks)},
                        last_index=jnp.int32(s - 1))
    plog, pcache = T.prefill(tp, {"tokens": toks}, pcfg, max_len=max_len,
                             last_index=s - 1)
    assert plog.dtype == torch.float32 and plog.shape == (3, 1, pcfg.vocab)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL, rtol=0)
    ref_cache = _jax_layers(jcache, jcfg)
    assert len(pcache) == len(ref_cache) == pcfg.n_layers
    for got, ref in zip(pcache, ref_cache):
        for leaf in ("k", "v"):
            assert tuple(got[leaf].shape) == ref[leaf].shape
            np.testing.assert_allclose(got[leaf].numpy(),
                                       np.asarray(ref[leaf]), atol=1e-5,
                                       rtol=1e-5)

    jdec = jax.jit(functools.partial(JT.decode_step, cfg=jcfg))
    nxt = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    margins, greedy = [_margin(jlog)], [np.asarray(nxt)]
    for i in range(8):
        pnxt = torch.from_numpy(np.array(nxt))
        jlog, jcache = jdec(jp, jcache, nxt, jnp.int32(s + i))
        plog, pcache = T.decode_step(tp, pcache, pnxt, s + i, pcfg)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL, rtol=0)
        margins.append(_margin(jlog))
        nxt = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
        greedy.append(np.asarray(nxt))
    assert min(margins) >= MARGIN
    # the port's engine (bucketed, unpadded prompt in) gives the
    # reference's greedy chain token for token
    eng = GenerationEngine(pcfg, tp, device="cpu")
    np.testing.assert_array_equal(eng.generate(toks[:, :s], n_new=9),
                                  np.concatenate(greedy, axis=1))


def _port_chain(tp, pcfg, toks, n_new):
    """Greedy tokens and the smallest top-2 margin from the port's own
    unbucketed prefill + decode chain."""
    s = toks.shape[1]
    logits, cache = T.prefill(tp, {"tokens": toks}, pcfg, max_len=s + n_new)
    out, margins = [], []
    for i in range(n_new):
        margins.append(_margin(logits[:, -1]))
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        out.append(nxt)
        if i < n_new - 1:
            logits, cache = T.decode_step(tp, cache, nxt, s + i, pcfg)
    return torch.cat(out, 1).numpy(), min(margins)


# (batch, prompt length, n_new): odd batch and prompt buckets, shapes that
# reuse a bucket, the engine's default n_new (None) and an explicit 0, a
# prompt whose bucket reaches gemma's window of 64 (not paddable), and a
# longer decode (run on the mixed config, where every prompt is exact)
GENERATE = [(3, 13, 5), (2, 11, 5), (1, 16, 4), (3, 13, None), (3, 13, 0),
            (5, 40, 6), (2, 20, 12)]
# (the mixed config's window of 8 makes every prompt non-paddable; the
# other dense configs' engines are held against the reference's greedy
# chain above)
GENERATE_CONFIGS = {"gemma3-1b": GENERATE[:-1], "gemma3-mixed": GENERATE[-1:]}


@pytest.mark.parametrize("name", list(GENERATE_CONFIGS))
def test_generate_greedy_matches_jax_engine(name):
    jcfg, pcfg, jp, tp = _model(name)
    jeng = JEngine(jcfg, jp)
    peng = GenerationEngine(pcfg, tp, device="cpu")
    for b, s, n_new in GENERATE_CONFIGS[name]:
        toks = _toks(b, s, seed=b * 100 + s)
        got = peng.generate(toks, n_new=n_new)
        n = peng.max_new_tokens if n_new is None else n_new
        assert got.shape == (b, n) and got.dtype == np.int32
        if n:
            chain, margin = _port_chain(tp, pcfg, toks, n)
            assert margin >= MARGIN
            np.testing.assert_array_equal(got, chain)  # bucketing is exact
        np.testing.assert_array_equal(got, jeng.generate(toks, n_new=n_new))
    assert peng.compile_stats == jeng.compile_stats


def test_init_cache_matches_jax_layout():
    for name in CONFIGS:
        jcfg, pcfg, _, _ = _model(name)
        ref = _jax_layers(JT.init_cache(jcfg, 2, 100), jcfg)
        got = T.init_cache(pcfg, 2, 100)
        assert [{k: tuple(v.shape) for k, v in c.items()} for c in got] == \
            [{k: v.shape for k, v in c.items()} for c in ref]
        assert all(not c["k"].any() and c["v"].dtype == torch.float32
                   for c in got)


def test_seq_paddable_rule_and_buckets_match_jax():
    for name in CONFIGS:
        jcfg, pcfg, jp, tp = _model(name)
        jeng, peng = JEngine(jcfg, jp), GenerationEngine(pcfg, tp,
                                                         device="cpu")
        for s_b in (8, 16, 32, 64, 128):
            assert peng._seq_paddable(s_b) == jeng._seq_paddable(s_b), (name,
                                                                        s_b)
    assert bucket_size(1, 8) == 8 and bucket_size(9, 8) == 16
    assert bucket_size(100, 16) == 128


def test_compile_stats_count_buckets_and_n_new_zero():
    _, pcfg, _, tp = _model("gemma3-1b")
    eng = GenerationEngine(pcfg, tp, device="cpu", max_new_tokens=4)
    toks = _toks(3, 13, seed=2)
    eng.generate(toks, n_new=5)
    eng.generate(toks[:2, :11], n_new=5)         # same buckets: no new one
    eng.generate(toks[:1, :13], n_new=4)
    assert eng.compile_stats == {"prefill_compiles": 1, "prefill_calls": 3}
    out = eng.generate(toks, n_new=0)
    assert out.shape == (3, 0) and out.dtype == np.int32
    assert eng.compile_stats["prefill_calls"] == 3     # no model work
    assert eng.generate(toks).shape == (3, 4)          # None -> default
    assert eng.generate(toks, n_new=2).shape == (3, 2)


def test_pool_shares_engines_keyed_on_weights():
    _, pcfg, _, tp = _model("gemma3-1b")
    _, _, _, tp_b = _model("gemma3-1b", seed=9)
    pool = EnginePool(max_new_tokens=4)
    e1 = pool.get(pcfg, tp, device="cpu")
    assert pool.get(pcfg, tp, device="cpu") is e1 and len(pool) == 1
    e3 = pool.get(pcfg, tp_b, device="cpu")      # same arch, other weights
    assert e3 is not e1 and len(pool) == 2
    toks = _toks(2, 12, seed=3)
    assert not np.array_equal(e1.generate(toks), e3.generate(toks))
    assert pool.compile_stats["prefill_calls"] == 2


# -- the split entry points, speculation and sampling (port only) --------


def test_split_matches_generate_greedy_and_sampled():
    _, pcfg, _, tp = _model("gemma3-1b")
    toks = _toks(3, 5, seed=1)
    for temperature in (0.0, 0.8):
        eng = GenerationEngine(pcfg, tp, device="cpu",
                               temperature=temperature)
        ref = eng.generate(toks, n_new=4, seed=9)
        fut = eng.prefill_async(toks, n_new=4, seed=9)
        assert fut.live and fut.b == 3 and fut.n_new == 4
        np.testing.assert_array_equal(eng.decode_from(fut), ref)
        assert fut.consumed and not fut.live


def test_sampling_reproduces_by_seed_and_leaves_greedy_alone():
    _, pcfg, _, tp = _model("gemma3-1b")
    toks = _toks(2, 16, seed=8)
    eng = GenerationEngine(pcfg, tp, device="cpu", temperature=1.0)
    out = eng.generate(toks, n_new=6, seed=7)
    np.testing.assert_array_equal(eng.generate(toks, n_new=6, seed=7), out)
    assert not np.array_equal(eng.generate(toks, n_new=6, seed=8), out)
    greedy = GenerationEngine(pcfg, tp, device="cpu")
    chain, _ = _port_chain(tp, pcfg, toks, 3)
    np.testing.assert_array_equal(greedy.generate(toks, n_new=3), chain)


def test_future_resolves_exactly_once():
    _, pcfg, _, tp = _model("gemma3-1b")
    eng = GenerationEngine(pcfg, tp, device="cpu")
    toks = _toks(3, 5, seed=1)
    fut = eng.prefill_async(toks, n_new=2)
    fut.cancel()
    assert fut.cancelled and not fut.live
    assert fut._cache is None and fut._tok is None
    with pytest.raises(RuntimeError, match="cancelled"):
        eng.decode_from(fut)
    fut.cancel()                              # idempotent
    fut2 = eng.prefill_async(toks, n_new=2)
    eng.decode_from(fut2)
    with pytest.raises(RuntimeError, match="consumed"):
        eng.decode_from(fut2)
    fut2.cancel()                             # no-op after consume
    assert not fut2.cancelled
    fut3 = eng.prefill_async(toks, n_new=2)
    with pytest.raises(ValueError, match="different engine"):
        GenerationEngine(pcfg, tp, device="cpu").decode_from(fut3)
    fut3.cancel()
    out = eng.decode_from(eng.prefill_async(toks, n_new=0))
    assert out.shape == (3, 0) and out.dtype == np.int32


def test_pool_speculate_commit_cancel_and_scoped_cancel_all():
    _, pcfg, _, tp = _model("gemma3-1b")
    _, _, _, tp_b = _model("gemma3-1b", seed=9)
    pool = EnginePool()
    toks = _toks(3, 5, seed=1)
    ref = pool.get(pcfg, tp, device="cpu").generate(toks, n_new=3)
    f1 = pool.speculate(pcfg, tp, toks, n_new=3, device="cpu")
    f2 = pool.speculate(pcfg, tp, toks, n_new=3, device="cpu")
    assert pool.inflight() == 2
    np.testing.assert_array_equal(pool.commit(f1), ref)
    assert pool.inflight() == 1
    pool.cancel(f2)
    assert pool.inflight() == 0
    pool.cancel(f2)                               # idempotent, not counted
    assert pool.spec_stats == {"issued": 2, "committed": 1, "cancelled": 1}
    with pytest.raises(RuntimeError, match="retired"):
        pool.commit(f2)
    # scoped cancel: only the named engine's speculation retires
    fa = pool.speculate(pcfg, tp, toks, n_new=2, device="cpu")
    fb = pool.speculate(pcfg, tp_b, toks, n_new=2, device="cpu")
    assert pool.cancel_all(pcfg, tp_b, device="cpu") == 1
    assert fb.cancelled and fa.live and pool.inflight() == 1
    assert pool.cancel_all() == 1
    assert not fa.live and pool.inflight() == 0
    assert pool.spec_stats["cancelled"] == 3


def test_engine_refuses_unported_and_encoder_configs():
    with pytest.raises(ValueError, match="not ported"):
        dataclasses.replace(ARCHS["gemma3-1b"], pos="mrope")
    with pytest.raises(ValueError, match="not ported"):
        LayerSpec("mamba", "dense")
    with pytest.raises(TypeError, match="moe"):
        dataclasses.replace(ARCHS["gemma3-1b"], moe=object())
    _, pcfg, _, tp = _model("gemma3-1b")
    with pytest.raises(ValueError, match="encoder-only"):
        GenerationEngine(dataclasses.replace(pcfg, causal=False), tp,
                         device="cpu")
