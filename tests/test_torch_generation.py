"""The port's generation path (``repro_torch.models.transformer`` prefill /
decode and ``repro_torch.serving.engine``) against the JAX package, on
weights converted from JAX params, fp32 on the CPU.

Configs: ``gemma3-1b`` reduced (two sliding layers, window 64); a mixed
local/global Gemma (hd 256, window 8: every decode wraps its ring and
the global layer takes the full-cache path); the registry's other
dense configs, ``mistral-nemo-12b`` and ``starcoder2-15b``, reduced; the
MoE configs ``granite-moe-1b-a400m`` and ``moonshot-v1-16b-a3b`` (a
shared expert) and the SSM config ``mamba2-1.3b``, reduced; and a
3-layer Jamba hybrid (mamba + dense, attention + MoE, mamba + MoE), since
``reduced()`` of Jamba keeps no attention layer.

Tolerances: logits atol 1e-4 (fp32 summation order over two to four
layers; logits are of order 0.1-1). Greedy tokens must be identical, and
every greedy step's top-2 logit margin is asserted >= 1e-4 so that
float noise cannot flip a token. Sampled tokens (temperature > 0) are
not compared with JAX: a ``torch.Generator`` cannot give JAX's
``categorical`` bits.

bf16 (Mamba2, Granite and the Jamba hybrid, reduced): prefill and
teacher-forced decode logits against the reference's, under
``jax_bf16_reference`` (below), within 3 bf16 ulps of max|ref| (3 x 2^-7
x max|ref|). The port makes the reference's bf16 roundings, but an fp32
intermediate (a norm, rope, attention, an SSD sum) lands on the other
side of a bf16 rounding boundary for about one element in 10^4, since
transcendentals and summation orders differ in the last fp32 bit; such
1-ulp flips carry through the layers. Where a cast differs, every
element is affected: ``tests/test_torch_ssm.py`` and
``tests/test_torch_moe.py`` hold each layer's bf16 output bit for bit.
"""
import contextlib
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.registry import ARCHS as JARCHS
from repro.kernels import enable_kernels, kernels_enabled
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serving.engine import GenerationEngine as JEngine
from repro_torch.configs.base import LayerSpec
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serving.engine import (EnginePool, GenerationEngine,
                                        bucket_size)

torch.set_num_threads(1)
LOGIT_TOL = 1e-4
MARGIN = 1e-4


def _hybrid(archs, spec):
    layers = (spec("mamba", "dense"), spec("attn", "moe"),
              spec("mamba", "moe"))
    return dataclasses.replace(archs["jamba-v0.1-52b"].reduced(),
                               name="jamba-hybrid", n_layers=3,
                               period=layers, n_periods=1)


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
    "granite-moe-1b-a400m": lambda: (
        JARCHS["granite-moe-1b-a400m"].reduced(),
        ARCHS["granite-moe-1b-a400m"].reduced()),
    "moonshot-v1-16b-a3b": lambda: (JARCHS["moonshot-v1-16b-a3b"].reduced(),
                                    ARCHS["moonshot-v1-16b-a3b"].reduced()),
    "mamba2-1.3b": lambda: (JARCHS["mamba2-1.3b"].reduced(),
                            ARCHS["mamba2-1.3b"].reduced()),
    "jamba-hybrid": lambda: (_hybrid(JARCHS, JLayerSpec),
                             _hybrid(ARCHS, LayerSpec)),
}


def numpy_params(jcfg, seed):
    """Weights for both packages, made with numpy from ``seed`` in the
    reference's tree (its shapes from ``jax.eval_shape``, so no init is
    compiled): N(0, 0.02) matrices, norm scales 1 + N(0, 0.1), biases
    N(0, 0.1); in Mamba layers the gated norm and D 1 + N(0, 0.1), the
    convs and dt bias N(0, 0.1), A_log = log U(1, 16); MoE routers
    N(0, 0.1), which spreads the routing away from top-k ties."""
    shapes = jax.eval_shape(functools.partial(JT.init_params, cfg=jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name in ("scale", "norm", "D"):
            return 1 + 0.1 * x
        if name == "A_log":
            return np.log(rng.uniform(1, 16, leaf.shape)).astype(np.float32)
        if name in ("bias", "dt_bias", "router") or name.startswith("conv"):
            return 0.1 * x
        return 0.02 * x

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
# is not padded (the engine's ``_seq_paddable`` rule); nor are the stacks
# with a Mamba layer, whose prompts span a ragged second SSD chunk (32).
# The MoE configs pad to the engine's own bucket of 16, since an expert's
# capacity follows the padded length.
PREFILL = {"gemma3-1b": (60, 62, 68), "gemma3-mixed": (13, 13, 32),
           "mistral-nemo-12b": (13, 16, 32), "starcoder2-15b": (60, 62, 68),
           "granite-moe-1b-a400m": (13, 16, 32),
           "moonshot-v1-16b-a3b": (13, 16, 32),
           "mamba2-1.3b": (45, 45, 64), "jamba-hybrid": (45, 45, 64)}


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
        assert set(got) == set(ref)
        for leaf in ref:
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
# chain above). The MoE, Mamba and hybrid stacks run a prompt within one
# bucket, over two buckets, and one past an SSD chunk.
GENERATE_CONFIGS = {"gemma3-1b": GENERATE[:-1], "gemma3-mixed": GENERATE[-1:],
                    "granite-moe-1b-a400m": GENERATE[:3],
                    "moonshot-v1-16b-a3b": GENERATE[:2],
                    "mamba2-1.3b": GENERATE[:2] + [(2, 40, 6)],
                    "jamba-hybrid": GENERATE[:1] + [(2, 40, 6)]}


def _bucket_exact(cfg):
    """Whether the engine's tokens equal the unbucketed chain's: bucketing
    is exact unless a padded prompt changes an MoE layer's capacity."""
    return not any(s.ffn == "moe" and s.mixer.startswith("attn")
                   for s in cfg.layers) or any(s.mixer == "mamba"
                                               for s in cfg.layers)


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
        if n and _bucket_exact(pcfg):
            chain, margin = _port_chain(tp, pcfg, toks, n)
            assert margin >= MARGIN
            np.testing.assert_array_equal(got, chain)  # bucketing is exact
        np.testing.assert_array_equal(got, jeng.generate(toks, n_new=n_new))
    assert peng.compile_stats == jeng.compile_stats


@contextlib.contextmanager
def jax_bf16_reference():
    """The JAX package's bf16 arithmetic as its accelerator runs it, for
    holding the port's bf16 to it on the CPU. Three things differ from a
    plain CPU run, and nothing in the package changes:
      * ``jax.nn.silu`` rounds once: XLA's CPU backend rounds every
        primitive of x * 1 / (1 + exp(-x)) to bf16, where a fused
        accelerator kernel (and torch) rounds the fp32 result once;
      * the MoE layer's batched bf16 x bf16 -> fp32 einsums run as the
        same einsum of the operands upcast to fp32 (exact products, fp32
        sums), since XLA's CPU backend cannot run that dot (jax 0.9,
        "Unsupported element type for DotThunk");
      * kernels are enabled, so the MoE layer takes its grouped-matmul
        branch (``expert_mlp``, h = silu(g) * u in fp32) where b * cap is
        a multiple of 8, the branch the port takes for every layer.
    Attention and SSD prefill keep the plain jnp paths at the lengths
    used here (no multiple of 128; SSD's kernel is train-only)."""
    silu, jnp_mod, was = jax.nn.silu, JM.jnp, kernels_enabled()

    def einsum(*args, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            # reduce_precision keeps the operand's bf16 rounding, which
            # XLA would otherwise drop from a fused bf16 producer
            args = [jax.lax.reduce_precision(a.astype(jnp.float32), 8, 7)
                    if getattr(a, "dtype", None) == jnp.bfloat16 else a
                    for a in args]
        return jnp.einsum(*args, preferred_element_type=preferred_element_type,
                          **kw)

    shim = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    shim.einsum = einsum
    jax.nn.silu = lambda x: silu(x.astype(jnp.float32)).astype(x.dtype)
    JM.jnp = shim
    enable_kernels(True)
    try:
        yield
    finally:
        jax.nn.silu, JM.jnp = silu, jnp_mod
        enable_kernels(was)


def assert_bf16_equal(got, ref):
    """got (torch bf16) equals ref (jax bf16) bit for bit on >= 95% of the
    elements, and within one bf16 ulp of max|ref| everywhere."""
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.shape == ref.shape
    assert (got == ref).mean() >= 0.95, (got == ref).mean()
    assert np.abs(got - ref).max() <= 2 ** -7 * np.abs(ref).max()


@contextlib.contextmanager
def _router_gaps():
    """Records the smallest gap between the k-th and (k+1)-th router
    probability of every token in the port's MoE layers."""
    orig, gaps = M.router, []

    def router(p, x, cfg):
        probs, w, e_idx = orig(p, x, cfg)
        top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values
        gaps.append(float((top[..., -2] - top[..., -1]).min()))
        return probs, w, e_idx

    M.router = router
    try:
        yield gaps
    finally:
        M.router = orig


BF16_ULP = 2 ** -7          # bf16's spacing at 1.0
# a 1-ulp flip in the hidden state (2^-8 x ~1) moves a router logit by
# ~4e-4 (router weights ~0.1) and a probability by ~1e-4: a top-k gap
# under twice that could swap an expert between the two packages
ROUTER_GAP = 2e-4
BF16_CASES = ["mamba2-1.3b", "granite-moe-1b-a400m", "jamba-hybrid"]


@pytest.mark.parametrize("name", BF16_CASES)
def test_bf16_prefill_and_decode_logits_match_jax(name):
    """B = 8 prompts of 16 tokens (b * cap a multiple of 8 in prefill and
    decode), then 5 decode steps on seeded tokens, in bf16."""
    jcfg, pcfg, jp, tp = _model(name)
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    pcfg = dataclasses.replace(pcfg, dtype="bfloat16")
    tp = T.cast_params(tp, pcfg)
    toks, forced = _toks(8, 16, seed=5), _toks(8, 5, seed=9)
    with jax_bf16_reference():
        jlog, jcache = jax.jit(functools.partial(JT.prefill, cfg=jcfg,
                                                 max_len=21))(
            jp, {"tokens": jnp.asarray(toks)})
        jdec = jax.jit(functools.partial(JT.decode_step, cfg=jcfg))
        ref = [np.asarray(jlog)]
        for i in range(5):
            jlog, jcache = jdec(jp, jcache, jnp.asarray(forced[:, i:i + 1]),
                                jnp.int32(16 + i))
            ref.append(np.asarray(jlog))
    with _router_gaps() as gaps:
        plog, cache = T.prefill(tp, {"tokens": toks}, pcfg, max_len=21)
        got = [plog.numpy()]
        for i in range(5):
            plog, cache = T.decode_step(tp, cache,
                                        torch.from_numpy(forced[:, i:i + 1]),
                                        16 + i, pcfg)
            got.append(plog.numpy())
    assert min(gaps, default=1.0) >= ROUTER_GAP
    for step, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == np.float32 and g.shape == r.shape == (8, 1,
                                                                pcfg.vocab)
        err, top = np.abs(g - r).max(), np.abs(r).max()
        assert err <= 3 * BF16_ULP * top, (step, err, top)


def test_init_cache_matches_jax_layout():
    for name in CONFIGS:
        jcfg, pcfg, _, _ = _model(name)
        ref = _jax_layers(JT.init_cache(jcfg, 2, 100), jcfg)
        got = T.init_cache(pcfg, 2, 100)
        assert [{k: tuple(v.shape) for k, v in c.items()} for c in got] == \
            [{k: v.shape for k, v in c.items()} for c in ref]
        assert all(not v.any() and v.dtype == torch.float32
                   for c in got for v in c.values())


def test_seq_paddable_rule_and_buckets_match_jax():
    for name in CONFIGS:
        jcfg, pcfg, jp, tp = _model(name)
        jeng, peng = JEngine(jcfg, jp), GenerationEngine(pcfg, tp,
                                                         device="cpu")
        for s_b in (8, 16, 32, 64, 128):
            assert peng._seq_paddable(s_b) == jeng._seq_paddable(s_b), (name,
                                                                        s_b)
            if name in ("mamba2-1.3b", "jamba-hybrid"):   # SSM: never
                assert not peng._seq_paddable(s_b)
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
    """MLA and mrope are still unported; Mamba and MoE layers run, and a
    stack of them needs its sub-config."""
    with pytest.raises(ValueError, match="not ported"):
        dataclasses.replace(ARCHS["gemma3-1b"], pos="mrope")
    with pytest.raises(TypeError, match="mla"):
        dataclasses.replace(ARCHS["gemma3-1b"], mla=object())
    with pytest.raises(ValueError, match="not ported"):
        LayerSpec("mla", "dense")
    assert LayerSpec("mamba", "moe").ffn == "moe"
    with pytest.raises(ValueError, match="ssm="):
        dataclasses.replace(ARCHS["mamba2-1.3b"], ssm=None)
    with pytest.raises(ValueError, match="moe="):
        dataclasses.replace(ARCHS["granite-moe-1b-a400m"], moe=None)
    _, pcfg, _, tp = _model("gemma3-1b")
    with pytest.raises(ValueError, match="encoder-only"):
        GenerationEngine(dataclasses.replace(pcfg, causal=False), tp,
                         device="cpu")
