"""The port's generation layers against the JAX package's
(``repro/models/layers.py``): RMSNorm, the gated MLPs (GeGLU with
tanh-gelu, SwiGLU with silu), half-split RoPE and the tied unembedding,
plus the compute-dtype cast of converted params. fp32 on both sides,
atol 1e-5 with rtol 1e-5 for outputs of order 1 (a few fp32 ulps): XLA
and torch sum and evaluate sin/cos in different orders."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import layers as JL
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as L
from test_torch_generation import numpy_params

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(name="gemma3-1b", **kw):
    return (dataclasses.replace(JARCHS[name].reduced(), **kw),
            dataclasses.replace(ARCHS[name].reduced(), **kw))


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def test_rmsnorm_matches_jax():
    jcfg, pcfg = _cfgs()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 256), np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(256, np.float32)}
    ref = JL.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    got = L.apply_norm(_t(p), torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("act", ["geglu", "swiglu", "gelu"])
def test_mlp_matches_jax(act):
    jcfg, pcfg = _cfgs(ffn_act=act)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 256), np.float32)
    p = {k: {"w": rng.standard_normal(shape, np.float32) * 0.1}
         for k, shape in (("up", (256, 512)), ("gate", (256, 512)),
                          ("down", (512, 256)))}
    if act == "gelu":
        del p["gate"]
    ref = JL.apply_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    got = L.apply_mlp(_t(p), torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("hd,theta", [(64, 1e6), (256, 1e6), (128, 1e5)])
def test_rope_matches_jax(hd, theta):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd), np.float32)
    pos = np.stack([np.arange(9), np.arange(40, 49)]).astype(np.int32)
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(L.rope_freqs(hd, theta).shape, (hd // 2,))


def test_tied_unembed_matches_jax():
    jcfg, pcfg = _cfgs()
    assert jcfg.tie_embeddings and pcfg.tie_embeddings
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, 256), np.float32)
    p = {"tok": rng.standard_normal((1024, 256), np.float32) * 0.02}
    ref = JL.unembed(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    got = L.unembed(_t(p), torch.from_numpy(x), pcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_bf16_params_round_like_reference_casts():
    """Converted bf16 params hold the values the reference's ``cast``
    gives at each use; norm scales stay fp32, and the tied logits table
    is those bf16 values stored in fp32 so the logits are an fp32
    product (the reference's ``preferred_element_type=float32``)."""
    jcfg, pcfg = _cfgs(dtype="bfloat16")
    params = numpy_params(jcfg, seed=0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, pcfg, device="cpu")
    wq = tp["layers"][0]["mixer"]["wq"]
    assert wq.dtype == torch.bfloat16
    ref = np.asarray(JL.cast(jp["period"]["sub0"]["mixer"]["wq"][0], jcfg)
                     .astype(jnp.float32))
    np.testing.assert_array_equal(wq.float().numpy(), ref)
    assert tp["layers"][0]["norm1"]["scale"].dtype == torch.float32
    tok = tp["embed"]["tok"]
    assert tok.dtype == torch.float32
    np.testing.assert_array_equal(
        tok.numpy(), np.asarray(JL.cast(jp["embed"]["tok"], jcfg)
                                .astype(jnp.float32)))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, 256), np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = JL.unembed(jp["embed"], xb, jcfg)
    got = L.unembed(tp["embed"], torch.from_numpy(x).bfloat16(), pcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-6)
