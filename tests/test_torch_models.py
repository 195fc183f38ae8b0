"""The port's encoders on weights converted from the JAX package: class
logits (atol 1e-4) and cache embeddings (atol 1e-5) for every
marketplace tier and the scorer, plus the layers they are built from.
fp32 on both sides; the tolerances cover summation-order differences
between XLA and torch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import neural_market as JNM
from repro.core import scorer as JSC
from repro.core.approx import embed_queries as jax_embed_queries
from repro.data import synthetic
from repro.models import layers as JL
from repro.models.classifier import jitted_logits
from repro.models.classifier import encoder_config as jax_encoder_config
from repro.models.classifier import init_classifier as jax_init_classifier
from repro_torch.convert import params_from_numpy
from repro_torch.core import neural_market as NM
from repro_torch.core import scorer as SC
from repro_torch.core.approx import embed_queries
from repro_torch.models import layers as L
from repro_torch.models.classifier import classifier_logits, init_classifier

torch.set_num_threads(1)


def _jax_tier_cfg(name, seq_len=64):
    # the inline config of repro's train_marketplace
    spec = JNM.TIERS[name]
    return jax_encoder_config(f"api-{name}", n_layers=spec["n_layers"],
                              d_model=spec["d_model"],
                              n_heads=max(2, spec["d_model"] // 32),
                              d_ff=2 * spec["d_model"], max_seq=seq_len + 4)


# one XLA program per config: a third faster than eager init on the CPU
_jax_init = jax.jit(jax_init_classifier, static_argnums=(1, 2))


def _converted(jax_cfg, port_cfg, n_classes, seed):
    jp = _jax_init(jax.random.PRNGKey(seed), jax_cfg, n_classes)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), port_cfg,
                           device="cpu")
    return jp, tp


CASES = [(name, 4) for name in NM.TIERS] + [("scorer", 1)]


@pytest.mark.parametrize("name,n_classes", CASES, ids=[c[0] for c in CASES])
def test_logits_and_embeddings_match_jax(name, n_classes):
    if name == "scorer":
        jcfg, pcfg = JSC.SCORER_CFG, SC.SCORER_CFG
        batch = synthetic.sample("headlines", 8, seed=3)
        toks = synthetic.append_answer(batch.tokens, batch.labels)   # S=66
    else:
        jcfg, pcfg = _jax_tier_cfg(name), NM.tier_config(name)
        toks = synthetic.sample("headlines", 8, seed=2).tokens        # S=64
    for field in ("n_layers", "d_model", "d_ff", "n_heads", "n_kv_heads",
                  "head_dim", "vocab", "max_seq", "causal", "pos"):
        assert getattr(jcfg, field) == getattr(pcfg, field), field
    jp, tp = _converted(jcfg, pcfg, n_classes, seed=len(name))
    assert len(tp["layers"]) == jcfg.n_layers
    ref = np.asarray(jitted_logits(jcfg)(jp, jnp.asarray(toks)))
    got = classifier_logits(tp, toks, pcfg).numpy()
    assert got.shape == ref.shape == (8, n_classes)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    ref_e = jax_embed_queries(jp, toks, jcfg)
    got_e = embed_queries(tp, toks, pcfg)
    assert got_e.dtype == np.float32 and got_e.shape == ref_e.shape
    np.testing.assert_allclose(got_e, ref_e, atol=1e-5, rtol=0)


def test_seeded_init_matches_reference_shapes_and_scales():
    jcfg, pcfg = _jax_tier_cfg("ChatGPT"), NM.tier_config("ChatGPT")
    jp = jax.tree.map(np.asarray, _jax_init(jax.random.PRNGKey(0), jcfg, 4))
    tp = init_classifier(pcfg, 4, seed=0, device="cpu")
    conv = params_from_numpy(jp, pcfg, device="cpu")
    flat = lambda t: sorted(  # noqa: E731
        (k, tuple(v.shape)) for k, v in _leaves(t))
    assert flat(tp) == flat(conv)
    w = tp["layers"][0]["mixer"]["wq"]
    assert abs(float(w.std()) - 0.02) < 0.002
    again = init_classifier(pcfg, 4, seed=0, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(_leaves(tp), _leaves(again)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_layers_match_jax():
    cfg = NM.tier_config("GPT-C")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64), np.float32) * 3 + 1
    norm = {"scale": rng.standard_normal(64, np.float32),
            "bias": rng.standard_normal(64, np.float32)}
    ref = JL.apply_norm({k: jnp.asarray(v) for k, v in norm.items()},
                        jnp.asarray(x), _jax_tier_cfg("GPT-C"))
    got = L.apply_norm({k: torch.from_numpy(v) for k, v in norm.items()},
                       torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    mlp = {"up": {"w": rng.standard_normal((64, 128), np.float32) * 0.1},
           "down": {"w": rng.standard_normal((128, 64), np.float32) * 0.1}}
    ref = JL.apply_mlp(jax.tree.map(jnp.asarray, mlp), jnp.asarray(x),
                       _jax_tier_cfg("GPT-C"))
    got = L.apply_mlp({k: {"w": torch.from_numpy(v["w"])}
                       for k, v in mlp.items()}, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_converter_rejects_wrong_depth():
    jcfg, pcfg = _jax_tier_cfg("GPT-J"), NM.tier_config("GPT-C")
    tree = jax.tree.map(np.asarray, _jax_init(jax.random.PRNGKey(0), jcfg, 4))
    with pytest.raises(ValueError, match="layers"):
        params_from_numpy(tree, pcfg, device="cpu")
