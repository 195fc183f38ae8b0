"""The port's MoE layer (``repro_torch.models.moe``) and grouped-matmul
kernel wrapper (``repro_torch.kernels.moe_gmm``) against the JAX package,
on the CPU, where ``gmm`` runs its plain version.

  * ``gmm_reference`` against the Pallas ``gmm`` (interpret mode) and its
    oracle ``gmm_ref`` on ``tests/test_kernels.py``'s sweep plus ragged
    capacities; ``expert_mlp`` against the reference's ``expert_mlp``.
    fp32 within 1e-5 x max|ref| (summation order over K <= 256); bf16
    against ``gmm_ref`` within one bf16 rounding of the output.
  * ``apply_moe`` against the reference's on reduced Granite and reduced
    Moonlight (one shared expert), with a capacity factor small enough
    that tokens drop, and on a t = 1 decode group: y and the aux loss
    within 1e-5 relative; the routing, drop pattern and slot indices
    exactly, against the reference's dispatch lines
    (``repro/models/moe.py:57-74,101-106``) run in jnp on the reference's
    router probabilities.
  * ``apply_moe`` in bf16 against the reference's grouped-matmul branch
    (b * cap a multiple of 8, under ``jax_bf16_reference``), prefill and
    decode groups, with Moonlight's shared experts: y bit for bit on at
    least 95% of its elements (99.99-100% seen) and within one bf16 ulp
    of max|ref|. Rounding h = silu(g) * u, the combine or the shared
    experts' sum anywhere else leaves 46-82% of y equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.kernels.moe_gmm.kernel import gmm as jax_gmm
from repro.kernels.moe_gmm.ops import expert_mlp as jax_expert_mlp
from repro.kernels.moe_gmm.ref import gmm_ref
from repro.models import moe as JM
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels.moe_gmm.ops import expert_mlp, gmm, gmm_reference
from repro_torch.models import moe as M
from test_torch_generation import assert_bf16_equal, jax_bf16_reference

torch.set_num_threads(1)
REL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


# tests/test_kernels.py's gmm sweep, then capacities off its 128 grid
# (C = 1 is a decode group, 40 Granite's B=8 prefill, 5 and 77 no
# multiple of 8); the Pallas kernel takes any C, K, F below 128
@pytest.mark.parametrize("e,c,k,f", [(4, 256, 128, 256), (2, 128, 256, 128),
                                     (8, 128, 128, 384), (4, 1, 64, 96),
                                     (3, 5, 72, 40), (2, 40, 128, 64),
                                     (5, 77, 33, 100)])
def test_gmm_reference_matches_jax(e, c, k, f):
    x, w = _rand((e, c, k), c), _rand((e, k, f), k + f)
    got = gmm_reference(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (e, c, f)
    _close(got, gmm_ref(jnp.asarray(x), jnp.asarray(w)))
    _close(got, jax_gmm(jnp.asarray(x), jnp.asarray(w), interpret=True))
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = gmm.launches
    assert torch.equal(gmm(torch.from_numpy(x), torch.from_numpy(w)), got)
    assert gmm.launches == before


@pytest.mark.parametrize("e,c,k,f", [(4, 256, 128, 256), (3, 5, 72, 40)])
def test_gmm_reference_bf16_matches_gmm_ref(e, c, k, f):
    x, w = _rand((e, c, k), c), _rand((e, k, f), k + f)
    xb, wb = (torch.from_numpy(a).bfloat16() for a in (x, w))
    got = gmm_reference(xb, wb)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(gmm_ref(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(w, jnp.bfloat16)).astype(jnp.float32))
    # both accumulate the same bf16 products in fp32 and round once
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-6)


def test_expert_mlp_matches_jax():
    e, c, d, f = 2, 128, 64, 128
    x = _rand((e, c, d), 1)
    wg, wu = _rand((e, d, f), 2, 0.1), _rand((e, d, f), 3, 0.1)
    wd = _rand((e, f, d), 4, 0.1)
    before = gmm.launches
    got = expert_mlp(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    assert gmm.launches == before
    _close(got, jax_expert_mlp(*(jnp.asarray(a) for a in (x, wg, wu, wd)),
                               interpret=True))


def _cfgs(name, capacity_factor=None):
    jcfg, pcfg = JARCHS[name].reduced(), ARCHS[name].reduced()
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, capacity_factor=capacity_factor))
    return jcfg, pcfg


def _moe_params(cfg, seed):
    """numpy weights in the reference's layout (``init_moe``'s shapes,
    from ``jax.eval_shape``, so no init is compiled)."""
    shapes = jax.eval_shape(lambda k: JM.init_moe(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    # the router at 5x the init scale spreads the routing, so that the
    # top-k sets are far from ties
    return {k: (0.1 if k == "router" else 0.02)
            * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in shapes.items()}


def _jax_dispatch(probs, cfg, t):
    """The reference's routing and dispatch lines (moe.py:57-74, 101-106)
    on its router probabilities."""
    e = cfg.moe
    cap = JM.capacity(cfg, t)
    w, e_idx = jax.lax.top_k(probs, e.top_k)
    assign = jax.nn.one_hot(e_idx, e.n_experts, dtype=jnp.float32)
    tok_mask = assign.sum(2)
    prio = tok_mask * (t - jnp.arange(t, dtype=jnp.float32))[None, :, None]
    top_p, top_i = jax.lax.top_k(jnp.swapaxes(prio, 1, 2), cap)
    pos_all = jnp.cumsum(tok_mask, axis=1) - tok_mask
    pos_tk = jnp.take_along_axis(pos_all, e_idx.astype(jnp.int32), axis=2)
    return {"e_idx": e_idx, "top_i": top_i, "slot_valid": top_p > 0.0,
            "keep": pos_tk < cap,
            "slot": jnp.minimum(pos_tk.astype(jnp.int32), cap - 1)}


# (config, capacity factor, batch groups, tokens per group): the configs'
# own factor 1.25, a factor of 0.5 that drops tokens, and a decode group
CASES = [("granite-moe-1b-a400m", None, 3, 24),
         ("granite-moe-1b-a400m", 0.5, 2, 32),
         ("granite-moe-1b-a400m", None, 8, 1),
         ("moonshot-v1-16b-a3b", None, 3, 24),
         ("moonshot-v1-16b-a3b", 0.5, 2, 32),
         ("moonshot-v1-16b-a3b", None, 8, 1)]


@pytest.mark.parametrize("name,cf,b,t", CASES)
def test_apply_moe_matches_jax(name, cf, b, t):
    jcfg, pcfg = _cfgs(name, cf)
    params = _moe_params(jcfg, seed=t)
    x = _rand((b, t, pcfg.d_model), seed=b * t)
    jy, jaux = jax.jit(lambda p, x: JM.apply_moe(p, x, cfg=jcfg))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tx = torch.from_numpy(x)
    y, aux = M.apply_moe(tp, tx, cfg=pcfg)
    assert y.shape == (b, t, pcfg.d_model) and y.dtype == torch.float32
    _close(y, jy)
    assert abs(float(aux) - float(jaux)) <= REL * abs(float(jaux))
    assert ("sh_up" in tp) == (name == "moonshot-v1-16b-a3b")

    # routing, drops and slots: exactly the reference's
    probs, _, e_idx = M.router(tp, tx, pcfg)
    r = {"e_idx": e_idx, **M.dispatch(probs, e_idx, pcfg)}
    logits = jnp.einsum("btd,de->bte", jnp.asarray(x),
                        jnp.asarray(params["router"]))
    jr = _jax_dispatch(jax.nn.softmax(logits, -1), jcfg, t)
    assert r["cap"] == JM.capacity(jcfg, t)
    np.testing.assert_array_equal(np.sort(r["e_idx"].numpy(), -1),
                                  np.sort(np.asarray(jr["e_idx"]), -1))
    valid = np.asarray(jr["slot_valid"])
    np.testing.assert_array_equal(r["slot_valid"].numpy(), valid)
    np.testing.assert_array_equal(r["top_i"].numpy()[valid],
                                  np.asarray(jr["top_i"])[valid])
    # keep/slot per (token, expert): the k order of equal sets may differ
    order = np.argsort(r["e_idx"].numpy(), -1)
    jorder = np.argsort(np.asarray(jr["e_idx"]), -1)
    for key in ("keep", "slot"):
        np.testing.assert_array_equal(
            np.take_along_axis(r[key].numpy(), order, -1),
            np.take_along_axis(np.asarray(jr[key]), jorder, -1))
    dropped = int((~r["keep"]).sum())
    if cf is not None:
        assert dropped > 0               # the small factor does drop
    if t == 1:
        assert r["cap"] == 1 and dropped == 0


# (config, tokens per group) at 8 groups: a decode group (cap 1) and a
# prefill of 16 (cap 10); b * cap is a multiple of 8 in both, so the
# reference takes the grouped-matmul branch the port always takes
@pytest.mark.parametrize("name,t", [("granite-moe-1b-a400m", 1),
                                    ("granite-moe-1b-a400m", 16),
                                    ("moonshot-v1-16b-a3b", 1),
                                    ("moonshot-v1-16b-a3b", 16)])
def test_apply_moe_bf16_matches_jax(name, t):
    jcfg, pcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in _cfgs(name))
    assert (8 * JM.capacity(jcfg, t)) % 8 == 0
    params = _moe_params(jcfg, seed=t)
    x = _rand((8, t, pcfg.d_model), seed=t + 1)
    with jax_bf16_reference():
        jy, _ = jax.jit(lambda p, x: JM.apply_moe(p, x, cfg=jcfg))(
            {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(x, jnp.bfloat16))
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in params.items()}
    y, _ = M.apply_moe(tp, torch.from_numpy(x).bfloat16(), cfg=pcfg)
    assert_bf16_equal(y, jy)


def test_padding_never_takes_a_real_tokens_slot():
    """Right-padded tokens come last in the earliest-token dispatch: the
    real tokens' outputs do not depend on what the pad rows hold."""
    _, pcfg = _cfgs("granite-moe-1b-a400m", 0.5)
    jcfg, _ = _cfgs("granite-moe-1b-a400m", 0.5)
    tp = {k: torch.from_numpy(v) for k, v in _moe_params(jcfg, 3).items()}
    x = torch.from_numpy(_rand((2, 32, pcfg.d_model), 5))
    x2 = x.clone()
    x2[:, 20:] = torch.from_numpy(_rand((2, 12, pcfg.d_model), 6))
    y, _ = M.apply_moe(tp, x, cfg=pcfg)
    y2, _ = M.apply_moe(tp, x2, cfg=pcfg)
    torch.testing.assert_close(y[:, :20], y2[:, :20], rtol=0, atol=0)


def test_gmm_kernel_matches_plain_version_on_card():
    """fp32 on CUDA cores within 1e-5 x max|ref|; bf16 on every
    tensor-core instance (swapped at C <= 8 and <= 16, 64 x 128 and
    128 x 128 tiles, masked scalar loads for K or F off a multiple of 8)
    within one bf16 rounding, 1e-2 x max|ref|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.moe_gmm.ops import INSTANCES
    taken = set()
    for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for e, c, k, f in ((32, 8, 1024, 512), (32, 13, 1024, 512),
                           (32, 40, 512, 1024), (32, 320, 1024, 512),
                           (3, 77, 33, 130), (1, 7, 5, 3)):
            x = torch.from_numpy(_rand((e, c, k), c)).cuda().to(dtype)
            w = torch.from_numpy(_rand((e, k, f), k)).cuda().to(dtype)
            got, ref = gmm(x, w).float(), gmm_reference(x, w).float()
            taken.add(gmm.last_instance)
            assert (got - ref).abs().max().item() <= \
                rel * ref.abs().max().item()
    assert taken == set(INSTANCES)


def test_gmm_instance_names_a_bf16_instance():
    """``instance`` takes a bf16 instance's name or None; the CPU runs the
    plain version whatever it names."""
    from repro_torch.kernels.moe_gmm.ops import INSTANCES
    x = torch.from_numpy(_rand((2, 8, 16), 1))
    w = torch.from_numpy(_rand((2, 16, 24), 2))
    for name in (None, *INSTANCES[1:]):
        assert torch.equal(gmm(x, w, instance=name), gmm_reference(x, w))
    for name in ("fp32_cuda_cores", "bf16"):
        with pytest.raises(ValueError, match="instance must be one of"):
            gmm(x, w, instance=name)


def test_gmm_swapped_instances_agree_at_decode_on_card():
    """Both swapped-operand instances forced at Granite's decode group of
    C 8 agree with the plain version within 1e-2 x max|ref| (bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for k, f in ((1024, 512), (512, 1024)):
        x = torch.from_numpy(_rand((32, 8, k), k)).cuda().bfloat16()
        w = torch.from_numpy(_rand((32, k, f), f, 0.02)).cuda().bfloat16()
        ref = gmm_reference(x, w).float()
        for name in ("bf16_tc_swap_c8", "bf16_tc_swap_c16"):
            got = gmm(x, w, instance=name).float()
            assert gmm.last_instance == name
            assert (got - ref).abs().max().item() <= \
                1e-2 * ref.abs().max().item()
