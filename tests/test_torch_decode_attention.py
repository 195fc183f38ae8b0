"""The port's decode attention (``repro_torch.kernels.decode_attention``)
against the JAX package: the Pallas kernel (interpret mode) and its
oracle ``decode_ref`` on ``tests/test_kernels.py``'s sweep, the model's
``_decode_attention`` at ragged cache lengths and hd 256, and the ring
cache's prefix argument (``repro_torch/models/attention.py``) across
wraps. On the CPU ``gqa_decode`` runs its plain version. Tolerances are
``tests/test_kernels.py``'s: fp32 atol/rtol 1e-4 (summation order),
bf16 2e-2 (one bf16 rounding of the output)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import gqa_decode as jax_gqa_decode
from repro.kernels.decode_attention.ref import decode_ref
from repro.models.attention import _decode_attention, ring_slot_positions
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ops import (decode_reference,
                                                      gqa_decode, split_plan)
from repro_torch.models import attention as A

torch.set_num_threads(1)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, s, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, h, d), np.float32),
            rng.standard_normal((b, s, kvh, d), np.float32),
            rng.standard_normal((b, s, kvh, d), np.float32))


def _port(q, k, v, length, dtype="float32"):
    t = [torch.from_numpy(x).to(TORCH[dtype]) for x in (q, k, v)]
    return gqa_decode(*t, length).float().numpy()


@pytest.mark.parametrize("b,s,h,kvh,d,length", [
    (2, 512, 4, 2, 64, 300),
    (1, 256, 8, 8, 32, 256),
    (2, 1024, 8, 2, 128, 1),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_kernel_and_oracle(b, s, h, kvh, d, length, dtype):
    q, k, v = _inputs(b, s, h, kvh, d, seed=s + length)
    jq, jk, jv = (jnp.asarray(x).astype(JNP[dtype]) for x in (q, k, v))
    pallas = jax_gqa_decode(jq, jk, jv, jnp.int32(length), bk=128,
                            interpret=True)
    oracle = decode_ref(jq.reshape(b, kvh, h // kvh, d), jk, jv, length)
    got = _port(q, k, v, length, dtype)
    tol = TOL[dtype]
    for ref in (pallas, oracle.reshape(b, 1, h, d)):
        np.testing.assert_allclose(got, np.asarray(ref.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("s,length", [(77, 77), (600, 513), (1000, 1)])
def test_matches_model_decode_attention_hd256(s, length):
    """Gemma's decode shape: 4 query heads on 1 KV head of 256 dims, at
    cache lengths the reference's kernel gate (S % 128) never takes."""
    q, k, v = _inputs(3, s, 4, 1, 256, seed=s)
    ref = _decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            valid_mask=jnp.arange(s) < length)
    np.testing.assert_allclose(_port(q, k, v, length), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)


def test_ring_prefix_matches_reference_mask_across_wraps():
    """A ring of 8 slots written at slot pos % 8: the reference's
    ``slot_pos >= 0 & slot_pos <= pos`` mask and the port's
    ``length = min(pos + 1, 8)`` give the same attention, from the first
    token to past two wraps."""
    window, b, h, d = 8, 2, 4, 256
    rng = np.random.default_rng(0)
    ck = np.zeros((b, window, 1, d), np.float32)
    cv = np.zeros((b, window, 1, d), np.float32)
    for pos in range(2 * window + 5):
        ck[:, pos % window] = rng.standard_normal((b, 1, d))
        cv[:, pos % window] = rng.standard_normal((b, 1, d))
        q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
        slot_pos = ring_slot_positions(jnp.int32(pos), window)
        valid = (slot_pos >= 0) & (slot_pos <= pos)
        ref = _decode_attention(jnp.asarray(q), jnp.asarray(ck),
                                jnp.asarray(cv), valid_mask=valid)
        assert int(valid.sum()) == min(pos + 1, window)
        np.testing.assert_array_equal(
            A.ring_slot_positions(pos, window).numpy(), np.asarray(slot_pos))
        got = _port(q, ck, cv, min(pos + 1, window))
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_model_decode_goes_through_the_wrapper_on_both_cache_kinds(
        monkeypatch):
    """Every decode attention of the port, full and ring, calls
    ``gqa_decode`` — no length gate, no plain path beside it."""
    import dataclasses
    from repro_torch.configs.registry import ARCHS
    seen = []
    real = A.gqa_decode

    def spy(q, k, v, length):
        seen.append((k.shape[1], length))
        return real(q, k, v, length)

    monkeypatch.setattr(A, "gqa_decode", spy)
    cfg = dataclasses.replace(ARCHS["gemma3-1b"].reduced(), window=8,
                              d_model=64, head_dim=32)
    rng = np.random.default_rng(1)
    p = {n: torch.from_numpy(rng.standard_normal(shape, np.float32) * 0.1)
         for n, shape in (("wq", (64, 4, 32)), ("wk", (64, 1, 32)),
                          ("wv", (64, 1, 32)), ("wo", (4, 32, 64)))}
    x = torch.from_numpy(rng.standard_normal((2, 1, 64), np.float32))
    for sliding, s_c, pos, want in ((False, 20, 13, 14), (True, 8, 5, 6),
                                    (True, 8, 13, 8)):
        cache = {"k": torch.zeros(2, s_c, 1, 32),
                 "v": torch.zeros(2, s_c, 1, 32)}
        A.apply_attn(p, x, cfg=cfg, sliding=sliding, mode="decode",
                     positions=torch.full((1,), pos), cache=cache, pos=pos)
        assert seen[-1] == (s_c, want)


def test_wrapper_checks_and_split_plan():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 16, 4, 1, 32, 0))
    for bad in (0, 17):
        with pytest.raises(ValueError, match="length"):
            gqa_decode(q, k, v, bad)
    with pytest.raises(ValueError, match="multiple"):
        gqa_decode(torch.zeros(1, 1, 3, 32), k[:, :, :1].expand(1, 16, 2, 32)
                   .contiguous(), v[:, :, :1].expand(1, 16, 2, 32)
                   .contiguous(), 4)
    with pytest.raises(TypeError, match="dtype"):
        gqa_decode(q.double(), k.double(), v.double(), 4)
    # the split: every key covered once, chunks of >= 64 keys, about 264
    # blocks at Gemma's decode (B = 8, one KV head, 4 query heads)
    for b, length in ((8, 1024), (8, 33), (64, 4096), (1, 1)):
        n, chunk = split_plan(b, 1, 4, length)
        assert chunk >= ops._MIN_CHUNK and chunk % 32 == 0
        assert (n - 1) * chunk < length <= n * chunk
    assert split_plan(8, 1, 4, 1024)[0] * 8 <= ops._TARGET_BLOCKS
    np.testing.assert_allclose(decode_reference(q, k, v, 16).numpy(),
                               gqa_decode(q, k, v, 16).numpy())


def test_cpu_call_uses_plain_version_without_counting():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 40, 4, 1, 256, 5))
    before = gqa_decode.launches
    out = gqa_decode(q, k, v, 33)
    assert gqa_decode.launches == before
    assert torch.equal(out, decode_reference(q, k, v, 33))


def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for b, s, h, kvh, hd, length in ((8, 1024, 4, 1, 256, 608),
                                     (3, 77, 12, 4, 128, 40),
                                     (64, 16, 4, 1, 256, 1)):
        q, k, v = (torch.from_numpy(x).cuda()
                   for x in _inputs(b, s, h, kvh, hd, seed=s))
        got = gqa_decode(q, k, v, length)
        ref = decode_reference(q, k, v, length)
        assert (got - ref).abs().max().item() <= 1e-4
