"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package: ``_chunked_attention`` at the serve path's
shapes, and the Pallas kernel (interpret mode) and its oracle elsewhere.

On the CPU ``mha`` runs its plain version. Tolerance: fp32, atol and
rtol 1e-5 — XLA and torch sum in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import mha as jax_mha
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.attention import _chunked_attention
from repro_torch.kernels.flash_attention.ops import mha, mha_reference

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(b, s, h, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd), np.float32),
            rng.standard_normal((b, s, kvh, hd), np.float32),
            rng.standard_normal((b, s, kvh, hd), np.float32))


def _port(q, k, v, **kw):
    return mha(*(torch.from_numpy(x) for x in (q, k, v)), **kw).numpy()


def _flat_ref(q, k, v, *, causal, window):
    """attention_ref over (B*H, S, hd) with KV heads repeated (GQA)."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    flat = lambda x: x.transpose(0, 2, 1, 3).reshape(b * h, s, hd)  # noqa: E731
    r = attention_ref(flat(q), flat(np.repeat(k, g, 2)),
                      flat(np.repeat(v, g, 2)), causal=causal, window=window)
    return np.asarray(r).reshape(b, h, s, hd).transpose(0, 2, 1, 3)


# every tier's and the scorer's (H, hd), at S = 64 (queries) and 66 (pairs)
@pytest.mark.parametrize("s,h,hd", [(64, 2, 16), (64, 2, 24), (64, 3, 32),
                                    (64, 4, 32), (64, 5, 32), (66, 4, 32),
                                    (66, 2, 16)])
def test_matches_chunked_attention_on_serve_shapes(s, h, hd):
    q, k, v = _inputs(3, s, h, h, hd, seed=s * 100 + h * 10 + hd)
    ref = _chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=False, window=0)
    np.testing.assert_allclose(_port(q, k, v, causal=False), np.asarray(ref),
                               **TOL)


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 64),
                                           (False, 32)])
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2)])
def test_matches_pallas_kernel_and_oracle(s, causal, window, h, kvh):
    q, k, v = _inputs(2, s, h, kvh, 32, seed=s + 7 * window + h + kvh)
    got = _port(q, k, v, causal=causal, window=window)
    pallas = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, _flat_ref(q, k, v, causal=causal,
                                              window=window), **TOL)


@pytest.mark.parametrize("s", [1, 7, 200])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 32)])
def test_ragged_lengths_match_oracle(s, causal, window):
    q, k, v = _inputs(2, s, 8, 2, 24, seed=s)
    np.testing.assert_allclose(
        _port(q, k, v, causal=causal, window=window),
        _flat_ref(q, k, v, causal=causal, window=window), **TOL)


def test_window_of_one_attends_to_itself_only():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 5, 2, 2, 16, seed=0))
    np.testing.assert_allclose(
        mha(q, k, v, causal=True, window=1).numpy(), v.numpy(), rtol=1e-6)


def test_cpu_call_uses_plain_version_without_counting():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 9, 4, 2, 16, seed=1))
    before = mha.launches
    out = mha(q, k, v, causal=False)
    assert mha.launches == before
    assert torch.equal(out, mha_reference(q, k, v, causal=False))


def test_validation_errors():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 8, 4, 2, 16, seed=2))
    with pytest.raises(ValueError, match="multiple"):
        mha(q, k[:, :, :1].expand(2, 8, 3, 16).contiguous(),
            v[:, :, :1].expand(2, 8, 3, 16).contiguous())
    with pytest.raises(ValueError, match="k/v"):
        mha(q, k[:, :4], v)
    with pytest.raises(TypeError, match="dtype"):
        mha(q, k.double(), v)
    with pytest.raises(ValueError, match="B, S, H, hd"):
        mha(q[0], k, v)


def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for s, hd, causal, window in ((66, 32, False, 0), (7, 24, True, 0),
                                  (200, 128, True, 32)):
        q, k, v = (torch.from_numpy(x).cuda()
                   for x in _inputs(4, s, 4, 2, hd, seed=s))
        got = mha(q, k, v, causal=causal, window=window)
        ref = mha_reference(q, k, v, causal=causal, window=window)
        assert (got - ref).abs().max().item() <= 1e-4
