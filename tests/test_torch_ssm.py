"""The port's Mamba-2 mixer (``repro_torch.models.ssm``) and SSD-scan kernel
wrapper (``repro_torch.kernels.ssd_scan``) against the JAX package, on
the CPU, where ``ssd_scan`` runs its plain version.

  * ``ssd_reference`` / ``ssd_scan`` against the Pallas ``ssd_scan``
    (interpret mode), its sequential oracle ``ssd_ref`` and the model's
    ``ssd_chunked`` (y and final state) on ``tests/test_kernels.py``'s
    sweep plus ragged lengths, fp32 within 1e-5 x max|ref| (the sweep's
    own fp32 bound); in bf16 against ``ssd_chunked``, which rounds the
    same intra-chunk terms, within 1e-2 x max|ref| (one bf16 rounding).
  * ``apply_mamba`` against the reference's on reduced Mamba2-1.3B: a
    prefill over a ragged and a whole number of chunks, then decode
    steps from its cache; outputs and every cache leaf within 1e-5
    relative. A prompt shorter than the conv window (which the
    reference's decode cannot take) against a longer prefill.
  * the same in bf16, where the two modes cast differently (prefill
    rounds the conv biases and keeps y fp32; decode adds the biases in
    fp32 and rounds y): each output and conv cache bit for bit on at
    least 95% of its elements (98.6-100% seen; the rest are fp32 sums,
    summed in another order, that round to the neighbouring bf16
    value), none more than one bf16 ulp of max|ref| off, and the fp32
    state within one bf16 ulp of max|ref| (its inputs are bf16, so an
    input that rounded the other way moves it by 2^-8 of a term). Each
    of those four casts made the other way leaves only 40-48% of an
    output equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.kernels.ssd_scan.kernel import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref
from repro.models import ssm as JS
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels.ssd_scan.ops import ssd, ssd_reference, ssd_scan
from repro_torch.models import ssm as S
from test_torch_generation import assert_bf16_equal, jax_bf16_reference

torch.set_num_threads(1)
REL = 1e-5


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _inputs(b, s, h, p, n, seed):
    """tests/test_kernels.py's draws, made with numpy: x, B, C ~ N(0, 1),
    dt = softplus(N(0, 1)), a = -exp(0.3 N(0, 1))."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    x, dt, a, bm, cm = f(b, s, h, p), f(b, s, h), f(h), f(b, s, n), f(b, s, n)
    return x, np.log1p(np.exp(dt)), -np.exp(0.3 * a), bm, cm


SWEEP = [(1, 64, 2, 32, 16, 32), (2, 128, 4, 32, 16, 32),
         (1, 256, 2, 64, 32, 64)]
RAGGED = [(2, 77, 3, 32, 16, 32), (1, 13, 4, 64, 128, 128),
          (1, 300, 2, 64, 128, 128), (1, 300, 2, 64, 128, 256)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP + RAGGED)
def test_ssd_matches_jax(b, s, h, p, n, chunk):
    args = _inputs(b, s, h, p, n, seed=s + h)
    targs = [torch.from_numpy(a) for a in args]
    chunk = min(chunk, s)
    y, state = ssd_reference(*targs, chunk=chunk)
    assert y.dtype == torch.float32 and state.shape == (b, h, p, n)
    jargs = [jnp.asarray(a) for a in args]
    _close(y, ssd_ref(*jargs))
    jy, jstate = JS.ssd_chunked(*jargs, chunk=chunk)
    _close(y, jy)
    _close(state, jstate)
    if s % chunk == 0:
        _close(y, jax_ssd_scan(*jargs, chunk=chunk, interpret=True))
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = ssd_scan.launches
    got, got_state = ssd_scan(*targs, chunk=chunk, return_state=True)
    assert ssd_scan.launches == before
    assert torch.equal(got, y) and torch.equal(got_state, state)
    # ssd (the mixer's prefill call) adds D to the same y and state
    d = torch.linspace(0.5, 1.5, h)
    yd, state_d = ssd(*targs, d, chunk=chunk, return_state=True)
    torch.testing.assert_close(yd, y + d[:, None] * targs[0], rtol=0, atol=0)
    assert torch.equal(state_d, state)
    torch.testing.assert_close(ssd(*targs, d, chunk=chunk), yd, rtol=0,
                               atol=0)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 77, 3, 32, 16, 32),
                                             (1, 160, 2, 64, 128, 128),
                                             (1, 300, 2, 64, 128, 256)])
def test_ssd_bf16_matches_ssd_chunked(b, s, h, p, n, chunk):
    x, dt, a, bm, cm = _inputs(b, s, h, p, n, seed=s)
    bf = lambda v: torch.from_numpy(v).bfloat16()  # noqa: E731
    y, state = ssd_reference(bf(x), torch.from_numpy(dt), torch.from_numpy(a),
                             bf(bm), bf(cm), chunk=chunk)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    jb = lambda v: jnp.asarray(v, jnp.bfloat16)  # noqa: E731
    jy, jstate = JS.ssd_chunked(jb(x), jnp.asarray(dt), jnp.asarray(a),
                                jb(bm), jb(cm), chunk=chunk)
    _close(y.float(), np.asarray(jy.astype(jnp.float32)), rel=1e-2)
    _close(state, jstate, rel=1e-5)


def _mamba_params(cfg, seed):
    """numpy weights in the reference's layout (``init_mamba``'s shapes):
    N(0, 0.02) projections, N(0, 0.1) convs and biases, norm and D
    1 + N(0, 0.1), A_log = log U(1, 16)."""
    shapes = jax.eval_shape(lambda k: JS.init_mamba(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    out = {}
    for name, leaf in shapes.items():
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name in ("norm", "D"):
            x = 1 + 0.1 * x
        elif name == "A_log":
            x = np.log(rng.uniform(1, 16, leaf.shape)).astype(np.float32)
        elif name.startswith("conv") or name == "dt_bias":
            x = 0.1 * x
        else:
            x = 0.02 * x
        out[name] = x
    return out


@pytest.mark.parametrize("s", [45, 64])
def test_apply_mamba_prefill_then_decode_match_jax(s):
    jcfg, pcfg = (JARCHS["mamba2-1.3b"].reduced(),
                  ARCHS["mamba2-1.3b"].reduced())
    params = _mamba_params(jcfg, seed=s)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    rng = np.random.default_rng(s)
    xs = rng.standard_normal((2, s + 4, pcfg.d_model)).astype(np.float32)

    jfn = jax.jit(functools.partial(JS.apply_mamba, cfg=jcfg),
                  static_argnames="mode")
    jy, jcache = jfn(jp, jnp.asarray(xs[:, :s]), mode="prefill")
    y, cache = S.apply_mamba(tp, torch.from_numpy(xs[:, :s]), cfg=pcfg,
                             mode="prefill")
    _close(y, jy)
    assert set(cache) == set(jcache) == {"conv_x", "conv_bc", "ssm"}
    for k in cache:
        _close(cache[k], jcache[k])
    assert cache["ssm"].dtype == torch.float32
    for i in range(s, s + 4):                   # decode, cache in place
        jy, jcache = jfn(jp, jnp.asarray(xs[:, i:i + 1]), mode="decode",
                         cache=jcache)
        y, cache2 = S.apply_mamba(tp, torch.from_numpy(xs[:, i:i + 1]),
                                  cfg=pcfg, mode="decode", cache=cache)
        assert cache2 is cache
        _close(y, jy)
        for k in cache:
            _close(cache[k], jcache[k])


@pytest.mark.parametrize("s", [45, 64])
def test_apply_mamba_bf16_prefill_then_decode_match_jax(s):
    jcfg, pcfg = (dataclasses.replace(c["mamba2-1.3b"].reduced(),
                                      dtype="bfloat16")
                  for c in (JARCHS, ARCHS))
    params = _mamba_params(jcfg, seed=s)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tp = {k: v.bfloat16() if v.ndim >= 2 else v for k, v in tp.items()}
    xs = np.random.default_rng(s).standard_normal(
        (2, s + 4, pcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(xs, jnp.bfloat16), torch.from_numpy(xs).bfloat16()
    with jax_bf16_reference():
        jfn = jax.jit(functools.partial(JS.apply_mamba, cfg=jcfg),
                      static_argnames="mode")
        jy, jcache = jfn(jp, jx[:, :s], mode="prefill")
        y, cache = S.apply_mamba(tp, tx[:, :s], cfg=pcfg, mode="prefill")
        assert_bf16_equal(y, jy)
        for i in range(s, s + 5):
            for k in ("conv_x", "conv_bc"):
                assert_bf16_equal(cache[k], jcache[k])
            _close(cache["ssm"], jcache["ssm"], rel=2 ** -7)
            if i == s + 4:
                break
            jy, jcache = jfn(jp, jx[:, i:i + 1], mode="decode", cache=jcache)
            y, cache = S.apply_mamba(tp, tx[:, i:i + 1], cfg=pcfg,
                                     mode="decode", cache=cache)
            assert_bf16_equal(y, jy)


@pytest.mark.parametrize("s", [1, 2, 5])
def test_short_prompt_prefill_then_decode_equals_longer_prefill(s):
    """A prompt shorter than the conv window leaves a zero-padded cache
    (the reference keeps only the prompt's own steps, which its decode
    cannot take); prefill of s tokens then one decode step gives the
    last output and state of a prefill of s + 1 tokens."""
    jcfg, pcfg = (JARCHS["mamba2-1.3b"].reduced(),
                  ARCHS["mamba2-1.3b"].reduced())
    tp = {k: torch.from_numpy(v) for k, v in _mamba_params(jcfg, 3).items()}
    xs = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (2, s + 1, pcfg.d_model)).astype(np.float32))
    _, cache = S.apply_mamba(tp, xs[:, :s], cfg=pcfg, mode="prefill")
    assert cache["conv_x"].shape[1] == pcfg.ssm.d_conv - 1
    y, cache = S.apply_mamba(tp, xs[:, s:], cfg=pcfg, mode="decode",
                             cache=cache)
    ref, ref_cache = S.apply_mamba(tp, xs, cfg=pcfg, mode="prefill")
    _close(y, ref[:, -1:])
    for k in cache:
        _close(cache[k], ref_cache[k])


def test_cache_layout_matches_jax():
    jcfg, pcfg = (JARCHS["mamba2-1.3b"].reduced(),
                  ARCHS["mamba2-1.3b"].reduced())
    ref = JS.init_mamba_cache(jcfg, 3)
    got = S.init_mamba_cache(pcfg, 3)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert got["ssm"].dtype == torch.float32 and not got["conv_x"].any()


def test_ssd_kernel_matches_plain_version_on_card():
    """Both kernel paths: chunks whose B, C and x fit shared memory in
    one pass, longer ones (chunk 256, as SSMCfg's default and Jamba, at
    S = 300 and 600) in sub-tiles; fp32 within 1e-5 and bf16 y within
    1e-2 x max|ref|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    paths = set()
    for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for b, s, h, p, n, chunk in ((8, 13, 64, 64, 128, 13),
                                     (1, 300, 64, 64, 128, 128),
                                     (1, 300, 64, 64, 128, 256),
                                     (1, 600, 64, 64, 128, 256)):
            x, dt, a, bm, cm = (torch.from_numpy(v).cuda()
                                for v in _inputs(b, s, h, p, n, seed=s))
            args = (x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype))
            got, got_state = ssd_scan(*args, chunk=chunk, return_state=True)
            paths.add(ssd_scan.last_path)
            ref, ref_state = ssd_reference(*args, chunk=chunk)
            assert (got.float() - ref.float()).abs().max() <= \
                rel * ref.float().abs().max()
            assert (got_state - ref_state).abs().max() <= \
                1e-5 * ref_state.abs().max()
    assert paths == {"single_pass", "sub_tiled"}


def test_ssd_scan_path_names_a_kernel_path():
    """``path`` takes a name of PATHS or None; the CPU runs the plain
    version whatever it names."""
    from repro_torch.kernels.ssd_scan.ops import PATHS
    args = [torch.from_numpy(v) for v in _inputs(1, 20, 2, 8, 4, seed=3)]
    ref, ref_state = ssd_reference(*args, chunk=8)
    for path in (None, *PATHS):
        got, state = ssd_scan(*args, chunk=8, return_state=True, path=path)
        assert torch.equal(got, ref) and torch.equal(state, ref_state)
    with pytest.raises(ValueError, match="path must be one of"):
        ssd_scan(*args, chunk=8, path="tiled")


def test_ssd_kernel_paths_agree_when_both_fit_on_card():
    """Each path forced at a chunk both can run (128 in bf16, 64 and 128
    in fp32, Mamba2-1.3B's H, P, N): y within 1e-5 (fp32) or 1e-2 (bf16)
    x max|ref| and the state within 1e-5 x max|ref|, as the chosen
    path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.ssd_scan.ops import PATHS
    for dtype, rel, chunk in ((torch.bfloat16, 1e-2, 128),
                              (torch.float32, 1e-5, 64),
                              (torch.float32, 1e-5, 128)):
        x, dt, a, bm, cm = (torch.from_numpy(v).cuda()
                            for v in _inputs(1, 300, 64, 64, 128, seed=chunk))
        args = (x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype))
        ref, ref_state = ssd_reference(*args, chunk=chunk)
        for path in PATHS:
            got, state = ssd_scan(*args, chunk=chunk, return_state=True,
                                  path=path)
            assert ssd_scan.last_path == path
            assert (got.float() - ref.float()).abs().max() <= \
                rel * ref.float().abs().max()
            assert (state - ref_state).abs().max() <= \
                1e-5 * ref_state.abs().max()
