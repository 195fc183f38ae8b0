"""The port's pending-set compaction (``repro_torch.kernels.cascade_compact``)
against the JAX package's numpy oracle ``compact_ref`` and jnp twin
``_compact_jnp``, bit for bit. (The reference's Pallas leg does not run
on the installed jax, so it is not an oracle here.)"""
import numpy as np
import pytest
import torch

from repro.kernels.cascade_compact.ops import _compact_jnp
from repro.kernels.cascade_compact.ref import compact_ref
from repro_torch.kernels.cascade_compact.ops import compact, compact_reference

torch.set_num_threads(1)


def _port(idx, keep, fill=-1):
    out, cnt = compact(torch.from_numpy(idx.astype(np.int32)),
                       torch.from_numpy(keep), fill=fill)
    assert out.dtype == torch.int32 and cnt.dtype == torch.int32
    assert cnt.ndim == 0
    return out.numpy(), int(cnt)


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33, 200])
@pytest.mark.parametrize("pattern", ["all-accept", "none-accept", "mixed"])
def test_sweep_matches_reference(n, pattern):
    rng = np.random.default_rng(n)
    idx = rng.permutation(n).astype(np.int64) * 5
    accept = {"all-accept": np.ones(n, bool), "none-accept": np.zeros(n, bool),
              "mixed": rng.random(n) < 0.4}[pattern]
    keep = ~accept                                  # rejected rows stay
    ro, rc = compact_ref(idx, keep)
    jo, jc = _compact_jnp(idx.astype(np.int32), keep, -1)
    o, c = _port(idx, keep)
    assert c == rc == int(jc)
    assert np.array_equal(o, ro.astype(np.int32))
    assert np.array_equal(o, np.asarray(jo))


def test_preserves_order_and_padding():
    idx = np.array([40, 10, 30, 20, 50], np.int32)
    keep = np.array([True, False, True, True, False])
    o, c = _port(idx, keep, fill=-7)
    assert c == 3
    assert o.tolist() == [40, 30, 20, -7, -7]
    assert o.tolist() == compact_ref(idx, keep, fill=-7)[0].tolist()


def test_empty_input():
    o, c = _port(np.zeros(0, np.int32), np.zeros(0, bool))
    assert c == 0 and len(o) == 0


def test_validation_errors():
    i4 = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="1-D"):
        compact(i4, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="1-D"):
        compact(i4.reshape(2, 2), torch.ones(2, 2, dtype=torch.bool))
    with pytest.raises(TypeError, match="int32"):
        compact(i4.long(), torch.ones(4, dtype=torch.bool))
    with pytest.raises(TypeError, match="bool"):
        compact(i4, torch.ones(4, dtype=torch.int32))


def test_cpu_call_uses_plain_version_without_counting():
    before = compact.launches
    _port(np.arange(9, dtype=np.int32), np.arange(9) % 2 == 0)
    assert compact.launches == before


def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in (1, 1023, 1024, 1025, 100_000):
        for density in (0.0, 0.01, 0.5, 1.0):
            idx = torch.randperm(n, generator=gen, device="cuda").int()
            keep = torch.rand(n, generator=gen, device="cuda") < density
            out, cnt = compact(idx, keep)
            ref, rcnt = compact_reference(idx, keep)
            assert int(cnt) == int(rcnt) and torch.equal(out, ref)
