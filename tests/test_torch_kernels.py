"""The port's `spray_select` against the Pallas kernel and its oracle.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel is
held to that plain version in `test_torch_cuda.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.profile import quantize_profile  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.spray_select import spray_select_pallas  # noqa: E402
from repro_torch.kernels.spray_select import spray_select  # noqa: E402

SWEEP = [(10, 5), (8, 3), (12, 64), (10, 128)]


def _row(counters, c, sa, sb):
    return (torch.as_tensor(np.asarray(counters).astype(np.int64))[None],
            torch.as_tensor(np.array(c))[None],
            torch.tensor([[sa, sb]], dtype=torch.int64))


@pytest.mark.parametrize("method", [0, 1, 2])
@pytest.mark.parametrize("ell,n", SWEEP)
def test_plain_matches_pallas_sweep(method, ell, n):
    rng = np.random.default_rng(42 + ell * n + method)
    prof = quantize_profile(rng.random(n) + 0.01, ell)
    counters = rng.integers(0, 2**31, 2048, dtype=np.uint32)
    sa, sb = 7 % (1 << ell), 9
    want = np.asarray(spray_select_pallas(jnp.asarray(counters), prof.c, sa, sb, ell=ell,
                                          method=method, interpret=True))
    assert np.array_equal(want, np.asarray(ref.spray_select_ref(
        counters, prof.c, sa, sb, ell=ell, method=method)))
    got = spray_select(*_row(counters, prof.c, sa, sb), ell=ell, method=method)
    assert got.dtype == torch.int32 and np.array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("B", [1, 1000, 1025, 3001])
def test_ragged_batches_match_pallas(B):
    rng = np.random.default_rng(B)
    ell, n = 10, 16
    prof = quantize_profile(np.arange(1, n + 1, dtype=float), ell)
    counters = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(spray_select_pallas(jnp.asarray(counters), prof.c, 300, 77, ell=ell,
                                          method=1, interpret=True))
    got = spray_select(*_row(counters, prof.c, 300, 77), ell=ell, method=1)
    assert np.array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("seed", range(6))
def test_property_cases_match_oracle(seed):
    """Fixed draws over the ranges of test_kernels' property test, for all
    four methods (COMBINED against the oracle; the Pallas kernel refuses it)."""
    rng = np.random.default_rng(seed)
    ell, n, sa = int(rng.integers(4, 13)), int(rng.integers(2, 33)), int(rng.integers(0, 2**16))
    n = min(n, 1 << ell)
    prof = quantize_profile(np.arange(1, n + 1, dtype=float), ell)
    counters = np.arange(1024, dtype=np.uint32)
    for method in range(4):
        want = np.asarray(ref.spray_select_ref(counters, prof.c, sa % (1 << ell), 3,
                                               ell=ell, method=method))
        got = spray_select(*_row(counters, prof.c, sa % (1 << ell), 3), ell=ell, method=method)
        assert np.array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_rows_match_per_row_calls(method):
    rng = np.random.default_rng(method)
    R, B, n, ell = 5, 333, 8, 10
    cs = [quantize_profile(rng.random(n) + 0.05, ell).c for _ in range(R)]
    counters = rng.integers(0, 2**32, (R, B), dtype=np.uint64).astype(np.uint32)
    seeds = np.stack([rng.integers(0, 1 << ell, R), rng.integers(0, 512, R) * 2 + 1], 1)
    got = spray_select(torch.as_tensor(counters.astype(np.int64)),
                       torch.as_tensor(np.stack([np.asarray(c) for c in cs])),
                       torch.as_tensor(seeds), ell=ell, method=method)
    for r in range(R):
        want = np.asarray(ref.spray_select_ref(counters[r], cs[r], int(seeds[r, 0]),
                                               int(seeds[r, 1]), ell=ell, method=method))
        assert np.array_equal(got[r].numpy(), want)
        one = spray_select(*_row(counters[r], cs[r], int(seeds[r, 0]), int(seeds[r, 1])),
                           ell=ell, method=method)
        assert np.array_equal(one[0].numpy(), want)


def test_wrapper_rejects_bad_input():
    cnt, c, seeds = _row(np.arange(8, dtype=np.uint32), np.array([4, 8, 16]), 0, 1)
    with pytest.raises(ValueError):
        spray_select(cnt[0], c, seeds, ell=4, method=1)
    with pytest.raises(ValueError):  # no paths (any n >= 1 is taken)
        spray_select(cnt, torch.zeros((1, 0), dtype=torch.int32), seeds, ell=10, method=1)
    with pytest.raises(ValueError):
        spray_select(cnt, c, seeds, ell=4, method=4)
    assert spray_select.launches == 0  # CPU tensors never launch the kernel
