"""The port's `spray_select` (both entries) against the Pallas kernel and
its oracle, the sender's WAM branch against the reference's, and
`lt_encode`'s route choice.

On the CPU the wrappers run the kernel's plain versions; the CUDA kernels
are held to those plain versions in `test_torch_cuda.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import spray as jspray  # noqa: E402
from repro.core.profile import make_profile as jmake_profile  # noqa: E402
from repro.core.profile import quantize_profile  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.spray_select import spray_select_pallas  # noqa: E402
from repro.net import policies as jpolicies  # noqa: E402
from repro.net import policy_state as jpstate  # noqa: E402
from repro_torch.core.profile import make_profile  # noqa: E402
from repro_torch.core.spray import SprayState  # noqa: E402
from repro_torch.kernels.lt_encode import plan  # noqa: E402
from repro_torch.kernels.spray_select import (  # noqa: E402
    spray_select,
    spray_select_plain,
    spray_select_rows,
    spray_select_rows_plain,
)
from repro_torch.net import policies  # noqa: E402
from repro_torch.net.policy_state import PolicyState  # noqa: E402
from repro_torch.random import M32  # noqa: E402

SWEEP = [(10, 5), (8, 3), (12, 64), (10, 128)]
J_WRAP = 2**32 - 5  # a row base whose 32 lanes wrap past 2**32


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


def _want(counters, c, sa, sb, ell, method):
    """The Pallas kernel in interpret mode (the oracle for COMBINED, which
    the Pallas kernel refuses)."""
    if method == 3:
        return np.asarray(ref.spray_select_ref(counters, c, sa, sb, ell=ell, method=method))
    return np.asarray(spray_select_pallas(jnp.asarray(counters), c, sa, sb, ell=ell,
                                          method=method, interpret=True))


@pytest.mark.parametrize("method", [0, 1, 2, 3])
@pytest.mark.parametrize("ell,n", [(10, 16), (8, 3), (12, 64)])
def test_rows_form_matches_explicit_counters_and_pallas(method, ell, n):
    """The row-base form's plain version (what `spray_select_rows` runs on
    the CPU) equals `spray_select_plain` on the explicit counters
    ``(j + i) mod 2**32`` and the Pallas kernel, with 32 lanes from row
    bases 0, 12,345 and 2**32 - 5 (which wraps)."""
    rng = np.random.default_rng(7 * ell + n + method)
    prof = quantize_profile(rng.random(n) + 0.01, ell)
    sa, sb = int(rng.integers(0, 1 << ell)), int(rng.integers(0, 1 << (ell - 1))) * 2 + 1
    c = torch.as_tensor(np.array(prof.c))[None]
    for j0 in (0, 12345, J_WRAP):
        counters = ((j0 + np.arange(32, dtype=np.int64)) % 2**32).astype(np.uint32)
        got = spray_select_rows(torch.tensor([j0]), c, torch.tensor(sa), torch.tensor(sb), 32,
                                ell=ell, method=method)
        assert got.dtype == torch.int32 and got.shape == (1, 32)
        assert np.array_equal(got[0].numpy(), _want(counters, prof.c, sa, sb, ell, method))
        explicit = spray_select_plain(torch.as_tensor(counters.astype(np.int64))[None], c,
                                      torch.tensor([[sa, sb]]), ell=ell, method=method)
        assert torch.equal(got, explicit)


@pytest.mark.parametrize("j_dtype", [torch.int32, torch.int64], ids=["j-i32", "j-i64"])
@pytest.mark.parametrize("seeds", ["rows-i64", "rows-i32", "scalar-i64", "scalar-i32"])
def test_rows_form_dtypes_and_scalar_seeds(j_dtype, seeds):
    """int32 row bases (uint32 bit patterns) and int64 ones, per-row and
    0-d (stride-0) seeds of either dtype all give the oracle's paths, row
    by row; `spray_select_rows` and its plain version agree."""
    rng = np.random.default_rng(len(seeds) + (j_dtype == torch.int64))
    R, count, n, ell = 5, 40, 8, 10
    cs = [quantize_profile(rng.random(n) + 0.05, ell).c for _ in range(R)]
    c = torch.as_tensor(np.stack([np.asarray(x) for x in cs]))
    j = np.array([0, 2**31 - 7, 2**31 + 3, J_WRAP, 2**32 - 1], dtype=np.int64)
    sa = rng.integers(0, 1 << ell, R)
    sb = rng.integers(0, 1 << (ell - 1), R) * 2 + 1
    if seeds.startswith("scalar"):
        sa, sb = np.full(R, sa[0]), np.full(R, sb[0])
        ta, tb = torch.tensor(int(sa[0])), torch.tensor(int(sb[0]))
    else:
        ta, tb = torch.as_tensor(sa), torch.as_tensor(sb)
    sdt = torch.int32 if seeds.endswith("i32") else torch.int64
    ta, tb = ta.to(sdt), tb.to(sdt)
    tj = torch.as_tensor(np.where(j >= 2**31, j - 2**32, j) if j_dtype == torch.int32 else j,
                         dtype=j_dtype)
    got = spray_select_rows(tj, c, ta, tb, count, ell=ell, method=1)
    assert torch.equal(got, spray_select_rows_plain(tj, c, ta, tb, count, ell=ell, method=1))
    for r in range(R):
        counters = ((j[r] + np.arange(count)) % 2**32).astype(np.uint32)
        want = _want(counters, cs[r], int(sa[r]), int(sb[r]), ell, 1)
        assert np.array_equal(got[r].numpy(), want)


@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_assign_lanes_wam_matches_reference_branch(method):
    """The sender's WAM branch, now one row-base call, gives the paths it
    gave before (explicit counters through `spray_select_plain`) and the
    reference's jitted `wam()` branch, flow by flow, with row bases that
    wrap past 2**32."""
    rng = np.random.default_rng(40 + method)
    F, rate, n, ell = 6, 32, 16, 10
    j0 = np.array([0, 7, 2**31 - 3, J_WRAP, 2**32 - 1, 999_999], dtype=np.int64)
    sa = rng.integers(0, 1 << ell, F)
    sb = rng.integers(0, 1 << (ell - 1), F) * 2 + 1
    b = np.stack([np.bincount(rng.integers(0, n, 1 << ell), minlength=n) for _ in range(F)])
    prof = make_profile(torch.as_tensor(b), ell)
    st = SprayState(j=torch.as_tensor(j0), sa=torch.as_tensor(sa), sb=torch.as_tensor(sb),
                    ell=ell, method=method)
    none = torch.zeros((F, 0))
    ps = PolicyState(rtt=none, penalty=none, entropy=torch.zeros((F, 0), dtype=torch.int64),
                     ccw=none)
    got = policies.assign_lanes(policies.Policy.WAM, rate, n, st, prof, torch.zeros(F), ps, None)
    before = spray_select_plain((st.j.unsqueeze(-1) + torch.arange(rate)) & M32, prof.c,
                                torch.stack([st.sa, st.sb], dim=-1), ell=ell, method=method)
    assert got.dtype == torch.int32 and torch.equal(got, before)
    empty = jnp.zeros((0,), jnp.float32)
    jps = jpstate.PolicyState(rtt=empty, penalty=empty, entropy=jnp.zeros((0,), jnp.uint32),
                              ccw=empty)
    branch = int(jpolicies.Policy.WAM)
    wam = jax.jit(lambda s, p, k: jpolicies.policy_branches(rate, n, s, p, k, jnp.int32(0),
                                                            jps)[branch]())
    with jax.threefry_partitionable(False):
        for f in range(F):
            jprof = jmake_profile(jnp.asarray(b[f], jnp.int32), ell)
            jst = jspray.make_spray_state(jprof, method=jspray.SprayMethod(method),
                                          sa=int(sa[f]), sb=int(sb[f]), j0=int(j0[f]))
            want = wam(jst, jprof, jax.random.PRNGKey(0))
            assert np.array_equal(np.asarray(want), got[f].numpy())


def test_rows_form_rejects_bad_input():
    c = torch.tensor([[4, 8, 16]], dtype=torch.int32)
    j, sa, sb = torch.tensor([3]), torch.tensor(0), torch.tensor(1)
    with pytest.raises(ValueError):  # c must be [R, n]
        spray_select_rows(j, c[0], sa, sb, 8, ell=4, method=1)
    with pytest.raises(ValueError):  # j must be [R] or a scalar
        spray_select_rows(torch.tensor([1, 2]), c, sa, sb, 8, ell=4, method=1)
    with pytest.raises(ValueError):
        spray_select_rows(j, c, sa, sb, 0, ell=4, method=1)
    with pytest.raises(ValueError):
        spray_select_rows(j, c, sa, sb, 8, ell=32, method=1)
    assert spray_select.launches == 0  # CPU tensors never launch the kernel


@pytest.mark.parametrize("case,route", [
    ("aligned, P = 1024", "vector"), ("aligned, P = 4", "vector"), ("offset 16 bytes", "vector"),
    ("offset 4 bytes", "word"), ("P = 1001", "word"), ("P = 6", "word")])
def test_lt_encode_plan_routes_by_alignment(case, route):
    """16-byte loads need whole 16-byte vectors: an aligned payload whose P
    is a multiple of 4 takes the vector route; an offset view off a 16-byte
    boundary, or P % 4 != 0, the word route."""
    flat = torch.zeros(64 * 1024 + 8, dtype=torch.int32)
    payload = {
        "aligned, P = 1024": torch.zeros((8, 1024), dtype=torch.int32),
        "aligned, P = 4": torch.zeros((1, 4), dtype=torch.int32),
        "offset 16 bytes": flat[4:4 + 33 * 512].view(33, 512),
        "offset 4 bytes": flat[1:1 + 33 * 512].view(33, 512),
        "P = 1001": torch.zeros((37, 1001), dtype=torch.int32),
        "P = 6": torch.zeros((300, 6), dtype=torch.int32),
    }[case]
    assert flat.data_ptr() % 16 == 0 and payload.is_contiguous()
    assert plan(payload) == route
