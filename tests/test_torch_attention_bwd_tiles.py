"""The arithmetic of the bf16 (wgmma) backward kernel of `flash_attention`,
emulated on the CPU, and the backward's `plan`.

``csrc/flash_attention_bwd.cu`` cannot run here, so `_emulate_bwd` repeats
what it computes, tile by tile: the dK / dV launch's blocks of 128 keys,
each walking its kv head's group of query heads and, for each head, the
64-row query tiles of the causal / window band; the dQ launch's blocks of
128 query rows walking the 128-key tiles of their band.  Scores are bf16
products summed in f32; ``P = exp2(s * scale * log2 e - lse * log2 e)``
on visible pairs (0 elsewhere, and for a row that sees no key); ``dS = P
(dP - delta)`` in f32; P and dS are rounded to bf16 before the products
``dV += P^T dO``, ``dK += dS^T Q`` and ``dQ += dS K``, whose sums are f32;
dK and dQ are scaled once at the end and every result is rounded once to
bf16.  The rounding of P and dS is the one the plain version (all f32)
does not make.

The emulation is held to `flash_attention_bwd_plain` on the same inputs at
the card tests' bf16 tolerance (2e-2, tests/test_torch_cuda.py's
``BWD_TOL``) and to ``jax.grad`` of the JAX package's chunked path at
tests/test_torch_attention_grad.py's (2e-2).  The bands it walks are the
kernel's own formulas, so a tile the band wrongly skipped would show as a
difference.  Inputs are made with numpy from a seed; the reference calls
are jitted and computed once per module.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_zoo_reference import one_torch_thread  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

TOL = 2e-2  # bf16: BWD_TOL of the card tests, TOL of the gradient tests
# the kernel's tiles: dK / dV blocks of KV_KEYS keys reading query tiles of
# KV_ROWS rows; dQ blocks of Q_ROWS rows reading key tiles of Q_KEYS keys
KV_KEYS, KV_ROWS, Q_ROWS, Q_KEYS = 128, 64, 128, 128
LOG2E = np.float32(np.log2(np.e))
# (B, H, KVH, Sq, Sk, D, causal, window, q_offset): rows that see no key
# (q_offset < 0), windows, Sq and Sk off the tile sizes, groups 1, 4 and 7,
# D 20, 64 and 128, and one head at the train shape's summation length
CASES = [
    (1, 2, 1, 16, 16, 16, True, None, -8),
    (1, 4, 2, 16, 16, 24, True, 4, -6),
    (2, 4, 1, 200, 200, 64, True, 48, 0),
    (1, 7, 1, 150, 150, 20, True, None, 0),
    (1, 4, 4, 130, 260, 128, False, None, 0),
    (1, 8, 2, 37, 300, 128, True, None, 263),
    (1, 4, 1, 300, 300, 128, True, 70, -40),
    (1, 1, 1, 2048, 2048, 128, True, None, 0),
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread a worker (`one_torch_thread`)."""
    with one_torch_thread():
        yield


def _port(x) -> torch.Tensor:
    return convert.model_cache({"x": np.asarray(x)})["x"]


def _kw(case):
    return dict(causal=case[6], window=case[7], q_offset=case[8])


def _kv_band(k0, Sq, Sk, causal, window, q_offset):
    """The query rows [begin, end) a dK / dV block of keys from k0 walks:
    begin rounded down to a query tile."""
    k_hi = min(k0 + KV_KEYS, Sk) - 1
    begin, end = 0, Sq
    if causal:
        begin = max(0, k0 - q_offset)
    if window is not None:
        end = min(Sq, max(0, k_hi + window - q_offset))
    return begin // KV_ROWS * KV_ROWS, end


def _q_band(q0, Sq, Sk, causal, window, q_offset):
    """The keys [begin, end) a dQ block of rows from q0 walks: begin
    rounded down to a key tile."""
    lo, hi = q0 + q_offset, min(q0 + Q_ROWS, Sq) - 1 + q_offset
    begin, end = 0, Sk
    if causal:
        end = min(Sk, max(hi + 1, 0))
    if window is not None:
        begin = max(0, lo - window + 1)
    return begin // Q_KEYS * Q_KEYS, end


def _visible(rows, keys, Sq, Sk, causal, window, q_offset):
    qp = rows[:, None] + q_offset
    ok = (rows[:, None] < Sq) & (keys[None, :] < Sk)
    if causal:
        ok &= keys[None, :] <= qp
    if window is not None:
        ok &= keys[None, :] > qp - window
    return ok


def _bf16(t):
    return t.bfloat16().float()


def _emulate_bwd(q, k, v, o, lse, do, *, causal, window, q_offset):
    """(dq, dk, dv) in bf16 as the kernel computes them (module docstring)
    from bf16 CPU tensors; ``lse`` f32."""
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    group = H // KVH
    scale = np.float32(1 / np.sqrt(D))
    c = torch.tensor(scale * LOG2E)
    # the delta launch: rowsum(dO o) in f32, lse in the exp2 domain (+inf
    # for a row that sees no key, whose P is then 0)
    delta = (do * o).sum(-1)
    lse2 = torch.where(torch.isinf(lse), torch.tensor(np.inf), lse * torch.tensor(LOG2E))
    band = dict(causal=causal, window=window, q_offset=q_offset)

    def p_ds(rows, keys, s, dp, h):
        """P and dS of [B, rows, keys] from the scores s and dP."""
        ok = _visible(rows, keys, Sq, Sk, **band)
        rows = rows.clamp(max=Sq - 1)
        p = torch.where(ok, torch.exp2(s * c - lse2[:, h, rows, None]), torch.tensor(0.0))
        return p, p * (dp - delta[:, h, rows, None])

    dk = torch.zeros((B, KVH, Sk, D))
    dv = torch.zeros((B, KVH, Sk, D))
    for kvh in range(KVH):
        for k0 in range(0, Sk, KV_KEYS):
            keys = torch.arange(k0, min(k0 + KV_KEYS, Sk))
            kk, vv = k[:, kvh, keys], v[:, kvh, keys]
            begin, end = _kv_band(k0, Sq, Sk, **band)
            for h in range(kvh * group, (kvh + 1) * group):
                for q0 in range(begin, end, KV_ROWS):
                    rows = torch.arange(q0, min(q0 + KV_ROWS, Sq))
                    qq, dd = q[:, h, rows], do[:, h, rows]
                    p, ds = p_ds(rows, keys, qq @ kk.mT, dd @ vv.mT, h)
                    dv[:, kvh, keys] += _bf16(p).mT @ dd
                    dk[:, kvh, keys] += _bf16(ds).mT @ qq
    dq = torch.zeros((B, H, Sq, D))
    for h in range(H):
        kvh = h // group
        for q0 in range(0, Sq, Q_ROWS):
            rows = torch.arange(q0, min(q0 + Q_ROWS, Sq))
            qq, dd = q[:, h, rows], do[:, h, rows]
            begin, end = _q_band(q0, Sq, Sk, **band)
            for k0 in range(begin, end, Q_KEYS):
                keys = torch.arange(k0, min(k0 + Q_KEYS, Sk))
                kk, vv = k[:, kvh, keys], v[:, kvh, keys]
                _, ds = p_ds(rows, keys, qq @ kk.mT, dd @ vv.mT, h)
                dq[:, h, rows] += _bf16(ds) @ kk
    sc = torch.tensor(scale)
    return (dq * sc).bfloat16(), (dk * sc).bfloat16(), dv.bfloat16()


def _inputs(case):
    B, H, KVH, Sq, Sk, D = case[:6]
    rng = np.random.default_rng(sum(case[:6]) + case[8] + 29)
    return [rng.standard_normal(shape).astype(np.float32).astype(jnp.bfloat16)
            for shape in ((B, H, Sq, D), (B, KVH, Sk, D), (B, KVH, Sk, D), (B, H, Sq, D))]


@functools.lru_cache(maxsize=None)
def _reference_vjp(kw_items):
    kw = dict(kw_items)

    def vjp(q, k, v, do):
        _, pull = jax.vjp(lambda a, b, c: ops.flash_attention(a, b, c, backend="chunked",
                                                              **kw), q, k, v)
        return pull(do)

    return jax.jit(vjp)


@pytest.fixture(scope="module")
def computed():
    """Per case: the emulated kernel, the plain backward and the reference
    gradient, on the port's forward (o, lse)."""
    out = {}
    for case in CASES:
        q, k, v, do = _inputs(case)
        kw = _kw(case)
        with jax.threefry_partitionable(False):
            ref = [np.asarray(x, np.float32) for x in
                   _reference_vjp(tuple(kw.items()))(q, k, v, do)]
        tq, tk, tv, tdo = map(_port, (q, k, v, do))
        o, lse = fa.flash_attention_with_lse(tq, tk, tv, **kw)
        out[case] = dict(emulated=_emulate_bwd(tq, tk, tv, o, lse, tdo, **kw),
                         plain=fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, **kw),
                         reference=ref, lse=lse)
    return out


def _close(got, want, what):
    np.testing.assert_allclose(got.float().numpy() if torch.is_tensor(got) else got,
                               want.float().numpy() if torch.is_tensor(want) else want,
                               atol=TOL, rtol=TOL, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_kernel_matches_plain(computed, case):
    """The kernel's rounding of P and dS to bf16 keeps dq, dk and dv within
    the card tests' bf16 tolerance of `flash_attention_bwd_plain`."""
    for name, got, want in zip(("dq", "dk", "dv"), computed[case]["emulated"],
                               computed[case]["plain"]):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape, name
        _close(got, want, f"{name} {case}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_kernel_matches_reference_chunked_path(computed, case):
    """The emulated kernel against ``jax.grad`` of the JAX package's chunked
    path, at the gradient tests' bf16 tolerance."""
    for name, got, want in zip(("dq", "dk", "dv"), computed[case]["emulated"],
                               computed[case]["reference"]):
        _close(got, want, f"{name} {case}")


def test_rows_that_see_no_key_get_zero_gradients(computed):
    """lse = -inf rows (q_offset < 0) come out as exact zeros of dq, and
    keys that no row sees as exact zeros of dk and dv, with no NaN."""
    checked = 0
    for case in CASES:
        B, H, KVH, Sq, Sk, D, causal, window, q_offset = case
        dq, dk, dv = computed[case]["emulated"]
        assert all(bool(torch.isfinite(t.float()).all()) for t in (dq, dk, dv)), case
        empty = torch.isinf(computed[case]["lse"])
        if empty.any():
            assert not dq[empty].any(), case
            checked += 1
        seen = _visible(torch.arange(Sq), torch.arange(Sk), Sq, Sk, causal, window,
                        q_offset).any(0)
        assert not dk[:, :, ~seen].any() and not dv[:, :, ~seen].any(), case
    assert checked >= 2


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 1), (True, 37),
                                           (False, 90)])
def test_bands_cover_every_visible_pair(causal, window):
    """The tiles both launches walk hold every visible (query, key) pair,
    over Sq, Sk and q_offset off the tile sizes (a pair outside the bands
    would be a gradient the kernel never adds)."""
    rng = np.random.default_rng(int(causal) * 1000 + (window or 0))
    for _ in range(40):
        Sq, Sk = (int(x) for x in rng.integers(1, 400, 2))
        q_offset = int(rng.integers(-Sq, Sk + 1))
        band = dict(causal=causal, window=window, q_offset=q_offset)
        ok = _visible(torch.arange(Sq), torch.arange(Sk), Sq, Sk, **band).numpy()
        walked_kv = np.zeros_like(ok)
        for k0 in range(0, Sk, KV_KEYS):
            begin, end = _kv_band(k0, Sq, Sk, **band)
            walked_kv[begin:max(begin, end), k0:k0 + KV_KEYS] = True
        walked_q = np.zeros_like(ok)
        for q0 in range(0, Sq, Q_ROWS):
            begin, end = _q_band(q0, Sq, Sk, **band)
            walked_q[q0:q0 + Q_ROWS, begin:max(begin, end)] = True
        assert not (ok & ~walked_kv).any() and not (ok & ~walked_q).any(), (Sq, Sk, band)


# ---------------------------------------------------------------------------
# the backward's plan: route by dtype and head dim, and the operands to copy
# ---------------------------------------------------------------------------
def _model_views(D, S=24, B=2, H=8, KVH=2, dtype=torch.bfloat16):
    """q, k, v, o and do as the training step hands them over: transposed
    views of [B, S, heads, D] projections, o and do laid out alike."""
    q, o, do = (torch.zeros((B, S, H, D), dtype=dtype).transpose(1, 2) for _ in range(3))
    k, v = (torch.zeros((B, S, KVH, D), dtype=dtype).transpose(1, 2) for _ in range(2))
    return q, k, v, o, do


@pytest.mark.parametrize("D", [128, 64, 120, 16])
def test_bwd_plan_of_the_model_views(D):
    """The model's views at the zoo's head dims up to 128 take the wgmma
    route and are read in place: no copy of q, k, v, o or do."""
    assert fa.bwd_plan(*_model_views(D)) == fa.Plan("wgmma", (False,) * 5)


def test_bwd_plan_routes_by_dtype_and_head_dim():
    """f32 takes the CUDA-core kernel at every head dim, and so does bf16
    above a head dim of 128 (two 64 x D f32 accumulators a thread do not
    fit in its registers); bf16 up to 128 takes the wgmma kernel."""
    assert fa.BWD_MAX_WGMMA_HEAD_DIM == 128
    for D, route in ((128, "wgmma"), (8, "wgmma"), (136, "cuda-core"), (256, "cuda-core")):
        assert fa.bwd_plan(*_model_views(D)).route == route, D
    for D in (16, 128, 256):
        assert fa.bwd_plan(*_model_views(D, dtype=torch.float32)) == fa.Plan("cuda-core",
                                                                           (False,) * 5)
    assert fa.BWD_SOURCES == {"wgmma": "flash_attention_bwd",
                              "cuda-core": "flash_attention_bwd_f32"}


def test_bwd_plan_copies_what_tma_cannot_read():
    """On the wgmma route q, k, v and do at D = 20 (40-byte rows), a base 2
    bytes past a 16-byte boundary and a non-unit head-dim stride are
    copied, o only for a non-unit head-dim stride; the CUDA-core route
    copies only a non-unit head-dim stride."""
    t = torch.zeros((1, 14, 33, 20), dtype=torch.bfloat16)
    kv = torch.zeros((1, 2, 33, 20), dtype=torch.bfloat16)
    assert fa.bwd_plan(t, kv, kv, t, t) == fa.Plan("wgmma", (True, True, True, False, True))
    flat = torch.zeros(2 * 4 * 48 * 64 + 1, dtype=torch.bfloat16)
    q = flat[1:].view(2, 4, 48, 64)
    k = torch.zeros((2, 2, 48, 64), dtype=torch.bfloat16)
    assert q.data_ptr() % 16 == 2
    assert fa.bwd_plan(q, k, k, q, q).copy == (True, False, False, False, True)
    odd = torch.zeros((2, 4, 64, 48), dtype=torch.bfloat16).transpose(2, 3)
    odd_k = torch.zeros((2, 2, 64, 48), dtype=torch.bfloat16).transpose(2, 3)
    assert fa.bwd_plan(odd, odd_k, odd_k, odd, odd).copy == (True,) * 5
    c = fa._aligned_copy(t, "wgmma")
    assert fa.bwd_plan(c, c[:, :2], c[:, :2], t, c).copy == (False,) * 5
    wide = torch.zeros((1, 2, 16, 200), dtype=torch.bfloat16)
    wide_k = torch.zeros((1, 1, 200, 16), dtype=torch.bfloat16).transpose(2, 3)
    assert fa.bwd_plan(wide, wide_k, wide_k, wide, wide) == fa.Plan(
        "cuda-core", (False, True, True, False, False))
