"""The port's `flash_attention` and `flash_decode` against the JAX package,
on the CPU.

CPU tensors run each kernel's plain version; the card's kernels are held
to those in `chip_smoke.py` and `tests/test_torch_cuda.py`.  Here the same
inputs, made with numpy from a seed, go through the Pallas TPU kernels in
interpret mode (as `tests/test_kernels.py` runs them), the references in
`repro.kernels.ref` and the chunked path the models use off the TPU.
Tolerances are `tests/test_kernels.py`'s: 2e-5 for f32, 2e-2 for bf16.
Every reference call is jitted; inputs stay numpy arrays between calls.
"""
import ast
import functools
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_decode import (  # noqa: E402
    decode_splits,
    flash_decode,
    flash_decode_plain,
    lse_combine,
)

TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}


def _jax(a, dtype) -> np.ndarray:
    """A numpy array of the JAX dtype (bfloat16 rounds to nearest even)."""
    return np.asarray(a, np.float32).astype(np.dtype(dtype))


def _ref(fn, *args, **kw):
    """A reference call, jitted with its keywords static."""
    return jax.jit(functools.partial(fn, **kw))(*args)


def _port(x) -> torch.Tensor:
    """A numpy or JAX array as a CPU tensor with the same bits."""
    return convert.model_cache({"x": np.asarray(x)})["x"]


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _qkv(seed, B, H, KVH, Sq, Sk, D, dtype):
    rng = np.random.default_rng(seed)
    q = _jax(rng.standard_normal((B, H, Sq, D)), dtype)
    k = _jax(rng.standard_normal((B, KVH, Sk, D)), dtype)
    v = _jax(rng.standard_normal((B, KVH, Sk, D)), dtype)
    return q, k, v


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,KVH,S,D,causal,window", [
    (2, 4, 2, 256, 64, True, None),
    (1, 8, 8, 128, 128, False, None),
    (2, 4, 1, 256, 64, True, 64),
    (1, 2, 2, 512, 32, True, 128),
])
def test_flash_attention_sweep(B, H, KVH, S, D, causal, window, dtype):
    """The sweep of `test_kernels.py`: the port equals the Pallas kernel,
    the reference and the chunked path."""
    q, k, v = _qkv(S + D, B, H, KVH, S, S, D, dtype)
    got = flash_attention(_port(q), _port(k), _port(v), causal=causal, window=window)
    assert got.dtype == _port(q).dtype and got.shape == q.shape
    tol = TOL[dtype]
    _close(got, _ref(ref.flash_attention_ref, q, k, v, causal=causal, window=window), tol)
    _close(got, _ref(ops.flash_attention, q, k, v, causal=causal, window=window,
                     backend="pallas", block_q=128, block_k=128), tol)
    _close(got, _ref(ops.flash_attention, q, k, v, causal=causal, window=window,
                     backend="chunked", block_k=128), tol)


def test_flash_attention_q_offset():
    """Chunked prefill continuation: q_offset shifts the causal mask."""
    q, k, v = _qkv(7, 1, 2, 2, 64, 128, 32, jnp.float32)
    got = flash_attention(_port(q), _port(k), _port(v), causal=True, q_offset=64)
    _close(got, _ref(ops.flash_attention, q, k, v, causal=True, q_offset=64, backend="pallas",
                     block_q=64, block_k=64), 2e-5)
    _close(got, _ref(ref.flash_attention_ref, q, k, v, causal=True, q_offset=64), 2e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,KVH,Sq,Sk,D,causal,window,q_offset", [
    (2, 4, 2, 48, 48, 16, True, 32, 0),       # the smoke models' prefill, windowed
    (1, 8, 2, 37, 53, 120, True, None, 16),   # ragged, h2o-danube's head dim
    (2, 4, 4, 17, 64, 64, False, None, 0),    # ragged, not causal
    (1, 4, 1, 33, 33, 128, True, 8, 0),       # a window of 8, group 4
    (1, 2, 1, 16, 16, 16, True, None, -8),    # the first 8 rows see no key
])
def test_flash_attention_ragged(B, H, KVH, Sq, Sk, D, causal, window, q_offset, dtype):
    """Shapes the TPU kernel's tiles do not take in blocks of 128: the port
    against the reference and the Pallas kernel run as one tile."""
    q, k, v = _qkv(Sq * Sk + D, B, H, KVH, Sq, Sk, D, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = flash_attention(_port(q), _port(k), _port(v), **kw)
    tol = TOL[dtype]
    _close(got, _ref(ref.flash_attention_ref, q, k, v, **kw), tol)
    _close(got, _ref(ops.flash_attention, q, k, v, backend="pallas", block_q=Sq,
                     block_k=Sk, **kw), tol)
    if q_offset < 0:
        assert not _np(got)[:, :, :-q_offset].any()


def test_flash_attention_takes_strided_views():
    """The model hands over ``[B, S, H, D]`` projections transposed: the
    result equals that of contiguous copies and keeps the view's layout."""
    q, k, v = _qkv(3, 2, 4, 2, 24, 24, 16, jnp.float32)
    tq, tk, tv = (_port(x).transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    got = flash_attention(tq, tk, tv, window=10)
    want = flash_attention(_port(q), _port(k), _port(v), window=10)
    assert torch.equal(got, want)


def test_flash_attention_rejects_bad_operands():
    q = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 3, 8, 16)), torch.zeros((1, 3, 8, 16)))
    with pytest.raises(TypeError):
        flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError):
        flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError):
        flash_attention(torch.zeros((1, 1, 8, 300)), torch.zeros((1, 1, 8, 300)),
                        torch.zeros((1, 1, 8, 300)))


# ---------------------------------------------------------------------------
# the bf16 (wgmma) route: its rounding points, and the wrapper's plan
# ---------------------------------------------------------------------------
def _emulate_wgmma(q, k, v, *, causal, window, q_offset):
    """The bf16 kernel's arithmetic on the CPU, tile by tile of its key
    tile (128 keys; 64 at D > 128): S = q . k of bf16 values summed in f32,
    times scale * log2(e) in f32, masked to -1e30; the running max m and
    sum l in f32 with exp2; p = ok ? exp2(s - m) : 0, rounded to bf16
    before P . V, whose sum is f32; o = acc / where(l > 0, l, 1) in bf16.
    Key tiles start at 0, as the kernel's do: a tile it skips is wholly
    masked, and a wholly masked tile changes neither m, l nor acc."""
    q, k, v = (torch.as_tensor(np.asarray(x, np.float32)) for x in (q, k, v))
    B, H, Sq, D = q.shape
    Sk, group = k.shape[2], H // k.shape[1]
    bk = 64 if D > 128 else 128
    k, v = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    c = torch.tensor(np.float32(1 / np.sqrt(D)) * np.float32(np.log2(np.e)))
    pos = torch.arange(Sq)[:, None] + q_offset
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, D))
    for kt in range(0, Sk, bk):
        keys = torch.arange(kt, min(kt + bk, Sk))[None, :]
        ok = torch.ones((Sq, keys.shape[1]), dtype=torch.bool)
        if causal:
            ok &= keys <= pos
        if window is not None:
            ok &= keys > pos - window
        s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, kt:kt + bk]) * c
        s = torch.where(ok, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s - m_new[..., None]), torch.tensor(0.0))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.bfloat16().float(), v[:, :, kt:kt + bk])
        m = m_new
    return (acc / torch.where(l > 0, l, torch.tensor(1.0))[..., None]).bfloat16()


def _chip_smoke_table(name):
    """A literal table of chip_smoke.py, read without running the script."""
    tree = ast.parse((pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == name)
    return ast.literal_eval(node.value)


@pytest.mark.parametrize("B,H,KVH,Sq,Sk,D,causal,window,q_offset",
                         _chip_smoke_table("ATTN_CASES"))
def test_wgmma_rounding_meets_the_bf16_tolerance(B, H, KVH, Sq, Sk, D, causal, window,
                                                 q_offset):
    """The bf16 kernel's rounding points (P in bf16 before P . V) keep it
    within 2e-2 of the reference and of the Pallas kernel in interpret
    mode (one tile, as the ragged tests run it) on chip_smoke.py's cases."""
    q, k, v = _qkv(Sq * Sk + D, B, H, KVH, Sq, Sk, D, jnp.bfloat16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _emulate_wgmma(q, k, v, **kw)
    _close(got, _ref(ref.flash_attention_ref, q, k, v, **kw), TOL[jnp.bfloat16])
    _close(got, _ref(ops.flash_attention, q, k, v, backend="pallas", block_q=Sq, block_k=Sk,
                     **kw), TOL[jnp.bfloat16])
    if q_offset < 0:
        assert not _np(got)[:, :, :-q_offset].any()


def test_wgmma_plan_of_the_model_views():
    """The model's transposed ``[B, S, heads, D]`` projections at the zoo's
    head dims go to the wgmma route without a copy."""
    for D in (128, 120, 64, 16, 256, 192):
        q = torch.zeros((2, 24, 8, D), dtype=torch.bfloat16).transpose(1, 2)
        k = torch.zeros((2, 24, 2, D), dtype=torch.bfloat16).transpose(1, 2)
        assert fa.plan(q, k, k) == fa.Plan("wgmma", (False, False, False))


def test_wgmma_plan_copies_what_tma_cannot_read():
    """D = 20 (40-byte rows), a base 2 bytes past a 16-byte boundary and a
    non-unit head-dim stride are copied; the aligned copy needs no copy."""
    t = torch.zeros((2, 4, 48, 20), dtype=torch.bfloat16)
    assert fa.plan(t, t, t) == fa.Plan("wgmma", (True, True, True))
    c = fa._aligned_copy(t, "wgmma")
    assert c.shape == t.shape and fa.plan(c, c, c).copy == (False, False, False)
    flat = torch.arange(2 * 4 * 48 * 64 + 1, dtype=torch.float32).bfloat16()
    q = flat[1:].view(2, 4, 48, 64)
    k = torch.zeros((2, 2, 48, 64), dtype=torch.bfloat16)
    assert q.data_ptr() % 16 == 2
    assert fa.plan(q, k, k) == fa.Plan("wgmma", (True, False, False))
    c = fa._aligned_copy(q, "wgmma")
    assert c.data_ptr() % 16 == 0 and torch.equal(c, q)
    odd = torch.zeros((2, 4, 64, 48), dtype=torch.bfloat16).transpose(2, 3)
    assert fa.plan(odd, odd, odd).copy == (True, True, True)


def test_plan_routes_by_dtype():
    """f32 takes the CUDA-core route and copies only a non-unit head-dim
    stride; bf16 takes the wgmma route."""
    t = torch.zeros((1, 2, 16, 20))
    assert fa.plan(t, t, t) == fa.Plan("cuda-core", (False, False, False))
    odd = torch.zeros((1, 2, 20, 16)).transpose(2, 3)
    assert fa.plan(odd, t, t) == fa.Plan("cuda-core", (True, False, False))
    assert fa.plan(t.bfloat16(), t.bfloat16(), t.bfloat16()).route == "wgmma"
    assert fa.ROUTES == {torch.bfloat16: "wgmma", torch.float32: "cuda-core"}


# ---------------------------------------------------------------------------
# flash decode + LSE combine
# ---------------------------------------------------------------------------
def _decode_inputs(seed, B, H, KVH, S, D, dtype, kv_len=None):
    rng = np.random.default_rng(seed)
    q = _jax(rng.standard_normal((B, H, D)), dtype)
    k = _jax(rng.standard_normal((B, S, KVH, D)), dtype)
    v = _jax(rng.standard_normal((B, S, KVH, D)), dtype)
    lens = rng.integers(1, S, B) if kv_len is None else np.asarray(kv_len)
    return q, k, v, lens.astype(np.int32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,KVH,S,D", [(3, 8, 2, 1024, 64), (2, 4, 4, 512, 128),
                                         (1, 16, 2, 2048, 64)])
def test_flash_decode_sweep(B, H, KVH, S, D, dtype):
    """The sweep of `test_kernels.py`, in f32 and bf16."""
    q, k, v, kv_len = _decode_inputs(B * S + D, B, H, KVH, S, D, dtype)
    got = flash_decode(_port(q), _port(k), _port(v), _port(kv_len))
    assert got.dtype == _port(q).dtype and got.shape == q.shape
    tol = TOL[dtype]
    _close(got, _ref(ref.flash_decode_ref, q, k, v, kv_len), tol)
    _close(got, _ref(ops.flash_decode, q, k, v, kv_len, backend="pallas", block_s=256), tol)


@pytest.mark.parametrize("D,S", [(16, 56), (120, 100), (128, 2112)])
def test_flash_decode_return_lse(D, S):
    """The un-normalised partials ``(o, m, l)`` equal the Pallas kernel's
    and, where kv_len > 0, the reference's."""
    q, k, v, kv_len = _decode_inputs(D + S, 2, 8, 2, S, D, jnp.float32)
    got = flash_decode(_port(q), _port(k), _port(v), _port(kv_len), return_lse=True)
    pallas = _ref(ops.flash_decode, q, k, v, kv_len, backend="pallas", block_s=S,
                  return_lse=True)
    want = _ref(ref.flash_decode_ref, q, k, v, kv_len, return_lse=True)
    for g, p, w in zip(got, pallas, want):
        assert g.dtype == torch.float32
        _close(g, p, 2e-5)
        _close(g, w, 2e-5)


def test_flash_decode_kv_len_edges():
    """kv_len 0, 1 and Sk.  An empty row's m is -1e30, as the Pallas
    kernel's (the reference has -inf), and its normalised output is the
    reference's zeros."""
    S = 64
    q, k, v, kv_len = _decode_inputs(11, 3, 8, 2, S, 64, jnp.float32, kv_len=[0, 1, S])
    args = (_port(q), _port(k), _port(v), _port(kv_len))
    o, m, l = flash_decode(*args, return_lse=True)
    po, pm, pl = _ref(ops.flash_decode, q, k, v, kv_len, backend="pallas", block_s=S,
                      return_lse=True)
    _, rm, _ = _ref(ref.flash_decode_ref, q, k, v, kv_len, return_lse=True)
    assert (m[0] == -1e30).all() and (np.asarray(pm)[0] == np.float32(-1e30)).all()
    assert np.isneginf(np.asarray(rm)[0]).all()
    assert not l[0].any() and not o[0].any()
    for g, p in zip((o, m, l), (po, pm, pl)):
        _close(g, p, 2e-5)
    got = flash_decode(*args)
    _close(got, _ref(ref.flash_decode_ref, q, k, v, kv_len), 2e-5)
    _close(got, _ref(ops.flash_decode, q, k, v, kv_len, backend="pallas", block_s=S), 2e-5)
    assert not got[0].any()


def test_lse_combine_over_eight_shards():
    """Partials of 8 cache shards, merged by the port's `lse_combine`, equal
    the whole cache's decode and the reference's merge of the same partials."""
    B, H, KVH, S, D = 2, 8, 2, 1024, 64
    q, k, v, kv_len = _decode_inputs(5, B, H, KVH, S, D, jnp.float32, kv_len=[900, 333])
    per = S // 8
    parts, jparts = [], []
    for s in range(8):
        sl = slice(s * per, (s + 1) * per)
        lens = np.clip(kv_len - s * per, 0, per).astype(np.int32)
        parts.append(flash_decode(_port(q), _port(k[:, sl]), _port(v[:, sl]), _port(lens),
                                  return_lse=True))
        jparts.append(_ref(ops.flash_decode, q, k[:, sl], v[:, sl], lens, backend="pallas",
                           block_s=128, return_lse=True))
    got = lse_combine(parts)
    _close(got, _ref(ref.flash_decode_ref, q, k, v, kv_len), 2e-5)
    _close(got, _ref(ops.lse_combine, jparts), 2e-5)
    _close(got, flash_decode(_port(q), _port(k), _port(v), _port(kv_len)), 2e-5)


def test_lse_combine_of_empty_shards_is_zero():
    B, H, D = 1, 2, 8
    empty = (torch.zeros((B, H, D)), torch.full((B, H), -1e30), torch.zeros((B, H)))
    assert not lse_combine([empty, empty]).any()


@pytest.mark.parametrize("B,KVH,Sk,sms", [(4, 8, 2112, 132), (2, 2, 56, 132), (1, 1, 1, 132),
                                          (64, 8, 4096, 132), (1, 8, 100000, 132)])
def test_decode_splits_cover_the_cache(B, KVH, Sk, sms):
    """The kernel's cut of the cache: whole 64-slot tiles, ranges that cover
    Sk with none empty, and at most two blocks per SM where Sk allows."""
    nsplit, split_len = decode_splits(B, KVH, Sk, sms)
    assert split_len % 64 == 0 and nsplit >= 1
    assert (nsplit - 1) * split_len < Sk <= nsplit * split_len
    assert nsplit == 1 or nsplit * B * KVH >= 2 * sms or split_len == 64


def test_flash_decode_plain_equals_split_partials_merged():
    """The split algebra the kernel uses (ranges merged as `lse_combine`
    does) gives the plain version's one-block partials."""
    q, k, v, kv_len = _decode_inputs(9, 2, 8, 2, 300, 64, jnp.float32, kv_len=[300, 70])
    q, k, v, kv_len = map(_port, (q, k, v, kv_len))
    o, m, l = flash_decode_plain(q, k, v, kv_len)
    parts = []
    for s0 in range(0, 300, 64):
        parts.append(flash_decode_plain(q, k[:, s0:s0 + 64], v[:, s0:s0 + 64],
                                        (kv_len - s0).clamp(0, 64)))
    mx = torch.stack([p[1] for p in parts]).amax(0)
    w = [torch.exp(p[1] - mx) for p in parts]
    torch.testing.assert_close(mx, m)
    torch.testing.assert_close(sum(p[2] * wi for p, wi in zip(parts, w)), l, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(sum(p[0] * wi[..., None] for p, wi in zip(parts, w)), o,
                               atol=2e-5, rtol=2e-5)


def test_flash_decode_rejects_bad_operands():
    q = torch.zeros((2, 4, 16))
    cache = torch.zeros((2, 8, 2, 16))
    with pytest.raises(ValueError):
        flash_decode(q, cache, cache, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        flash_decode(q, cache, cache, torch.zeros(2))
    with pytest.raises(ValueError):
        flash_decode(torch.zeros((1, 34, 16)), torch.zeros((1, 8, 2, 16)),
                     torch.zeros((1, 8, 2, 16)), torch.zeros(1, dtype=torch.int32))
