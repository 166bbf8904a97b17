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
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import tma  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_decode import (  # noqa: E402
    decode_splits,
    flash_decode,
    flash_decode_plain,
    lse_combine,
)
from repro_torch.models.transformer import _index, init_stack_cache  # noqa: E402

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
                                          (64, 8, 4096, 132), (1, 8, 100000, 132),
                                          (3, 2, 1024, 7), (2, 8, 300, 1000)])
def test_decode_splits_cover_the_cache(B, KVH, Sk, sms):
    """The kernel's cut of the cache: each (b, kv head)'s Sk slots in whole
    64-slot tiles, the pairs' tiles laid end to end and cut into one range
    per block, covering every tile exactly once, with lengths that differ by
    at most one; a block per SM where there are enough tiles (at the decode
    shape every SM of an H100 streams 8 tiles); the kernel's formula for
    the range that holds a tile (`block_of` in the source) finds it."""
    cut = decode_splits(B, KVH, Sk, sms)
    assert cut.pairs == B * KVH
    assert (cut.tiles_per_pair - 1) * 64 < Sk <= cut.tiles_per_pair * 64
    total = cut.pairs * cut.tiles_per_pair
    ranges = cut.ranges()
    assert len(ranges) == cut.blocks == min(sms, fd.MAX_BLOCKS, total)
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [b - a for a, b in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    for t in range(0, total, max(1, total // 4000)):
        a, b = ranges[((t + 1) * cut.blocks - 1) // total]
        assert a <= t < b
    if (B, KVH, Sk, sms) == (4, 8, 2112, 132):
        assert cut.blocks == 132 and set(sizes) == {8}


def test_decode_plan_reads_the_model_cache_in_place():
    """The model's per-layer slices of its stacked ``[n, B, L, KVH, D]``
    caches are read in place at the zoo's widths (qwen3-8b's head dim of
    128, h2o-danube's 120); a view TMA cannot read is marked for one copy,
    and the padded copy needs none."""
    for arch in ("qwen3-8b", "h2o-danube-3-4b"):
        cfg = get_config(arch)
        cache = init_stack_cache(cfg, 2, 24, "cpu")
        for n in (0, cfg.n_periods - 1):
            layer = _index(cache, n)["sub0"]
            assert fd.plan(layer["k"], layer["v"]) == (False, False)
    k = torch.zeros((2, 24, 4, 64), dtype=torch.bfloat16)
    flat = torch.zeros(k.numel() + 1, dtype=torch.bfloat16)
    off = flat[1:].view(k.shape)  # 2 bytes past a 16-byte boundary
    assert off.data_ptr() % 16 == 2
    assert fd.plan(off, k) == (True, False)
    narrow = torch.zeros((2, 24, 4, 20), dtype=torch.bfloat16)  # 40-byte rows
    assert fd.plan(k, narrow) == (False, True)
    strided = torch.zeros((2, 24, 64, 4), dtype=torch.bfloat16).transpose(2, 3)
    assert fd.plan(strided, strided) == (True, True)
    for t in (off, narrow, strided, torch.zeros((2, 24, 4, 6))):
        c = tma.aligned_copy(t)
        assert torch.equal(c, t) and fd.plan(c, c) == (False, False)
    assert fd.plan(torch.zeros((2, 24, 4, 20)), narrow.float()) == (False, False)


def _merge(states):
    """``(o, m, l)`` states merged in order as `lse_combine` does: M = max m,
    o = sum o exp(m - M), l likewise."""
    mm = torch.stack([m for _, m, _ in states]).amax(0)
    o, l = 0.0, 0.0
    for o_k, m_k, l_k in states:
        w = torch.exp(m_k - mm)
        o = o + o_k * w[..., None]
        l = l + l_k * w
    return o, mm, l


def _emulate_decode(q, k, v, kv_len, *, sms, elem):
    """The kernel's arithmetic on the CPU, for a cache of ``elem``-byte
    values: the cut into block ranges of 64-slot tiles (`decode_splits`); in
    each segment (a block's piece of one (b, kv head) pair) warps that take
    the group's heads kH at a time (4; 2 when a lane holds 8 columns) and the
    tile's slots in equal shares, each running an online softmax over its
    slots in batches of 8: q scaled in f32 first, scores in f32, masked to
    -1e30, exp, p in f32, ``acc * alpha + p . v``; the warps' states merged
    in warp order, then a pair's segments in range order.  Returns the f32
    partials ``(o, m, l)``.  A batch wholly past kv_len changes no state, so
    it is computed here, where the kernel skips it."""
    q, k, v = (torch.as_tensor(np.asarray(x, np.float32)) for x in (q, k, v))
    B, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    box = 128 // elem
    kH = 4 if -(-D // box) * box // 32 <= 4 else 2
    n_hg = 1
    while n_hg * kH < G:
        n_hg *= 2
    n_sg, spw = 8 // n_hg, 8 * n_hg  # warps a head has; slots of a tile a warp takes
    cut = decode_splits(B, KVH, Sk, sms)
    T = cut.tiles_per_pair
    qf = (q * torch.tensor(np.float32(1 / np.sqrt(D)))).reshape(B, KVH, G, D)
    masked = torch.tensor(-1e30)
    segments = {}  # pair -> the segments' (o, m, l), in range order
    for a, b in cut.ranges():
        t = a
        while t < b:
            pair = t // T
            end = min(b, (pair + 1) * T)
            bi, kvh = divmod(pair, KVH)
            n = int(np.clip(kv_len[bi], 0, Sk))
            m = torch.full((G, n_sg), -1e30)  # one state per (head, warp)
            l = torch.zeros((G, n_sg))
            acc = torch.zeros((G, n_sg, D))
            for tile in range(t - pair * T, end - pair * T):
                for r0 in range(0, spw, 8):
                    slots = tile * 64 + torch.arange(n_sg)[:, None] * spw + r0 + torch.arange(8)
                    ok = slots < n
                    kk, vv = (x[bi, slots.clamp(max=Sk - 1), kvh] for x in (k, v))
                    s = torch.where(ok, torch.einsum("gd,wsd->gws", qf[bi, kvh], kk), masked)
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.where(ok, torch.exp(s - m_new[..., None]), torch.tensor(0.0))
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + torch.einsum("gws,wsd->gwd", p, vv)
                    m = m_new
            segments.setdefault(pair, []).append(
                _merge([(acc[:, w], m[:, w], l[:, w]) for w in range(n_sg)]))
            t = end
    o, mo, lo = torch.zeros((B, KVH, G, D)), torch.zeros((B, KVH, G)), torch.zeros((B, KVH, G))
    for pair, parts in segments.items():
        bi, kvh = divmod(pair, KVH)
        o[bi, kvh], mo[bi, kvh], lo[bi, kvh] = _merge(parts)
    return o.reshape(B, H, D), mo.reshape(B, H), lo.reshape(B, H)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,KVH,S,D", [(3, 8, 2, 1024, 64), (2, 4, 4, 512, 128),
                                         (1, 16, 2, 2048, 64), (4, 32, 8, 2112, 128),
                                         (1, 16, 1, 300, 256)])
def test_kernel_arithmetic_meets_the_f32_tolerance(B, H, KVH, S, D, dtype):
    """The Hopper kernel's arithmetic (`_emulate_decode`: its range cut,
    warps, batches and merge order), on `test_flash_decode_sweep`'s shapes,
    the decode shape and a group of 16 at D 256 (2 heads a warp), gives the
    Pallas kernel's and the reference's partials within 2e-5, on the
    H100's 132 SMs and on 7 (ranges of many tiles and pairs)."""
    q, k, v, kv_len = _decode_inputs(B * S + D, B, H, KVH, S, D, dtype)
    pallas = _ref(ops.flash_decode, q, k, v, kv_len, backend="pallas", block_s=S,
                  return_lse=True)
    want = _ref(ref.flash_decode_ref, q, k, v, kv_len, return_lse=True)
    out = _ref(ref.flash_decode_ref, q, k, v, kv_len)
    for sms in (132, 7):
        got = _emulate_decode(q, k, v, kv_len, sms=sms, elem=np.dtype(dtype).itemsize)
        for g, p, w in zip(got, pallas, want):
            _close(g, p, 2e-5)
            _close(g, w, 2e-5)
        _close(fd.normalise(got[0], got[2], _port(q).dtype), out, TOL[dtype])


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
