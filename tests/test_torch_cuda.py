"""Tests that need an NVIDIA card: each CUDA kernel against its plain
version on the card.  They skip where CUDA is absent.  This file imports no
JAX, so it runs on a machine that has only the port's requirements:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.spray_select import spray_select, spray_select_plain  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R,B,n", [(1, 131072, 16), (4096, 32, 16), (3, 1001, 128), (2, 5, 1),
                                   (3, 1001, 129), (2, 300, 256), (2, 300, 1000),
                                   (1, 300, 20000)])
def test_spray_select_kernel_matches_plain(cuda, R, B, n):
    rng = np.random.default_rng(R * B + n)
    for method in range(4):
        for ell in (8, 10, 16):
            b = np.stack([np.bincount(rng.integers(0, n, 1 << ell), minlength=n)
                          for _ in range(R)])
            c = torch.as_tensor(np.cumsum(b, 1).astype(np.int32), device=cuda)
            cnt = torch.as_tensor(rng.integers(0, 2**32, (R, B)), device=cuda)
            seeds = torch.as_tensor(np.stack([rng.integers(0, 1 << ell, R),
                                              rng.integers(0, 1 << (ell - 1), R) * 2 + 1], 1),
                                    device=cuda)
            before = spray_select.launches
            got = spray_select(cnt, c, seeds, ell=ell, method=method)
            assert spray_select.launches == before + 1
            assert torch.equal(got, spray_select_plain(cnt, c, seeds, ell=ell, method=method))


@pytest.mark.cuda
def test_spray_select_rejects_mixed_devices(cuda):
    cnt = torch.zeros((1, 4), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        spray_select(cnt, torch.tensor([[4]], dtype=torch.int32),
                     torch.tensor([[0, 1]], device=cuda), ell=2, method=1)


@pytest.mark.cuda
@pytest.mark.parametrize("K,P,R,dmax", [(64, 512, 16, 8), (128, 1024, 32, 16), (16, 512, 8, 4),
                                        (37, 1001, 13, 5), (5, 3, 7, 40), (1, 1, 1, 1),
                                        (300, 6, 11, 300), (2048, 1024, 3001, 32)])
def test_lt_encode_kernel_matches_plain(cuda, K, P, R, dmax):
    """Exact equality on ragged shapes, with negative and out-of-range
    indices on valid slots; one launch per call."""
    from repro_torch.kernels.lt_encode import lt_encode, lt_encode_plain

    rng = np.random.default_rng(K + P + R + dmax)
    payload = torch.as_tensor(rng.integers(-2**31, 2**31, (K, P)).astype(np.int32), device=cuda)
    neigh = torch.as_tensor(rng.integers(-2 * K - 3, 2 * K + 3, (R, dmax)).astype(np.int32),
                            device=cuda)
    valid = torch.as_tensor(rng.random((R, dmax)) < 0.7, device=cuda)
    before = lt_encode.launches
    got = lt_encode(payload, neigh, valid)
    assert lt_encode.launches == before + 1
    assert torch.equal(got, lt_encode_plain(payload, neigh, valid))
    assert torch.equal(lt_encode(payload, neigh.to(torch.int64), valid.to(torch.uint8)), got)


@pytest.mark.cuda
def test_lt_encode_kernel_unaligned_payload(cuda):
    """A payload that starts 4 bytes past a 16-byte boundary takes the
    kernel's word-wise path and gives the same words."""
    from repro_torch.kernels.lt_encode import lt_encode, lt_encode_plain

    rng = np.random.default_rng(5)
    K, P, R = 33, 512, 19
    flat = torch.as_tensor(rng.integers(-2**31, 2**31, K * P + 1).astype(np.int32), device=cuda)
    payload = flat[1:].view(K, P)
    assert payload.data_ptr() % 16 != 0
    neigh = torch.as_tensor(rng.integers(0, K, (R, 6)).astype(np.int32), device=cuda)
    valid = torch.ones((R, 6), dtype=torch.bool, device=cuda)
    assert torch.equal(lt_encode(payload, neigh, valid), lt_encode_plain(payload, neigh, valid))


def _rows_case(rng, R, n, ell, cuda, *, j_dtype, seed_dtype, scalar_seeds):
    b = np.stack([np.bincount(rng.integers(0, n, 1 << ell), minlength=n) for _ in range(R)])
    c = torch.as_tensor(np.cumsum(b, 1).astype(np.int32), device=cuda)
    j = rng.integers(2**32 - 40, 2**32, R)  # every row's lanes wrap past 2**32
    if j_dtype == torch.int32:
        j = np.where(j >= 2**31, j - 2**32, j)
    j = torch.as_tensor(j, dtype=j_dtype, device=cuda)
    sa = rng.integers(0, 1 << ell, R)
    sb = rng.integers(0, 1 << (ell - 1), R) * 2 + 1
    if scalar_seeds:  # 0-d seeds: the kernel reads them with a stride of 0
        sa, sb = sa[0], sb[0]
    return (j, c, torch.as_tensor(sa, dtype=seed_dtype, device=cuda),
            torch.as_tensor(sb, dtype=seed_dtype, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("R,B,n", [(4096, 32, 16), (1, 4096, 64), (3, 1001, 1), (2, 700, 20000)])
@pytest.mark.parametrize("dtypes", [(torch.int64, torch.int64, False),
                                    (torch.int32, torch.int32, False),
                                    (torch.int64, torch.int32, True)],
                         ids=["i64", "i32", "i64-scalar-i32-seeds"])
def test_spray_select_rows_kernel_matches_plain(cuda, R, B, n, dtypes):
    """The row-base form on the card equals its plain version for every
    method, with counters that wrap past 2**32, int32 and int64 inputs and
    scalar (stride-0) seeds; one launch a call."""
    from repro_torch.kernels.spray_select import spray_select_rows, spray_select_rows_plain

    rng = np.random.default_rng(R + B + n)
    j_dtype, seed_dtype, scalar = dtypes
    for method in range(4):
        for ell in (8, 10, 16):
            j, c, sa, sb = _rows_case(rng, R, n, ell, cuda, j_dtype=j_dtype,
                                      seed_dtype=seed_dtype, scalar_seeds=scalar)
            before = spray_select.launches
            got = spray_select_rows(j, c, sa, sb, B, ell=ell, method=method)
            assert spray_select.launches == before + 1
            want = spray_select_rows_plain(j, c, sa, sb, B, ell=ell, method=method)
            assert torch.equal(got, want)


def _device_ops(fn, calls):
    """The device operations that ``calls`` calls of ``fn`` run, by name
    (None when the profiler records no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
    return device or None


@pytest.mark.cuda
def test_spray_select_is_one_kernel_a_call(cuda):
    """The sender's WAM branch (4,096 flows of int64 counters and seeds, 32
    lanes, 16 paths) and `spray_paths` (one row of 4,096, 64 paths) are each
    one device kernel a call and nothing else."""
    from repro_torch.core.profile import make_profile, quantize_profile
    from repro_torch.core.spray import SprayState, make_spray_state, spray_paths
    from repro_torch.net.policies import Policy, assign_lanes
    from repro_torch.net.policy_state import PolicyState

    F, rate, n, ell = 4096, 32, 16, 10
    rng = np.random.default_rng(11)
    b = torch.as_tensor(np.stack([np.bincount(rng.integers(0, n, 1 << ell), minlength=n)
                                  for _ in range(F)]), device=cuda)
    prof = make_profile(b, ell)
    spray = SprayState(j=torch.as_tensor(rng.integers(0, 2**32, F), device=cuda),
                       sa=torch.as_tensor(rng.integers(0, 1 << ell, F), device=cuda),
                       sb=torch.as_tensor(rng.integers(0, 512, F) * 2 + 1, device=cuda),
                       ell=ell, method=1)
    none = torch.zeros((F, 0), device=cuda)
    ps = PolicyState(rtt=none, penalty=none, entropy=torch.zeros((F, 0), dtype=torch.int64,
                                                                 device=cuda), ccw=none)
    ecmp = torch.zeros(F, dtype=torch.int64, device=cuda)
    wam = _device_ops(lambda: assign_lanes(Policy.WAM, rate, n, spray, prof, ecmp, ps, None), 3)
    one = quantize_profile(0.5 + rng.random(64), ell, device=cuda)
    state = make_spray_state(one, sa=300, sb=77, j0=2**32 - 100)
    paths = _device_ops(lambda: spray_paths(state, one, 4096), 3)
    if wam is None or paths is None:
        pytest.skip("the profiler recorded no device activity here")
    for names in (wam, paths):
        assert len(names) == 3 and all("spray_select" in x for x in names), names


@pytest.mark.cuda
def test_spray_select_and_lt_encode_graph_replays_are_identical(cuda):
    """Three replays of a captured call of each kernel (the row-base spray
    at the wide tick's shape, lt_encode's vector route) give the eager
    call's bits."""
    from repro_torch.kernels.lt_encode import lt_encode, plan
    from repro_torch.kernels.spray_select import spray_select_rows

    rng = np.random.default_rng(12)
    j, c, sa, sb = _rows_case(rng, 4096, 16, 10, cuda, j_dtype=torch.int64,
                              seed_dtype=torch.int64, scalar_seeds=False)
    K, P, R, dmax = 2048, 1024, 3001, 32
    payload = torch.as_tensor(rng.integers(-2**31, 2**31, (K, P)).astype(np.int32), device=cuda)
    neigh = torch.as_tensor(rng.integers(0, K, (R, dmax)).astype(np.int32), device=cuda)
    valid = torch.as_tensor(rng.random((R, dmax)) < 0.2, device=cuda)
    assert plan(payload) == "vector"
    calls = [lambda: spray_select_rows(j, c, sa, sb, 32, ell=10, method=3),
             lambda: lt_encode(payload, neigh, valid)]
    for fn in calls:
        eager = fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("K,P,R,dmax", [(64, 1024, 40, 200), (300, 3000, 50, 60), (1, 4, 9, 3),
                                        (8192, 1024, 13139, 32)],
                         ids=["degree-200", "three-tiles", "K1", "coded-shape"])
def test_lt_encode_vector_route_matches_plain(cuda, K, P, R, dmax):
    """The vector route equals the plain version: rows of degree up to 200
    (many rounds of gathers, and a row with no valid slot), rows of three
    column tiles with a ragged last (3,000 words), a one-row payload, and
    the coded cell's shape with its own encoding
    (`fountain.sample_encoding`, seed 0)."""
    from repro_torch.kernels.lt_encode import lt_encode, lt_encode_plain, plan
    from repro_torch.net import fountain

    rng = np.random.default_rng(K + P)
    payload = torch.as_tensor(rng.integers(-2**31, 2**31, (K, P)).astype(np.int32), device=cuda)
    if (K, R) == (8192, 13139):
        nb, ok = fountain.sample_encoding(K, R, np.random.default_rng(0), dmax=dmax)
        neigh, valid = torch.as_tensor(nb, device=cuda), torch.as_tensor(ok, device=cuda)
    else:
        neigh = torch.as_tensor(rng.integers(-2 * K - 3, 2 * K + 3, (R, dmax)).astype(np.int32),
                                device=cuda)
        valid = torch.as_tensor(rng.random((R, dmax)) < 0.9, device=cuda)
        valid[0] = False  # a row with no valid slot encodes to zeros
    assert plan(payload) == "vector"
    got = lt_encode(payload, neigh, valid)
    assert torch.equal(got, lt_encode_plain(payload, neigh, valid))
    if (K, R) != (8192, 13139):
        assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,Sq,Sk,D,causal,window,q_offset", [
    (2, 4, 2, 256, 256, 64, True, None, 0), (1, 8, 8, 128, 128, 128, False, None, 0),
    (2, 4, 1, 256, 256, 64, True, 64, 0), (1, 2, 2, 512, 512, 32, True, 128, 0),
    (1, 2, 2, 64, 128, 32, True, None, 64), (1, 8, 2, 37, 53, 120, True, None, 16),
    (2, 4, 2, 48, 48, 16, True, 32, 0), (1, 2, 1, 16, 16, 16, True, None, -8),
    (1, 2, 1, 70, 70, 256, True, 20, 0), (2, 4, 2, 48, 48, 20, True, None, 0),
    (1, 4, 2, 200, 333, 128, True, None, 133), (1, 2, 1, 100, 1000, 256, False, None, 0)])
def test_flash_attention_kernel_matches_plain(cuda, B, H, KVH, Sq, Sk, D, causal, window,
                                              q_offset, dtype):
    """The kernel against its plain version, at test_kernels.py's
    tolerances (2e-5 f32, 2e-2 bf16); one launch per call.  bf16 takes the
    wgmma route (D = 20 through the aligning copy; key counts that are not
    a multiple of the key tile), f32 the CUDA-core route."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=cuda).manual_seed(Sq * Sk + D)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((B, H, Sq, D), (B, KVH, Sk, D), (B, KVH, Sk, D)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), flash_attention_plain(q, k, v, **kw).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,Sk,D", [(3, 8, 2, 1024, 64), (2, 4, 4, 512, 128),
                                          (1, 16, 2, 2048, 64), (4, 32, 8, 2112, 128),
                                          (2, 4, 2, 56, 16), (2, 32, 8, 100, 120),
                                          (1, 16, 1, 300, 256), (2, 8, 2, 100, 120),
                                          (3, 8, 2, 64, 64), (2, 32, 8, 4096, 128)])
def test_flash_decode_kernel_matches_plain(cuda, B, H, KVH, Sk, D, dtype):
    """(o, m, l) against the plain version at 2e-5, with kv_len 0, 1 and Sk
    among the rows, and the normalised output within test_kernels.py's
    tolerance and bit-equal to `normalise` of the partials; one launch per
    call."""
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain, normalise

    g = torch.Generator(device=cuda).manual_seed(Sk + D)
    q = torch.randn((B, H, D), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((B, Sk, KVH, D), generator=g, device=cuda).to(dtype) for _ in range(2))
    kv_len = torch.randint(1, Sk + 1, (B,), generator=g, device=cuda, dtype=torch.int32)
    kv_len[0] = 0
    if B > 1:
        kv_len[1] = Sk
    if B > 2:
        kv_len[2] = 1
    before = flash_decode.launches
    got = flash_decode(q, k, v, kv_len, return_lse=True)
    assert flash_decode.launches == before + 1
    plain = flash_decode_plain(q, k, v, kv_len)
    for a, b in zip(got, plain):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
    assert (got[1][0] == -1e30).all() and not got[2][0].any() and not got[0][0].any()
    out = flash_decode(q, k, v, kv_len)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), normalise(plain[0], plain[2], dtype).float(),
                               atol=tol, rtol=tol)
    assert torch.equal(out, normalise(got[0], got[2], dtype))


def _decode_case(g, B, H, KVH, Sk, D, dtype, dev):
    q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((B, Sk, KVH, D), generator=g, device=dev).to(dtype) for _ in range(2))
    return q, k, v


@pytest.mark.cuda
def test_flash_decode_clamps_an_int64_kv_len(cuda):
    """kv_len as int64, below 0 and above Sk: the kernel clamps it to
    [0, Sk] itself; a row below 0 is empty."""
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain

    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = _decode_case(g, 4, 8, 2, 300, 64, torch.bfloat16, cuda)
    kv_len = torch.tensor([-5, 400, 2**40, 77], dtype=torch.int64, device=cuda)
    got = flash_decode(q, k, v, kv_len, return_lse=True)
    for a, b in zip(got, flash_decode_plain(q, k, v, kv_len.clamp(0, 300))):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
    assert (got[1][0] == -1e30).all() and not got[2][0].any()


@pytest.mark.cuda
def test_flash_decode_reads_the_model_cache_in_place(cuda):
    """A layer's slice of a stacked [n, B, L, KVH, D] cache is read with no
    copy; a view 2 bytes past a 16-byte boundary is copied once, counted."""
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain

    g = torch.Generator(device=cuda).manual_seed(7)
    cache = torch.randn((3, 4, 200, 8, 128), generator=g, device=cuda).bfloat16()
    q = torch.randn((4, 32, 128), generator=g, device=cuda).bfloat16()
    kv_len = torch.tensor([200, 3, 150, 64], dtype=torch.int32, device=cuda)
    before = flash_decode.copies
    got = flash_decode(q, cache[1], cache[2], kv_len, return_lse=True)
    assert flash_decode.copies == before
    for a, b in zip(got, flash_decode_plain(q, cache[1], cache[2], kv_len)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
    flat = torch.randn(cache[0].numel() + 1, generator=g, device=cuda).bfloat16()
    k = flat[1:].view(cache[0].shape)
    got = flash_decode(q, k, cache[2], kv_len, return_lse=True)
    assert flash_decode.copies == before + 1
    for a, b in zip(got, flash_decode_plain(q, k, cache[2], kv_len)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_flash_decode_graph_replays_are_identical(cuda):
    """Three replays of one captured call give the same bits as an eager
    call: the arrival counters are back at 0 after every launch."""
    from repro_torch.kernels.flash_decode import flash_decode

    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = _decode_case(g, 4, 32, 8, 2112, 128, torch.bfloat16, cuda)
    kv_len = torch.full((4,), 2049, dtype=torch.int64, device=cuda)
    eager = flash_decode(q, k, v, kv_len)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode(q, k, v, kv_len)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.cuda
def test_flash_decode_is_one_kernel_a_call(cuda):
    """On CUDA tensors a call is one device kernel and nothing else (no
    clamp, cast, merge kernel or normalising pass), with an int64 kv_len."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_decode import flash_decode

    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = _decode_case(g, 4, 32, 8, 2112, 128, torch.bfloat16, cuda)
    kv_len = torch.full((4,), 2049, dtype=torch.int64, device=cuda)
    flash_decode(q, k, v, kv_len)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            flash_decode(q, k, v, kv_len)
            flash_decode(q, k, v, kv_len, return_lse=True)
        torch.cuda.synchronize()
    device = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    if not device:
        pytest.skip("the profiler recorded no device activity here")
    names = {e.name for e in device}
    assert len(device) == 6 and all("flash_decode_sm90" in n for n in names), names


@pytest.mark.cuda
def test_flash_attention_misaligned_view_is_copied(cuda):
    """A bf16 view 2 bytes past a 16-byte boundary is copied for TMA (one
    copy counted) and gives the plain version's result; the model's
    transposed views are read in place."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=cuda).manual_seed(4)
    B, H, KVH, S, D = 2, 4, 2, 96, 64
    flat = torch.randn(B * H * S * D + 1, generator=g, device=cuda).bfloat16()
    q = flat[1:].view(B, H, S, D)
    k, v = (torch.randn((B, KVH, S, D), generator=g, device=cuda).bfloat16() for _ in range(2))
    before = flash_attention.copies
    got = flash_attention(q, k, v)
    assert flash_attention.copies == before + 1
    torch.testing.assert_close(got.float(), flash_attention_plain(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)
    qm, km, vm = (torch.randn((B, S, h, 128), generator=g, device=cuda).bfloat16().transpose(1, 2)
                  for h in (H, KVH, KVH))
    before = flash_attention.copies
    got = flash_attention(qm, km, vm)
    assert flash_attention.copies == before and got.stride() == qm.stride()
    torch.testing.assert_close(got.float(), flash_attention_plain(qm, km, vm).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_strided_head_dim(cuda, dtype):
    """q, k, v with a head-dim stride of S (transposed views of [B, heads,
    D, S] tensors) are copied by both routes, and the output, written with
    a unit head-dim stride, equals the plain version's."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=cuda).manual_seed(5)
    B, H, KVH, S, D = 2, 4, 2, 96, 64
    q = torch.randn((B, H, D, S), generator=g, device=cuda).to(dtype).transpose(2, 3)
    k, v = (torch.randn((B, KVH, D, S), generator=g, device=cuda).to(dtype).transpose(2, 3)
            for _ in range(2))
    before = flash_attention.copies
    got = flash_attention(q, k, v)
    assert flash_attention.copies == before + 3 and got.stride(-1) == 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), flash_attention_plain(q, k, v).float(),
                               atol=tol, rtol=tol)


# flash_attention's gradient: the forward cases above, whisper's non-causal
# encoder and cross-attention (D 64, 1,500 keys), starcoder2's 4,096 window,
# arctic's group of 7, a group of 7 at D 20, and rows that see no key
BWD_CASES = [
    (2, 4, 2, 256, 256, 64, True, None, 0), (1, 8, 8, 128, 128, 128, False, None, 0),
    (2, 4, 1, 256, 256, 64, True, 64, 0), (1, 2, 2, 64, 128, 32, True, None, 64),
    (1, 8, 2, 37, 53, 120, True, None, 16), (2, 4, 2, 48, 48, 16, True, 32, 0),
    (1, 2, 1, 16, 16, 16, True, None, -8), (1, 2, 1, 70, 70, 256, True, 20, 0),
    (1, 4, 2, 200, 333, 128, True, None, 133), (1, 2, 1, 100, 1000, 256, False, None, 0),
    (1, 4, 4, 300, 1500, 64, False, None, 0), (1, 4, 1, 600, 600, 128, True, 256, 0),
    (1, 14, 2, 100, 100, 20, True, None, 0), (1, 7, 1, 96, 96, 128, True, None, 0)]
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _bwd_inputs(g, B, H, KVH, Sq, Sk, D, dtype, dev, **kw):
    from repro_torch.kernels.flash_attention import flash_attention_with_lse

    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((B, H, Sq, D), (B, KVH, Sk, D), (B, KVH, Sk, D)))
    o, lse = flash_attention_with_lse(q, k, v, **kw)
    do = torch.randn((B, H, Sq, D), generator=g, device=dev).to(dtype)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,KVH,Sq,Sk,D,causal,window,q_offset", BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(cuda, B, H, KVH, Sq, Sk, D, causal, window,
                                                  q_offset, dtype):
    """The forward's lse against the plain version's (its output bit-equal
    to the call without lse), then the backward kernel against
    `flash_attention_bwd_plain` on the same inputs: one launch a call, and
    two calls give the same bits."""
    from repro_torch.kernels import flash_attention as fa

    kw = dict(causal=causal, window=window, q_offset=q_offset)
    g = torch.Generator(device=cuda).manual_seed(Sq * Sk + D + H)
    q, k, v, o, lse, do = _bwd_inputs(g, B, H, KVH, Sq, Sk, D, dtype, cuda, **kw)
    assert torch.equal(o, fa.flash_attention(q, k, v, **kw))
    want_lse = fa._plain(q, k, v, causal, window, None, q_offset, True)[1]
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    fin = torch.isfinite(want_lse)
    torch.testing.assert_close(lse[fin], want_lse[fin], atol=1e-4, rtol=1e-5)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert fa.flash_attention_bwd.launches == before + 2
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    tol = BWD_TOL[dtype]
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert torch.equal(a, c), f"{name}: two calls differ"
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
def test_flash_attention_autograd_goes_through_the_kernels(cuda):
    """Under autograd the model's layout (transposed [B, S, heads, D]
    views, bf16) runs the forward with lse and the backward kernel, no
    aligning copy, and the gradients agree with autograd of the plain
    version; without grad the call saves nothing."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(7)
    B, S, H, KVH, D = 2, 256, 8, 2, 128
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=cuda).bfloat16().requires_grad_()
               for h in (H, KVH, KVH))
    do = torch.randn((B, S, H, D), generator=g, device=cuda).bfloat16()
    launches = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    copies = (fa.flash_attention.copies, fa.flash_attention_bwd.copies)
    out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    got = torch.autograd.grad(out.transpose(1, 2), (q, k, v), do)
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert (fa.flash_attention.copies, fa.flash_attention_bwd.copies) == copies
    ref = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    want = torch.autograd.grad(ref.transpose(1, 2), (q, k, v), do)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=5e-2, rtol=5e-2, msg=name)
    with torch.no_grad():
        out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert out.grad_fn is None


def _fold_values(rng, n, dev):
    """float32 values of mixed signs and magnitudes (2**-30 to 2**20),
    with some signed zeros, so any change in the order of additions shows."""
    mag = np.exp2(rng.uniform(-30, 20, n))
    vals = (np.where(rng.random(n) < 0.5, -mag, mag) * (rng.random(n) > 0.05)).astype(np.float32)
    vals[rng.random(n) < 0.02] = -0.0
    return torch.as_tensor(vals, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["deep-8192", "empty-links", "fat-tree-bypass"])
def test_link_fold_kernel_matches_plain(cuda, case):
    """Bit-equal to the plain depth loop: one link of 8,192 entries beside
    shallow ones; links with no entries and -0 bases; a fat-tree whose
    intra-pod flows put 2 x 256 x 4 entries on the bypass.  One launch a
    call, and three graph replays give the eager bits."""
    from repro_torch.kernels.link_fold import link_fold, link_fold_plain, link_segments
    from repro_torch.net.topology import FatTreeGrid, fat_tree

    rng = np.random.default_rng(21)
    if case == "deep-8192":
        links = 97
        route = rng.integers(1, links, (2, 4096, 4))
        route[:, :, :1] = 0  # 2 x 4,096 entries on link 0
        route = torch.as_tensor(route.astype(np.int32))
    elif case == "empty-links":
        links = 300
        route = torch.as_tensor(rng.integers(0, 40, (3, 50, 4)).astype(np.int32) * 7)
    else:
        pairs = [(2 * (f % 8), 2 * (f % 8) + 1) for f in range(256)]
        route = fat_tree(4, 4, 2, 2, pairs).route
        links = FatTreeGrid(4, 4, 2, 2).links
    seg = link_segments(route.to(cuda), links)
    vals = _fold_values(rng, seg.entries, cuda).reshape(route.shape)
    base = _fold_values(rng, links, cuda)
    base[:5] = -0.0
    before = link_fold.launches
    got = link_fold(vals, seg, base)
    want = link_fold_plain(vals, seg, base)
    torch.cuda.synchronize()
    assert link_fold.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if case == "deep-8192":
        assert seg.depth == 8192
    if case == "fat-tree-bypass":
        assert seg.depth == 2 * 256 * 4
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = link_fold(vals, seg, base)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_fat_tree_sweep_on_the_card_equals_the_cpu(cuda):
    """A small fat-tree family with intra- and inter-pod flows through
    `sweep_flows_scenarios` with telemetry: every field and frame leaf of
    the card's run equals the CPU's, and the card's run launched
    `link_fold` on every tick."""
    import dataclasses

    from repro_torch import random as prng
    from repro_torch.kernels.link_fold import link_fold
    from repro_torch.net import scenarios, sender, telemetry, topology

    scens = list(scenarios.fat_tree_scenarios(flows=16, n_pods=4, horizon=128).values())
    mixed = [(2 * (f % 4), 2 * (f % 4) + 1) if f % 2 else (f % 8, (f + 3) % 8)
             for f in range(16)]
    topo = topology.fat_tree(4, 2, 2, 2, mixed)
    scens.append((topo, topology.null_schedule(topo.links)))
    topos, scheds = scenarios.stack_scenarios(scens)
    pols = (sender.Policy.ECMP, sender.Policy.WAM, sender.Policy.CC_COUPLED)
    spec = sender.spec_for_policies(sender.SenderSpec(
        rate_cap=16, early_exit=True, telemetry=telemetry.TelemetrySpec(stride=4, window=32)),
        pols)
    sp = sender.policy_sweep_params(pols, rate=16)
    keys = prng.split(prng.PRNGKey(5), 2)
    before = link_fold.launches
    card = sender.sweep_flows_scenarios(topos, scheds, spec, sp, 32, keys, 128, device=cuda)
    assert link_fold.launches - before >= int(card[0].ticks_run.sum()) * 2
    cpu = sender.sweep_flows_scenarios(topos, scheds, spec, sp, 32, keys, 128, device="cpu")
    for got, want in zip(card, cpu):
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(got, f.name).cpu(), getattr(want, f.name)), f.name


@pytest.mark.cuda
def test_telemetry_record_makes_no_host_wait(cuda):
    """A stride tick's telemetry (the link reader and `record`, whose tick
    index is a host integer) runs under torch's sync debug mode "error"
    without a host wait."""
    from repro_torch.net import sender, telemetry, topology

    pairs = [(f % 8, (f + 3) % 8) for f in range(64)]
    topo = sender.to_device(topology.fat_tree(4, 2, 2, 2, pairs), cuda)
    spec = telemetry.TelemetrySpec(stride=4, window=8)
    frame = telemetry.init_frame(spec, (64,), topo.n, topo.links, device=cuda)
    state = topology.init_shared_fabric(topo)
    z = torch.zeros(64, device=cuda)
    fpp = torch.zeros(64, topo.n, device=cuda)
    topology.link_telemetry(topo, state)  # builds the cached CSR once, as a run's first tick does
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frame = telemetry.record(
            spec, frame, (state.queue == 0).all(), tick=12, m=1 << 10,
            alloc=torch.ones(64, topo.n, dtype=torch.int32, device=cuda), sent_pp=fpp,
            dropped_pp=fpp, debt=z, emitted=z, received=z,
            j=torch.zeros(64, dtype=torch.int64, device=cuda),
            link=topology.link_telemetry(topo, state))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(frame.count) == 1
    assert frame.tick.cpu().tolist() == [12] + [0] * 7


def _ring_job(cuda):
    from repro_torch.net import jobs, scenarios, sender

    job = jobs.compile_job("qwen3-8b", workers=4, tp=8, iterations=1, rate=32, max_shard=48)
    topo, sched = scenarios.job_scenarios(workers=4, horizon=256)["link_flap"]
    return jobs, sender, job, sender.to_device(topo, cuda), sched


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["WAM", "ECMP", "CC_COUPLED"])
def test_job_step_makes_no_host_wait(cuda, policy):
    """One job step without early exit (whose chunk check is the one wait
    a run makes) runs under torch's sync debug mode "error": no copy to or
    from the host, the controller's scalars included.  The step runs once
    before, as a run's first step builds the link CSR and loads the
    kernels."""
    jobs, sender, job, topo, sched = _ring_job(cuda)
    pol = sender.Policy[policy]
    spec = sender.spec_for_policies(sender.SenderSpec(rate_cap=32), [pol])
    sp = sender.sender_params(pol, rate=32)
    shard, _, offsets = jobs.step_table(job)
    scheds = jobs.scheduled_events(sched, offsets[:1], 48, device=cuda)
    shard = torch.as_tensor(shard[:1], device=cuda)
    from repro_torch import random as prng
    key = prng.PRNGKey(0, device=cuda)
    want = jobs.run_job_steps(topo, scheds, spec, sp, shard, key, 48, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = jobs.run_job_steps(topo, scheds, spec, sp, shard, key, 48, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_job_and_cluster_runs_on_the_card_equal_the_cpu(cuda):
    """`run_job` (WAM, telemetry) and `run_cluster_rounds` on the card
    equal the same calls on the CPU, which the CPU tests hold to the JAX
    package."""
    import dataclasses

    from repro_torch import random as prng
    from repro_torch.net import cluster, scenarios, telemetry

    jobs, sender, job, topo, sched = _ring_job(cuda)
    spec = sender.SenderSpec(rate_cap=32, early_exit=True, exit_chunk=16,
                             telemetry=telemetry.TelemetrySpec(stride=4, window=16))
    wam = sender.sender_params(sender.Policy.WAM, rate=32)
    key = prng.PRNGKey(3)
    runs = [jobs.run_job(topo, sched, spec, wam, job, key, 256, device=d) for d in (cuda, "cpu")]
    for k in ("step_cct", "ettr", "exposed_comm_ticks", "finished"):
        assert np.array_equal(getattr(runs[0][0], k), getattr(runs[1][0], k)), k
    for f in dataclasses.fields(runs[1][1]):
        assert torch.equal(getattr(runs[0][1], f.name).cpu(), getattr(runs[1][1], f.name))
    js = [jobs.compile_job(a, workers=4, tp=8, iterations=1, rate=32, max_shard=48)
          for a in ("xlstm-350m", "qwen3-8b")]
    placed, ctopo, csched = scenarios.cluster_scenarios(js, horizon=256)["staggered_start"]
    scheds, sizes = cluster.cluster_inputs(placed, csched, 256)
    bare = dataclasses.replace(spec, telemetry=None)
    raw = [cluster.run_cluster_rounds(ctopo, scheds, bare, wam, sizes, key, 256, device=d)
           for d in (cuda, "cpu")]
    for k in ("cct", "finished", "link_served", "link_busy"):
        assert torch.equal(raw[0][k].cpu(), raw[1][k]), k
