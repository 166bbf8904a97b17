"""The port's coded erasure path against `repro.net.fountain` and the
`lt_encode` oracle, on the CPU (the kernels' plain versions).

Inputs are made with numpy from a seed and handed to both packages.  The
reference's peeling decoder scans every equation per decoded symbol, so
it runs here only at K <= 256.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.net import fountain as jf  # noqa: E402
from repro_torch.kernels.lt_encode import as_int32_bits, lt_encode_plain  # noqa: E402
from repro_torch.net import fountain as tf  # noqa: E402

_ref_encode = jax.jit(ref.lt_encode_ref)


def _reference_encode(payload, neighbors, valid):
    return np.asarray(_ref_encode(payload, neighbors, valid))


def _port_encode(payload, neighbors, valid):
    return tf.as_uint32(tf.encode(payload, neighbors, valid, device="cpu"))


@pytest.mark.parametrize("K", [16, 64, 256, 8192])
def test_robust_soliton_bit_for_bit(K):
    want = jf.robust_soliton(K)
    got = tf.robust_soliton(K)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for c, delta in ((0.1, 0.5), (0.03, 0.01)):
        assert tf.robust_soliton(K, c, delta).tobytes() == jf.robust_soliton(K, c, delta).tobytes()


@pytest.mark.parametrize("K,R,dmax", [(16, 40, 16), (256, 441, 32), (1000, 300, 8), (64, 50, 1)])
def test_sample_encoding_same_draws(K, R, dmax):
    a = np.random.default_rng(K + R)
    b = np.random.default_rng(K + R)
    jn, jv = jf.sample_encoding(K, R, a, dmax=dmax)
    tn, tv = tf.sample_encoding(K, R, b, dmax=dmax)
    assert tn.dtype == jn.dtype and np.array_equal(tn, jn)
    assert tv.dtype == jv.dtype and np.array_equal(tv, jv)
    assert a.integers(0, 2**62) == b.integers(0, 2**62)  # streams left in step


def _encode_case(seed, K, P, R, dmax, lo, hi, p_valid=0.7):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2**32, (K, P), dtype=np.uint32)
    neigh = rng.integers(lo, hi, (R, dmax)).astype(np.int32)
    valid = rng.random((R, dmax)) < p_valid
    return payload, neigh, valid


# the shapes of tests/test_kernels.py, then ragged ones (K, P, R not
# multiples of 8, 512 or 4; dmax from 1 to past one block of slots)
SHAPES = [(64, 512, 16, 8), (128, 1024, 32, 16), (16, 512, 8, 4),
          (37, 1001, 13, 5), (5, 3, 7, 40), (1, 1, 1, 1), (300, 6, 11, 300), (9, 4, 1, 2)]


@pytest.mark.parametrize("K,P,R,dmax", SHAPES)
def test_lt_encode_matches_oracle(K, P, R, dmax):
    payload, neigh, valid = _encode_case(K * P + R, K, P, R, dmax, 0, K)
    want = _reference_encode(payload, neigh, valid)
    assert np.array_equal(_port_encode(payload, neigh, valid), want)
    got = lt_encode_plain(as_int32_bits(payload), torch.from_numpy(neigh),
                          torch.from_numpy(valid))
    assert np.array_equal(tf.as_uint32(got), want)
    assert np.array_equal(tf.as_uint32(tf.encode(payload, neigh, valid, device="cpu")),
                          np.asarray(jf.encode(payload, neigh, valid)))


@pytest.mark.parametrize("K,P,R,dmax", SHAPES[3:])
def test_lt_encode_negative_and_clamped_indices(K, P, R, dmax):
    """A negative index counts from the end once, then indices clamp to
    [0, K), as the reference's gather does; int64 indices past the int32
    range keep their row."""
    payload, neigh, valid = _encode_case(7 * K + dmax, K, P, R, dmax, -2 * K - 3, 2 * K + 3)
    want = _reference_encode(payload, neigh, valid)
    assert np.array_equal(_port_encode(payload, neigh, valid), want)
    wide = neigh.astype(np.int64) * (2**33 + 1)  # same sign, far out of range
    wide[neigh == 0] = 0
    assert np.array_equal(_port_encode(payload, wide, valid),
                          _reference_encode(payload, np.clip(wide, -K - 1, K), valid))


def test_lt_encode_degree_one_is_copy():
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 2**32, (8, 512), dtype=np.uint32)
    neigh = np.arange(8, dtype=np.int32)[:, None]
    got = _port_encode(payload, neigh, np.ones((8, 1), bool))
    assert np.array_equal(got, payload)


def test_lt_encode_invalid_slots_never_read():
    rng = np.random.default_rng(12)
    payload = rng.integers(0, 2**32, (4, 5), dtype=np.uint32)
    neigh = np.array([[2, 10**9], [-10**9, 1]], np.int32)
    valid = np.array([[True, False], [False, False]])
    got = _port_encode(payload, neigh, valid)
    assert np.array_equal(got[0], payload[2]) and not got[1].any()


def test_lt_encode_rejects_bad_operands():
    pay = torch.zeros((4, 4), dtype=torch.int32)
    nb = torch.zeros((2, 3), dtype=torch.int32)
    ok = torch.ones((2, 3), dtype=torch.bool)
    from repro_torch.kernels.lt_encode import lt_encode
    with pytest.raises(TypeError):
        lt_encode(pay.to(torch.int64), nb, ok)
    with pytest.raises(ValueError):
        lt_encode(pay, nb, ok[:, :2])
    with pytest.raises(ValueError):
        lt_encode(pay[:0], nb, ok)


def _peel_both(enc, neigh, valid, K):
    want = jf.peel_decode(enc, neigh, valid, K)
    got = tf.peel_decode(enc, neigh, valid, K)
    if want is None:
        assert got is None
    else:
        assert got is not None and got.dtype == want.dtype and np.array_equal(got, want)
    return got


@pytest.mark.parametrize("K,P,mult,seed", [(64, 16, 1.5, 0), (48, 8, 3.0, 1), (256, 4, 1.7, 2),
                                           (64, 4, 0.5, 3)])
def test_peel_decode_matches_reference(K, P, mult, seed):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2**32, (K, P), dtype=np.uint32)
    R = int(K * mult)
    neigh, valid = tf.sample_encoding(K, R, rng)
    enc = _port_encode(payload, neigh, valid)
    full = _peel_both(enc, neigh, valid, K)
    if mult >= 1.5:
        assert full is not None and np.array_equal(full, payload)
    else:
        assert full is None
    for frac in (0.5, 0.8, 0.95):
        keep = rng.permutation(R)[: int(frac * R)]
        _peel_both(enc[keep], neigh[keep], valid[keep], K)


def test_peel_decode_inconsistent_input_keeps_lifo_order():
    """Two degree-one equations give symbol 0 different values: the last
    one in the ripple wins, in the reference and in the port."""
    enc = np.array([[5], [9], [5 ^ 7], [3]], np.uint32)
    neigh = np.array([[0, 0], [0, 0], [0, 1], [1, 2]], np.int32)
    valid = np.array([[True, False], [True, False], [True, True], [True, True]])
    got = _peel_both(enc, neigh, valid, 3)
    assert got[:, 0].tolist() == [9, 9 ^ 5 ^ 7, 9 ^ 5 ^ 7 ^ 3]


def test_decode_overhead_curve_matches_reference():
    want = jf.decode_overhead_curve(128, 3, np.random.default_rng(3))
    got = tf.decode_overhead_curve(128, 3, np.random.default_rng(3), device="cpu")
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_decode_overhead_curve_censors_at_R():
    """At K = 1024 the soliton cut at dmax = 32 loses its spike and the
    first trial (seed 0) never decodes, even from all R = int(1.6K) + 32
    symbols: the curve reports R as if R symbols had decoded (the
    reference's silent censoring, reproduced)."""
    K = 1024
    R = int(K * 1.6) + 32
    assert tf.decode_overhead_curve(K, 1, np.random.default_rng(0), device="cpu").tolist() == [R]
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 2**32, (K, 8), dtype=np.uint32)
    neigh, valid = tf.sample_encoding(K, R, rng)
    assert tf.peel_decode(_port_encode(payload, neigh, valid), neigh, valid, K) is None
