"""The gradient of the port's `flash_attention` against the JAX package, on
the CPU.

CPU tensors run the autograd Function's plain forward and
`flash_attention_bwd_plain`; the card's backward kernel is held to those
in `chip_smoke.py` and `tests/test_torch_cuda.py`.  The reference
gradient is ``jax.grad`` (a VJP with the same output cotangent) of the
chunked path the JAX package's models use off the TPU
(``ops.flash_attention(backend="chunked")``): the reference has no
gradient of its Pallas kernel, and the last test pins that fault.  Inputs
are made with numpy from a seed; every reference call is jitted.

Tolerances.  f32: 2e-5 (the forward tests' f32 tolerance; the chunked
path's online softmax and the port's quadratic form differ by ~1e-6).
bf16: 2e-2 on values of order one, as the forward's: the gradients are
rounded to bf16 once (a step of 2**-8 relative), and the backward's
rowsum(dO * O) reads the bf16-rounded output where autograd of the
quadratic form differentiates the unrounded one.
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


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread a worker (`one_torch_thread`)."""
    with one_torch_thread():
        yield


TOL = {"f32": 2e-5, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (B, H, KVH, Sq, Sk, D, causal, window, q_offset): causal and not, a window,
# groups 1, 4 and 7, Sq != Sk (a suffix of the keys' positions), rows that
# see no key (a negative offset), D 20
CASES = [
    (2, 4, 4, 32, 32, 16, True, None, 0),
    (1, 4, 1, 24, 40, 32, False, None, 0),
    (2, 4, 1, 48, 48, 32, True, 8, 0),
    (1, 7, 1, 20, 20, 20, True, None, 0),
    (1, 14, 2, 16, 37, 20, True, 12, 21),
    (1, 8, 2, 20, 36, 16, True, None, 16),
    (1, 2, 1, 16, 16, 16, True, None, -8),
    (1, 4, 2, 16, 16, 24, True, 4, -6),
]


def _inputs(case, dtype):
    B, H, KVH, Sq, Sk, D = case[:6]
    rng = np.random.default_rng(sum(case[:6]) + case[8] + 17)
    jdt = DTYPES[dtype][0]
    return [rng.standard_normal(shape).astype(np.float32).astype(jdt)
            for shape in ((B, H, Sq, D), (B, KVH, Sk, D), (B, KVH, Sk, D), (B, H, Sq, D))]


def _port(x) -> torch.Tensor:
    return convert.model_cache({"x": np.asarray(x)})["x"]


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _kw(case):
    return dict(causal=case[6], window=case[7], q_offset=case[8])


@functools.lru_cache(maxsize=None)
def _reference_vjp(kw_items):
    kw = dict(kw_items)

    def vjp(q, k, v, do):
        out, pull = jax.vjp(lambda a, b, c: ops.flash_attention(a, b, c, backend="chunked",
                                                                **kw), q, k, v)
        return (out, *pull(do))

    return jax.jit(vjp)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_function_gradient_matches_reference_chunked_path(case, dtype):
    """Autograd through the port's `flash_attention` (the Function's CPU
    path) against ``jax.grad`` of the reference's chunked path, output and
    dq, dk, dv."""
    q, k, v, do = _inputs(case, dtype)
    ref = _reference_vjp(tuple(_kw(case).items()))(q, k, v, do)
    tq, tk, tv = (_port(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, **_kw(case))
    grads = torch.autograd.grad(out, (tq, tk, tv), _port(do))
    for name, got, want in zip(("o", "dq", "dk", "dv"), (out, *grads), ref):
        assert got.dtype == DTYPES[dtype][1], name
        _close(got, want, TOL[dtype], f"{name} {case}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_bwd_plain_matches_autograd_of_the_plain_forward(case, dtype):
    """`flash_attention_bwd_plain` from the forward's saved output and lse
    against torch autograd of `flash_attention_plain`; a row that sees no
    key gets zero gradients, and so do keys no row sees."""
    q, k, v, do = (_port(x) for x in _inputs(case, dtype))
    kw = _kw(case)
    o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    got = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_plain(*leaves, **kw), leaves, do)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        _close(a, b, TOL[dtype], f"{name} {case}")
    empty = torch.isinf(lse)
    if empty.any():
        assert bool((got[0][empty] == 0).all())


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_lse_is_the_rows_logsumexp(case):
    """The forward's lse is the natural log-sum-exp of ``scale q . k`` over
    each row's visible keys (float64 numpy), -inf where a row sees none;
    its output is the call without lse, bit for bit."""
    q, k, v, _ = (_port(x) for x in _inputs(case, "f32"))
    B, H, KVH, Sq, Sk, D, causal, window, q_offset = case
    o, lse = fa.flash_attention_with_lse(q, k, v, **_kw(case))
    assert torch.equal(o, fa.flash_attention(q, k, v, **_kw(case)))
    qd, kd = q.double().numpy() / np.sqrt(D), np.repeat(k.double().numpy(), H // KVH, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", qd, kd)
    qpos, kpos = np.arange(Sq)[:, None] + q_offset, np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    with np.errstate(divide="ignore"):
        want = np.log(np.where(mask, np.exp(s - s.max(-1, keepdims=True)), 0).sum(-1))
    want = want + s.max(-1)
    want[:, :, ~mask.any(-1)] = -np.inf
    got = lse.numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=1e-6)


def test_serving_call_saves_nothing():
    """Without grad, `flash_attention` is the serving call: no graph."""
    q, k, v, _ = (_port(x).requires_grad_() for x in _inputs(CASES[0], "f32"))
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None
    assert fa.flash_attention(q, k, v).grad_fn is not None


def test_reference_pallas_kernel_has_no_gradient():
    """A fault of the reference, pinned: ``jax.grad`` through
    `flash_attention_pallas` (interpret mode) raises, so the JAX package's
    trainer differentiates only the chunked path (ROADMAP §3).  When this
    fails, the reference gained a gradient and the port's tests should take
    it as their reference too."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((1, 2, 128, 64)), jnp.float32)
    with pytest.raises(AssertionError):
        jax.grad(lambda q: ops.flash_attention(q, x, x, backend="pallas").sum())(x)
