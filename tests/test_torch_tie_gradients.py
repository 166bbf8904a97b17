"""The recurrences' gradients at a tie, and the long-sequence training
gradients of xlstm-350m and jamba against the JAX package, on the CPU.

The reference bounds its LSTM denominators with ``jnp.maximum`` and takes
``jax.nn.softplus`` (``logaddexp(x, 0)``, whose derivative is
``exp(x - softplus(x))``, 0.5 at 0).  ``jax.grad`` of ``maximum(x, y)``
splits a tie evenly between its operands, where ``torch.clamp`` passes the
whole gradient to ``x``.  An sLSTM step whose input gate sets the
stabiliser has ``i_p = exp(0) = 1`` exactly, so its normaliser
``n = f_p n + 1`` is exactly 1.0 whenever ``f_p n`` is below half an ulp
of 1: the port's gradient there was twice the reference's, at more steps
the longer the sequence.  The unit tests build such ties (``n`` exactly
1.0, ``|q . n|`` exactly 1.0, softplus at 0) and hold the port's steps'
gradients to ``jax.grad`` of the reference's steps.

The backward's bf16 roundings.  ``jax.grad`` of ``jax.nn.silu`` rounds
``g s + (x g) (s (1 - s))`` op by op, and the MoE's gate gradient sums
``ct * ye`` over the model axis in bf16 in XLA:CPU's order: `layers.silu`
and `moe._Gated` follow both (every bf16 value; the MoE block's weight
gradients bit for bit at 4 x 128 tokens).

Whole models.  One training step of xlstm-350m's and jamba's smoke configs
at 4 x 128 tokens (two 64-step chunks of every scan), the step-1 gradient
per leaf in relative L2 against ``jax.grad`` of the reference's loss (jamba
replays the reference's expert choices).  The floor beside it is the
port's own run against the same run with its recurrences' states and
updates in float64 (`float64_recurrences`), with the same routes.  Measured
with jax 0.9.0 and torch 2.13 (``python tests/test_torch_tie_gradients.py``
prints the tables): xlstm stands at most 0.082 from the reference, 2.0x
its largest floor (0.042); jamba 0.18 (a router), while its floor is
0.003: its forward already departs (the loss by 1.8e-4), and its bf16
roundings absorb the float64 recurrences whole (the same loss).  Before
the repairs: 0.083 and 0.18 (no tie arises in these runs).  `LONG_GRAD_TOL`
is 0.1 for xlstm (2.4x its floor) and 0.2 for jamba (1.1x its distance).
"""
import contextlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_zoo_reference import (  # noqa: E402,F401
    jax_train, one_torch_thread, recorded_top_k, reference_zoo, replay_routes)
from repro.configs import registry as jregistry  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import layers, moe, ssm  # noqa: E402
from repro_torch.models.moe import Routes  # noqa: E402

LONG_ARCHS = ("xlstm-350m", "jamba-v0.1-52b")
B, S = 4, 128
LONG_GRAD_TOL = {"xlstm-350m": 0.1, "jamba-v0.1-52b": 0.2}
LOSS_TOL = 2e-3
STEP_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread a worker (`one_torch_thread`)."""
    with one_torch_thread():
        yield


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got: torch.Tensor, want, what: str, tol: float = STEP_TOL):
    got, want = got.detach().double().numpy(), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, (what, float(err))


# ---------------------------------------------------------------------------
# the steps at a constructed tie
# ---------------------------------------------------------------------------
def test_softplus_gradient_matches_reference_at_the_tie():
    x = np.array([0.0, -0.0, 1e-8, -1e-8, 0.5, -3.0, 20.0, -20.0], np.float32)
    want = jax.vmap(jax.grad(jax.nn.softplus))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(ssm.softplus(t).sum(), t)
    assert float(got[0]) == 0.5 and float(got[1]) == 0.5
    _close(got, want, "softplus'")
    np.testing.assert_array_equal(ssm.softplus(t).detach().numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(x))))


def _mlstm_tie_inputs():
    """One step of 2 x 2 heads of dh 4 whose input gate sets the stabiliser
    (``li > lf + m``, so ``i_p = 1``) from ``n = 0``: ``n' = k``, and
    ``q . k`` is exactly 1.0 in head (0, 0) and exactly -1.0 in head (1, 1)."""
    rng = np.random.default_rng(0)
    shape = (2, 2, 4)
    C = rng.standard_normal((*shape, 4)).astype(np.float32)
    n = np.zeros(shape, np.float32)
    m = np.zeros(shape[:2], np.float32)
    q = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal(shape).astype(np.float32)
    q[0, 0], k[0, 0] = [1.0, 0.5, 0.0, 0.0], [0.5, 1.0, 0.25, 3.0]
    q[1, 1], k[1, 1] = [-0.5, 0.25, 0.0, 0.0], [1.0, -2.0, 7.0, 0.5]
    v = rng.standard_normal(shape).astype(np.float32)
    li = np.full(shape[:2], 2.0, np.float32)
    lf = np.full(shape[:2], -0.25, np.float32)
    return C, n, m, q, k, v, li, lf


def test_mlstm_step_gradient_matches_reference_at_the_tie(jax_train):
    from repro.models import ssm as jssm

    args = _mlstm_tie_inputs()
    w = np.random.default_rng(1).standard_normal((2, 2, 4)).astype(np.float32)
    np.testing.assert_array_equal(np.abs(np.einsum("bhk,bhk->bh", args[3], args[4]))[[0, 1],
                                                                                      [0, 1]],
                                  [1.0, 1.0])

    def ref(*a):
        (C, n, m), h = jssm._mlstm_step(a[:3], a[3:])
        return (h * w).sum() + C.sum() * 0.5 + n.sum() * 0.25

    want = jax.jit(jax.grad(ref, argnums=tuple(range(8))))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    C, n, m, h = ssm._mlstm_step(*ts)
    got = torch.autograd.grad((h * torch.from_numpy(w)).sum() + C.sum() * 0.5
                              + n.sum() * 0.25, ts)
    for name, g, wg in zip(("C", "n", "m", "q", "k", "v", "li", "lf"), got, want):
        _close(g, wg, f"d/d{name}")


def _slstm_tie_case(jcfg, cfg):
    """The smoke sLSTM's weights (the reference's init, converted) and one
    step whose input gate sets the stabiliser from ``n = 0``, so that
    ``n' = 1`` exactly in every unit."""
    from repro.models import ssm as jssm

    with jax.threefry_partitionable(False):
        jp = jax.jit(lambda key: jssm.init_slstm(key, jcfg))(jax.random.PRNGKey(3))
    jp = jax.tree.map(np.asarray, jp)
    d = cfg.d_model
    rng = np.random.default_rng(2)
    xw = (0.1 * rng.standard_normal((2, 4 * d))).astype(jnp.bfloat16)
    bias = np.asarray(jp["bias"], np.float32).copy()
    bias[d:2 * d] = 4.0          # the input gate: i_r > log_f + m, so m' = i_r
    jp["bias"] = bias
    c = rng.standard_normal((2, d)).astype(np.float32)
    n = np.zeros((2, d), np.float32)
    m = np.zeros((2, d), np.float32)
    h = (0.5 * rng.standard_normal((2, d))).astype(np.float32)
    return jp, (c, n, m, h), xw


def test_slstm_step_gradient_matches_reference_at_the_tie(jax_train):
    from repro.models import ssm as jssm

    jcfg, cfg = jregistry.get_smoke_config("xlstm-350m"), registry.get_smoke_config("xlstm-350m")
    jp, carry, xw = _slstm_tie_case(jcfg, cfg)
    w = np.random.default_rng(4).standard_normal(carry[0].shape).astype(np.float32)

    def ref(bias, c, n, m, h):
        p = dict(jp, bias=bias)
        (c2, n2, m2, h2), _ = jssm._slstm_step(p, jcfg, (c, n, m, h), jnp.asarray(xw))
        return (h2 * w).sum() + c2.sum() * 0.5
    n_new = jssm._slstm_step(jp, jcfg, tuple(map(jnp.asarray, carry)), jnp.asarray(xw))[0][1]
    np.testing.assert_array_equal(np.asarray(n_new), 1.0)
    want = jax.jit(jax.grad(ref, argnums=(0, 1, 2, 3, 4)))(jnp.asarray(jp["bias"]),
                                                  *map(jnp.asarray, carry))

    p = convert.model_params(jp)
    bias = p["bias"].requires_grad_()
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in carry]
    c2, n2, _, h2 = ssm._slstm_step(dict(p, bias=bias), cfg, *ts, torch.from_numpy(
        np.asarray(xw, np.float32)).to(torch.bfloat16))
    assert bool((n2 == 1.0).all())
    got = torch.autograd.grad((h2 * torch.from_numpy(w)).sum() + c2.sum() * 0.5, [bias, *ts])
    for name, g, wg in zip(("bias", "c", "n", "m", "h"), got, want):
        _close(g, wg, f"d/d{name}")


# ---------------------------------------------------------------------------
# the backward's bf16 roundings: silu, the MoE's gate
# ---------------------------------------------------------------------------
def test_silu_gradient_matches_reference_on_every_bf16_value():
    """`layers.silu` and its backward round as the reference's compiled
    ``jax.nn.silu`` and ``jax.grad`` of it on every finite bf16 value above
    -80 and of magnitude at least 2**-100, against a random bf16 cotangent:
    beyond those the products near the subnormal range, which XLA flushes
    (results in it compare as zero)."""
    tiny = np.finfo(np.float32).tiny
    x = np.arange(1 << 16, dtype=np.uint16).view(jnp.bfloat16)
    xf = x.astype(np.float32)
    x = x[np.isfinite(xf) & (np.abs(xf) >= 2.0**-100) & (xf > -80)]
    g = np.random.default_rng(0).standard_normal(x.shape).astype(jnp.bfloat16)
    want = jax.jit(lambda x, g: jax.vjp(jax.nn.silu, x)[1](g)[0])(jnp.asarray(x),
                                                                   jnp.asarray(g))
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).requires_grad_()
    y = layers.silu(xt)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g.astype(np.float32)).to(torch.bfloat16))
    def flushed(a):
        a = np.asarray(a, np.float32)
        return np.where(np.abs(a) < tiny, 0.0, a)

    np.testing.assert_array_equal(flushed(y.detach().float()),
                                  flushed(jax.jit(jax.nn.silu)(jnp.asarray(x))))
    np.testing.assert_array_equal(flushed(got.float()), flushed(want))


def test_moe_gradients_match_reference(jax_train):
    """jamba's smoke MoE at 4 x 128 tokens, the reference's expert choices
    replayed: the gradients of every weight equal the reference's bit for
    bit (the gate's gradient sums ``ct * ye`` over the model axis in bf16 in
    XLA:CPU's order, `moe._Gated`), the input's within 1e-4 relative L2."""
    from repro.models import moe as jmoe

    jcfg = jregistry.get_smoke_config("jamba-v0.1-52b")
    cfg = registry.get_smoke_config("jamba-v0.1-52b")
    p = jax.jit(lambda k: jmoe.init_moe(k, jcfg))(jax.random.PRNGKey(5))
    p = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16) if a.dtype == jnp.float32
                                          else a), p)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(jnp.bfloat16)
    w = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)

    def loss(p, x):
        y, aux = jmoe.moe(p, jcfg, x)
        return jnp.sum(y.astype(jnp.float32) * w) + aux

    calls: list = []
    with recorded_top_k(calls):
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
        jax.effects_barrier()
    routes = Routes()
    routes.calls = [torch.from_numpy(np.array(c[0])).long() for c in calls]
    leaves = tree.map_leaves(lambda t: t.requires_grad_(), convert.model_params(p))
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).requires_grad_()
    y, aux = moe.moe(leaves, cfg, xt, routes=routes.replay())
    got = torch.autograd.grad((y.float() * torch.from_numpy(w)).sum() + aux,
                              [xt, *tree.leaves(leaves)])
    want = dict(tree.paths(jax.tree.map(np.asarray, gp)))
    for (key, _), g in zip(tree.paths(leaves), got[1:]):
        np.testing.assert_array_equal(g.float().numpy(), want[key].astype(np.float32), key)
    assert _rel_l2(got[0].float().numpy(), gx) <= 1e-4


# ---------------------------------------------------------------------------
# whole models at 4 x 128 tokens
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def float64_recurrences():
    """`ssm._mamba_scan`, `_mlstm_scan` and `_slstm_scan` with their f32
    states (and the mLSTM's and Mamba's f32 inputs) in float64, the results
    cast back to f32 (the noise floor of the recurrences' f32 arithmetic);
    restored on exit.  The sLSTM's gate pre-activations stay f32 and its
    recurrent product bf16, as the model takes them."""
    kept = {k: getattr(ssm, k) for k in ("_mamba_scan", "_mlstm_scan", "_slstm_scan")}

    def wide(fn, n_fixed):
        def run(*args):
            fixed, rest = args[:n_fixed], args[n_fixed:]
            out = fn(*fixed, *(a.double() if a.dtype == torch.float32 else a for a in rest))
            return tuple(o.float() for o in out)
        return run

    ssm._mamba_scan = wide(kept["_mamba_scan"], 0)
    ssm._mlstm_scan = wide(kept["_mlstm_scan"], 0)
    ssm._slstm_scan = wide(kept["_slstm_scan"], 2)
    try:
        yield
    finally:
        for k, fn in kept.items():
            setattr(ssm, k, fn)


def reference_step_one(J, arch: str, seq: int):
    """The reference's loss and step-1 gradient (``jax.grad`` after the
    trainer's cast to bf16) on `SyntheticLM` tokens of B x ``seq``; its
    weights (numpy) and its forward's expert choices."""
    jcfg = jregistry.get_smoke_config(arch)
    with jax.threefry_partitionable(False):
        params = jax.jit(lambda k: J.model.init_params(k, jcfg))(jax.random.PRNGKey(0))
    batch = {"tokens": SyntheticLM(jcfg.vocab_size, seq, B).batch(0)["tokens"]}

    def loss_fn(p, b):
        p = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, p)
        return J.model.train_loss(p, jcfg, b)

    calls: list = []
    with recorded_top_k(calls):
        (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
        jax.effects_barrier()
    n_moe = sum(s.ffn == "moe" for s in jcfg.period) * jcfg.n_periods
    return (float(loss), dict(tree.paths(jax.tree.map(np.asarray, grads))),
            jax.tree.map(np.asarray, params), batch, calls[:2 * n_moe])


def port_step_one(arch: str, params, batch, calls):
    """The port's loss and step-1 gradient (f32 numpy by leaf key) on the
    reference's weights and tokens, its expert choices replayed."""
    cfg = registry.get_smoke_config(arch)
    p = tree.map_leaves(lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t,
                        convert.model_params(params))
    leaves = tree.map_leaves(lambda t: t.requires_grad_(), p)
    routes = replay_routes(cfg, calls) if calls else None
    loss, _ = M.train_loss(leaves, cfg, convert.model_cache(batch), routes=routes)
    grads = torch.autograd.grad(loss, tree.leaves(leaves))
    return float(loss.detach()), {k: g.float().numpy() for (k, _), g in
                                  zip(tree.paths(leaves), grads)}


def distances(J, arch: str, seq: int):
    """Per leaf, in relative L2: the port against the reference, and
    against its own float64 recurrences (the floor); and the three losses."""
    loss, want, params, batch, calls = reference_step_one(J, arch, seq)
    got_loss, got = port_step_one(arch, params, batch, calls)
    with float64_recurrences():
        f64_loss, f64 = port_step_one(arch, params, batch, calls)
    table = {k: (_rel_l2(got[k], want[k]), _rel_l2(got[k], f64[k])) for k in want}
    return table, (loss, got_loss, f64_loss)


@pytest.mark.parametrize("arch", LONG_ARCHS)
def test_long_sequence_gradients_match_reference(jax_train, arch):
    table, (loss, got_loss, f64_loss) = distances(jax_train, arch, S)
    assert abs(got_loss - loss) <= LOSS_TOL, (got_loss, loss)
    assert abs(f64_loss - got_loss) <= LOSS_TOL, (f64_loss, got_loss)
    worst = max(table, key=lambda k: table[k][0])
    assert table[worst][0] <= LONG_GRAD_TOL[arch], (worst, table[worst])
    # the floor is a floor: the float64 recurrences move the leaves, little
    assert 0 < max(f for _, f in table.values()) <= LONG_GRAD_TOL[arch]


def main(argv=None) -> int:
    """Print each leaf's distance from the reference and from the float64
    recurrences, for xlstm-350m and jamba at 4 x 128 and 4 x 256 tokens."""
    import importlib
    import types

    archs = [a for a in argv or [] if not a.isdigit()] or LONG_ARCHS
    seqs = [int(a) for a in argv or [] if a.isdigit()] or [128, 256]
    torch.set_num_threads(1)
    with reference_zoo():
        J = types.SimpleNamespace(model=importlib.import_module("repro.models.model"))
        for arch in archs:
            for seq in seqs:
                table, losses = distances(J, arch, seq)
                print(f"{arch} {B} x {seq}: losses (reference, port, port float64) {losses}")
                for col, what in enumerate(("from the reference", "floor")):
                    worst = max(table, key=lambda k: table[k][col])
                    print(f"  max distance {what}: {table[worst][col]:.6f} ({worst})")
                print("  leaf: from the reference / floor")
                for k, row in sorted(table.items()):
                    print(f"    {k}: " + " / ".join(f"{x:.6f}" for x in row))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
