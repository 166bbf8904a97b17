"""The remat policy ``"save_ffn"`` and Adafactor at bf16 parameters, against
the JAX package on the CPU.

``remat_policy="save_ffn"`` keeps the tensors the reference names
``ffn_h`` and ``ffn_out`` through each checkpointed sublayer's backward
(`transformer.run_stack_train`).  Held, on the smoke configs of qwen3-8b
(MLP), jamba (MoE + Mamba) and dbrx (MoE), 4 x 64 tokens: the loss and
every gradient are bit-equal to ``remat_policy=None``'s; both are held to
the reference's ``train_loss(..., remat_policy="save_ffn")`` at
`test_torch_train_zoo.py`'s tolerances (loss 2e-3; gradients 5e-2 in
relative L2 per leaf, jamba's 0.1), on the reference's weights and with
its forward's MoE choices replayed (`moe.Routes`), wherever the
reference's ``"save_ffn"`` gradients agree with its own ``None`` ones (to
1e-3); else to its ``None`` ones.  With jax 0.9.0 jamba's do not (up to
0.95 apart in the routers of its Mamba + MoE sublayers): the reference's
recomputed Mamba sublayers round otherwise than their forward, a near-tie
token takes another expert in the recomputation, and the policy pairs the
forward's kept expert products with the recomputation's gates.  The
backward runs fewer ops with the policy (it does not redo the kept ones),
and fewer products where the MoE's down product is kept; an unknown
policy raises.

Adafactor at jamba's leaf kinds: bf16 parameters (``param_dtype``
bfloat16, as the published config), the stacked expert matrices
``[1, E, d, f]`` factored on their last two axes (d_model 128 here, so
that they factor), f32 ``a_log`` / ``d_skip`` / routers.  A train step's
loss and gradients are held to the reference's as above (without remat:
the reference's recomputation sends a near-tie token to another expert
than its forward did, which moves a router's gradient by 0.15 where the
port replays the forward's choice; 0.065 at most without), and two
updates of the port's step on the reference's gradients, each from the
reference's parameters and state, to the reference's updates: f32 parameters and the second moments within
1e-6 (`test_torch_train.py`'s optimizer tolerance), bf16 parameters within
one bf16 step more (updated in f32, then rounded).  An update holds
at most three leaf-sized f32 temporaries at once (jamba's expert matrices
are 1.9 GB each in bf16 at their published widths).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from _torch_memory import LiveStorages  # noqa: E402
from _torch_zoo_reference import (  # noqa: E402,F401
    configs, jax_train, one_torch_thread, recorded_top_k, replay_routes)
from repro_torch import convert, tree  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.transformer import run_stack_train  # noqa: E402
from repro_torch.optim import api  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402

ARCHS = ("qwen3-8b", "jamba-v0.1-52b", "dbrx-132b")
LOSS_TOL, GRAD_TOL, OPT_TOL = 2e-3, {"jamba-v0.1-52b": 0.1}, 1e-6
# the reference's "save_ffn" gradients within this relative L2 of its own
# remat_policy=None ones, per leaf: the run the port is held to
SELF_TOL = 1e-3
B, S = 4, 64
PRODUCTS = ("mm", "bmm", "addmm", "baddbmm")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread a worker (`one_torch_thread`)."""
    with one_torch_thread():
        yield


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _bf16_leaves(t):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, t)


def _n_moe(cfg) -> int:
    return sum(s.ffn == "moe" for s in cfg.period) * cfg.n_periods


def _reference_step(J, jcfg, params, batch, **kw):
    """The reference trainer's loss and gradients (every f32 leaf cast to
    bf16 first), with its MoE choices recorded: (loss, metrics, grads,
    the forward's top_k calls)."""
    def loss_fn(p, b):
        return J.model.train_loss(_bf16_leaves(p), jcfg, b, **kw)

    calls: list = []
    with recorded_top_k(calls):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params,
                                                                                     batch)
        jax.effects_barrier()
    return loss, metrics, jax.tree.map(np.asarray, grads), calls[:2 * _n_moe(jcfg)]


def _init(J, jcfg):
    with jax.threefry_partitionable(False):
        params = jax.jit(lambda k: J.model.init_params(k, jcfg))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _tokens(cfg):
    return {"tokens": SyntheticLM(cfg.vocab_size, S, B).batch(0)["tokens"]}


@pytest.fixture(scope="module")
def reference(jax_train):
    """Per arch: the reference's weights and batch, its loss, gradients and
    MoE choices under ``remat_policy=None`` and ``"save_ffn"``, and the run
    the port is held to: ``"save_ffn"``'s where its gradients stand within
    `SELF_TOL` of its own ``None`` ones, else ``None``'s."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = configs(arch)
        params, batch = _init(jax_train, jcfg), _tokens(cfg)
        runs = {}
        for policy in (None, "save_ffn"):
            loss, _, grads, calls = _reference_step(jax_train, jcfg, params, batch,
                                                    remat_policy=policy)
            runs[policy] = dict(loss=float(loss), grads=dict(tree.paths(grads)), calls=calls)
        apart = max(_rel_l2(runs["save_ffn"]["grads"][k], g) for k, g in runs[None]["grads"].items())
        out[arch] = dict(cfg=cfg, params=params, batch=batch, runs=runs,
                         held=runs["save_ffn" if apart <= SELF_TOL else None])
    return out


def _port(cfg, params, batch, policy, routes):
    """The port's step gradients (`build_train_step`, with its cast) under
    ``remat_policy=policy``."""
    step = build_train_step(cfg, api.make_optimizer(cfg.optimizer), remat_policy=policy,
                            routes=routes)
    return step.grads(params, batch)


def _routes(cfg, calls):
    return replay_routes(cfg, calls) if _n_moe(cfg) else None


@pytest.mark.parametrize("arch", ARCHS)
def test_save_ffn_is_bit_equal_to_none_and_matches_reference(reference, arch):
    r = reference[arch]
    held = r["held"]
    cfg, params = r["cfg"], convert.model_params(r["params"])
    batch = convert.model_cache(r["batch"])
    loss, _, grads = _port(cfg, params, batch, "save_ffn", _routes(cfg, held["calls"]))
    loss0, _, grads0 = _port(cfg, params, batch, None, _routes(cfg, held["calls"]))
    assert torch.equal(loss, loss0)
    for (key, g), (_, g0) in zip(tree.paths(grads), tree.paths(grads0)):
        assert torch.equal(g, g0), key
    assert abs(float(loss) - held["loss"]) <= LOSS_TOL, (float(loss), held["loss"])
    tol = GRAD_TOL.get(arch, 5e-2)
    errs = {key: _rel_l2(g.float().numpy(), held["grads"][key]) for key, g in tree.paths(grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (worst, errs[worst])


class _OpCount(TorchDispatchMode):
    """Ops run under the mode: all of them, and the products."""

    def __init__(self):
        super().__init__()
        self.ops = self.products = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.products += func.overloadpacket.__name__ in PRODUCTS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_save_ffn_backward_runs_fewer_ops(reference, arch):
    """The backward's ops (its recomputations included): fewer with the
    policy everywhere (the activation's last op is kept), and fewer
    products where the MoE's down product (``ffn_out``) is kept; the MLP's
    down product is not named, so its recomputation stays."""
    r = reference[arch]
    cfg, batch = r["cfg"], convert.model_cache(r["batch"])
    params = tree.map_leaves(lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t,
                             convert.model_params(r["params"]))
    counts = {}
    for policy in (None, "save_ffn"):
        leaves = tree.map_leaves(lambda t: t.detach().requires_grad_(), params)
        loss, _ = M.train_loss(leaves, cfg, batch, remat_policy=policy,
                               routes=_routes(cfg, r["held"]["calls"]))
        with _OpCount() as count:
            torch.autograd.grad(loss, tree.leaves(leaves))
        counts[policy] = (count.ops, count.products)
    n_ffn = sum(s.ffn != "none" for s in cfg.period) * cfg.n_periods
    assert counts["save_ffn"][0] <= counts[None][0] - n_ffn, counts
    assert counts["save_ffn"][1] == counts[None][1] - _n_moe(cfg), counts


def test_unknown_remat_policy_raises():
    _, cfg = configs("qwen3-8b")
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros((1, 8, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="expected one of None, 'save_ffn'"):
        run_stack_train(params["layers"], cfg, x, torch.arange(8)[None], remat_policy="dots")
    with pytest.raises(ValueError, match="remat_policy='save_dots'"):
        M.train_loss(params, cfg, {"tokens": torch.zeros((1, 8), dtype=torch.int32)},
                     remat_policy="save_dots")


def _bf16_jamba():
    return (dataclasses.replace(c, param_dtype="bfloat16", d_model=128)
            for c in configs("jamba-v0.1-52b"))


def _compare_tree(got, want, what):
    """f32 leaves within ``OPT_TOL`` (rtol, and atol of the leaf's largest
    value); bf16 leaves within one bf16 step of the value plus that atol:
    a last-bit difference before a subtraction that cancels to near zero
    moves the rounded result by more than one of its own steps."""
    want = dict(tree.paths(want))
    for key, g in tree.paths(got):
        w = np.asarray(want[key]).astype(np.float32)
        atol = OPT_TOL * np.abs(w).max()
        if want[key].dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16, key
            assert np.all(np.abs(g.float().numpy() - w) <= np.abs(w) * 2.0 ** -7 + atol), (
                what, key)
        else:
            np.testing.assert_allclose(g.float().numpy(), w, rtol=OPT_TOL, atol=atol,
                                       err_msg=f"{what} {key}")


def test_jamba_bf16_adafactor_step_matches_reference(jax_train):
    J = jax_train
    jcfg, cfg = _bf16_jamba()
    params = _init(J, jcfg)
    leaves = [a for _, a in tree.paths(params)]
    assert any(a.dtype == jnp.bfloat16 and a.ndim == 4 and a.shape[-1] >= 128
               and a.shape[-2] >= 128 for a in leaves)          # stacked expert matrices, factored
    assert any(a.dtype == np.float32 for a in leaves)            # a_log, d_skip, routers
    batch = _tokens(cfg)
    loss, _, grads, calls = _reference_step(J, jcfg, params, batch, remat=False)
    p = convert.model_params(params)
    opt = api.make_optimizer("adafactor", lr=1e-2)
    step = build_train_step(cfg, opt, remat=False, routes=_routes(cfg, calls),
                            schedule=lambda s: torch.ones((), dtype=torch.float32))
    got_loss, metrics, got = step.grads(p, convert.model_cache(batch))
    assert abs(float(got_loss) - float(loss)) <= LOSS_TOL
    want = dict(tree.paths(grads))
    errs = {key: _rel_l2(g.float().numpy(), want[key]) for key, g in tree.paths(got)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL["jamba-v0.1-52b"], (worst, errs[worst])

    jopt = J.api.make_optimizer("adafactor", lr=1e-2)
    update = jax.jit(jopt.update)
    jp, jstate = params, jopt.init(params)
    for i in range(2):  # each update from the reference's state: step 2's beta2 is not 0
        state = TrainState(params=convert.model_params(jp), step=torch.tensor(i, dtype=torch.int32),
                           opt_state=convert.adafactor_state(jax.tree.map(np.asarray, jstate)))
        jp, jstate = update(grads, jstate, jp, jnp.float32(1.0))
        state, _ = step.apply(state, got_loss, metrics, convert.model_params(grads))
        _compare_tree(state.params, jax.tree.map(np.asarray, jp), f"update {i + 1} params")
        _compare_tree(state.opt_state, jax.tree.map(np.asarray, jstate), f"update {i + 1} state")


def test_adafactor_update_holds_three_leaf_copies():
    """A factored bf16 leaf and an unfactored f32 one of the same size:
    at most three f32 temporaries of the leaf's size alive at once."""
    g = torch.Generator().manual_seed(5)
    shape = (1, 4, 128, 256)
    params = {"w": torch.randn(shape, generator=g).to(torch.bfloat16),
              "v": torch.randn((2, 4, 64, 256), generator=g)}
    grads = {k: torch.randn(v.shape, generator=g).to(v.dtype) for k, v in params.items()}
    nbytes = 4 * int(np.prod(shape))
    opt = api.make_optimizer("adafactor", lr=1e-2)
    state = opt.init(params)
    live = LiveStorages(lambda t: t.untyped_storage().nbytes() == nbytes)
    with live:
        opt.update(grads, state, params, 1.0)
    assert live.peak <= 3, live.peak
