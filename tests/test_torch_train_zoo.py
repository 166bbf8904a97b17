"""`train_loss` and its gradients for the rest of the model zoo against the
JAX package, on the CPU: qk-less dense (qwen1.5's qkv biases), the gelu
MLP and window (starcoder2), MoE with its aux loss (dbrx; arctic with its
dense branch), Mamba + attention + MoE (jamba), mLSTM / sLSTM (xlstm),
whisper's encoder-decoder over frames and llava's projector over patches.

Both packages take the same weights (the reference's `init_params`,
carried over by `convert.model_params`), the same tokens (`SyntheticLM`)
and the same frames or patches (numpy, bf16), and differentiate the loss
after the reference trainer's cast of every f32 leaf to bf16.  The MoE
archs replay the reference's own expert choices (`moe.Routes`): they are
recorded from the reference's ``lax.top_k`` calls through
``jax.debug.callback`` while its gradient program runs, since a near-tie
between two experts' gates flips with the last bit of the hidden state
and moves that token's output by a whole expert (jamba's gradients move
by 0.2 in relative L2 without the replay).

Tolerances.  Loss, ce and moe_aux within 2e-3 (measured <= 9e-4, jamba).
Gradients per leaf within 5e-2 in relative L2 (measured <= 0.027,
qwen1.5's biases), and jamba's within 0.1 (measured 0.06): its 7 Mamba
sublayers carry bf16 roundings through exp(dt * A) and the scan, whose
order differs from the reference's associative scan.  The port follows
the reference's compiled rounding (`run_stack_train`), and XLA's and
torch's f32 exp, rsqrt and sums differ in an ulp now and then, which
flips a bf16 rounding.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_zoo_reference import jax_train, one_torch_thread  # noqa: E402,F401
from repro.configs import registry as jregistry  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.train import modality_stubs  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.moe import Routes  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread a worker (`one_torch_thread`)."""
    with one_torch_thread():
        yield


ARCHS = ("qwen1.5-4b", "starcoder2-3b", "dbrx-132b", "arctic-480b", "jamba-v0.1-52b",
         "xlstm-350m", "whisper-large-v3", "llava-next-mistral-7b")
LOSS_TOL = 2e-3
GRAD_TOL = {"jamba-v0.1-52b": 0.1}
B, S = 4, 64


@contextlib.contextmanager
def _recorded_top_k(calls: list):
    """``jax.lax.top_k`` reporting each call's indices to ``calls`` as the
    compiled program runs (restored on exit)."""
    orig = jax.lax.top_k

    def top_k(x, k):
        values, idx = orig(x, k)
        jax.debug.callback(lambda i: calls.append(np.asarray(i)), idx)
        return values, idx

    jax.lax.top_k = top_k
    try:
        yield
    finally:
        jax.lax.top_k = orig


def _replay(cfg, calls) -> Routes:
    """The port's routes holding the reference's forward choices: two
    top_k calls a MoE sublayer (tokens' experts, experts' tokens), in
    order, for the one forward pass of the step (the reference's backward
    recomputes them after the forward's)."""
    routes = Routes()
    it = iter(calls)
    for n in range(cfg.n_periods):
        for i, spec in enumerate(cfg.period):
            if spec.ffn == "moe":
                for which in ("tokens", "experts"):
                    idx = np.array(next(it)[0])  # the one data group's choices
                    routes.sites[(0, n, i, which)] = torch.from_numpy(idx).long()
    return routes.replay()


def _batch(cfg):
    """Tokens from `SyntheticLM`; patches or frames from a numpy seed (bf16)."""
    rng = np.random.default_rng(1)
    out = {"tokens": SyntheticLM(cfg.vocab_size, S, B).batch(0)["tokens"]}
    for name, (shape, _) in modality_stubs(cfg, B, S).items():
        out[name] = rng.standard_normal(shape).astype(jnp.bfloat16)
    return out


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_reference(jax_train, arch):
    J = jax_train
    jcfg, cfg = jregistry.get_smoke_config(arch), registry.get_smoke_config(arch)
    with jax.threefry_partitionable(False):
        params = jax.jit(lambda k: J.model.init_params(k, jcfg))(jax.random.PRNGKey(0))
    batch = _batch(cfg)

    def loss_fn(p, b):
        p = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, p)
        return J.model.train_loss(p, jcfg, b)

    calls: list = []
    with _recorded_top_k(calls):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params,
                                                                                     batch)
        jax.effects_barrier()
    n_moe = sum(s.ffn == "moe" for s in cfg.period) * cfg.n_periods
    assert len(calls) == 4 * n_moe  # the forward's and the backward's recomputation

    p = tree.map_leaves(lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t,
                        convert.model_params(jax.tree.map(np.asarray, params)))
    leaves = tree.map_leaves(lambda t: t.requires_grad_(), p)
    routes = _replay(cfg, calls[:2 * n_moe]) if n_moe else None
    got_loss, got_metrics = M.train_loss(leaves, cfg, convert.model_cache(batch), routes=routes)
    got_grads = torch.autograd.grad(got_loss, tree.leaves(leaves))

    got_loss = got_loss.detach()
    assert abs(float(got_loss) - float(loss)) <= LOSS_TOL, (float(got_loss), float(loss))
    for k in ("ce", "moe_aux"):
        assert abs(float(got_metrics[k].detach()) - float(metrics[k])) <= LOSS_TOL, k
    if n_moe:
        assert int(routes.choices) > 0
    tol = GRAD_TOL.get(arch, 5e-2)
    want = dict(tree.paths(jax.tree.map(np.asarray, grads)))
    for (key, _), g in zip(tree.paths(leaves), got_grads):
        err = _rel_l2(g.float().numpy(), want[key])
        assert err <= tol, (key, err)
