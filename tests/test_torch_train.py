"""The port's training substrate against the JAX package, on the CPU:
optimizers, schedule, compression hooks, the data pipeline, the train
step at smoke size (qwen3-8b and h2o-danube-3-4b), microbatching, loss
curves and the trainer CLI's resume.

The reference trainer imports `repro.dist`, which the tree does not hold:
the module-scoped `jax_train` fixture of `_torch_zoo_reference` imports it
under stubs and removes them when this module's tests end.  Every
reference call is jitted and run under ``jax.threefry_partitionable(False)``
(the reference's parameters are drawn with the legacy key stream).

Tolerances, each with its reason:

* optimizers, 1e-6 relative: the same f32 formulas in the same order; the
  two libraries' pow, sqrt and rsqrt may differ in the last bit.  A bf16
  parameter is updated in f32 and rounded, so it is compared in bf16 steps:
  at most one step apart.
* the schedule, the compression hooks and the data pipeline: bit for bit.
* the train step: losses and metrics within 2e-3 (about 3e-4 of a loss of
  6), gradients within 5e-2 in relative L2 per leaf (measured <= 0.011):
  the port follows the reference's compiled bf16 rounding where it is
  systematic, and XLA's and torch's f32 exp, rsqrt and sums differ in an
  ulp now and then, which flips a bf16 rounding; parameters after each
  step within 2e-4: an AdamW update moves a parameter by about lr * sign(g)
  (lr 3e-3 times the schedule's 0, 0.01 and 0.02 over the three steps),
  and a gradient component near zero may take the other sign, which is
  twice the summed step, 1.8e-4, at most.
* microbatching: the reference test's own (2e-4 on the loss, atol 3e-5 and
  rtol 3e-3 on the parameters).
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_zoo_reference import jax_train, one_torch_thread  # noqa: E402,F401
from repro.configs import registry as jregistry  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.optim import adafactor as jadafactor  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import api as japi  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, host_batch  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.optim import adafactor, adamw, api  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread a worker (`one_torch_thread`)."""
    with one_torch_thread():
        yield


ARCHS = ("qwen3-8b", "h2o-danube-3-4b")
OPT_TOL, LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-6, 2e-3, 5e-2, 2e-4


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------- optimizers
def _opt_tree(rng, bf16: bool):
    """Factored leaves (both last dims >= 128, one with a leading stack
    dim), unfactored ones (a vector, a 200 x 100 matrix) and, with
    ``bf16``, the MoE giants' bf16 matrices."""
    shapes = {"a": (256, 128), "b": (64,), "c": {"d": (3, 130, 140), "e": (200, 100)}}
    if bf16:
        shapes["f"] = (128, 160)

    def draw(s, scale):
        if isinstance(s, dict):
            return {k: draw(v, scale) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)

    params, grads = draw(shapes, 0.1), draw(shapes, 3.0)  # a global norm >> 1: clipped
    if bf16:
        params["f"] = params["f"].astype(jnp.bfloat16)
        grads["f"] = grads["f"].astype(jnp.bfloat16)
    return params, grads


def _compare_tree(got, want, what):
    want = dict(tree.paths(want))
    for key, g in tree.paths(got):
        w = np.asarray(want[key])
        if w.dtype == jnp.bfloat16:  # one bf16 step at most
            assert g.dtype == torch.bfloat16, key
            step = np.abs(w.astype(np.float32)) * 2.0 ** -7 + 1e-30
            assert np.all(np.abs(_np(g) - w.astype(np.float32)) <= step), f"{what} {key}"
        else:
            np.testing.assert_allclose(_np(g), w, rtol=OPT_TOL, atol=OPT_TOL * np.abs(w).max(),
                                       err_msg=f"{what} {key}")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_optimizer_updates_match_reference(name, bf16):
    """Three updates on the same numpy params and grads (clipping active,
    lr scales 1, 0.5, 0.25): params and optimizer state."""
    rng = np.random.default_rng(3)
    params, grads = _opt_tree(rng, bf16)
    jopt = japi.make_optimizer(name, lr=1e-2, weight_decay=0.1)
    opt = api.make_optimizer(name, lr=1e-2, weight_decay=0.1)
    jstate = jopt.init(params)
    jp = params
    update = jax.jit(jopt.update)
    tp = convert.model_params(params)
    tstate = opt.init(tp)
    for i, lr_scale in enumerate((1.0, 0.5, 0.25)):
        g = jax.tree.map(lambda x: x * (1 + i), grads)
        jp, jstate = update(g, jstate, jp, jnp.float32(lr_scale))
        tp, tstate = opt.update(convert.model_params(jax.tree.map(np.asarray, g)), tstate, tp,
                                torch.tensor(lr_scale))
    _compare_tree(tp, jax.tree.map(np.asarray, jp), f"{name} params")
    _compare_tree(tstate, jax.tree.map(np.asarray, jstate), f"{name} state")
    assert int(tstate.step) == 3 and tstate.step.dtype == torch.int32


def test_factored_leaves_and_global_norm():
    """Adafactor factors exactly the leaves the reference does; the global
    norm equals the reference's."""
    params, grads = _opt_tree(np.random.default_rng(4), False)
    js = jadafactor.adafactor_init(params)
    ts = adafactor.adafactor_init(convert.model_params(params))
    for (k, a), (_, b) in zip(tree.paths(ts.vr), tree.paths(jax.tree.map(np.asarray, js.vr))):
        assert tuple(a.shape) == b.shape, k
    got = adamw.global_norm(convert.model_params(grads))
    want = jax.jit(jadamw.global_norm)(grads)
    np.testing.assert_allclose(float(got), float(want), rtol=OPT_TOL)


def test_schedule_and_compression_hooks_are_bit_equal():
    for step in (0, 1, 7, 10, 55, 99, 100, 101, 5000, 9999, 10000, 12000):
        for kw in ({}, dict(warmup=10, total=100, floor=0.1)):
            want = np.asarray(jax.jit(lambda s, kw=kw: japi.cosine_schedule(s, **kw))(
                jnp.int32(step)))
            got = api.cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
            assert got.dtype == torch.float32 and got.item() == want.item(), (step, kw)
    x = (np.random.default_rng(0).standard_normal(1000) * 3).astype(np.float32)
    q, s = jax.jit(japi.compress_int8)(x)
    tq, ts = api.compress_int8(torch.as_tensor(x))
    assert np.array_equal(tq.numpy(), np.asarray(q)) and ts.item() == float(s)
    assert np.array_equal(api.decompress_int8(tq, ts).numpy(),
                          np.asarray(jax.jit(japi.decompress_int8)(q, s)))
    x[::7] = x[3]  # ties
    vals, idx = japi.topk_sparsify(jnp.asarray(x), frac=0.05)
    tv, ti = api.topk_sparsify(torch.as_tensor(x), frac=0.05)
    assert np.array_equal(tv.numpy(), np.asarray(vals))
    assert np.array_equal(ti.numpy(), np.asarray(idx))


def test_data_pipeline_is_bit_equal():
    for kw in (dict(vocab_size=1000, seq_len=16, global_batch=4, n_shards=2),
               dict(vocab_size=151936, seq_len=64, global_batch=8, seed=5)):
        jds, ds = jdata.SyntheticLM(**kw), SyntheticLM(**kw)
        for step in (0, 7, 123):
            want = jdata.host_batch(jds, step, {"patches": ((2, 3, 4), jnp.bfloat16)})
            got = host_batch(ds, step, {"patches": ((2, 3, 4), torch.bfloat16)}, device="cpu")
            assert got["tokens"].dtype == torch.int32
            assert np.array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
            assert got["patches"].dtype == torch.bfloat16 and not got["patches"].any()
            assert np.array_equal(ds.shard_batch(step, 0)["tokens"],
                                  jds.shard_batch(step, 0)["tokens"])


# ---------------------------------------------------------------- the train step
@pytest.fixture(scope="module")
def reference_runs(jax_train):
    """Per arch: the reference's initial params and, for 3 AdamW steps on
    SyntheticLM batches, each step's loss, metrics and gradients (of the
    reference's own ``loss_fn``: cast to bf16, then `train_loss`) and the
    params after it."""
    J = jax_train
    out = {}
    for arch in ARCHS:
        cfg = jregistry.get_smoke_config(arch)
        opt = J.api.make_optimizer("adamw", lr=3e-3)
        with jax.threefry_partitionable(False):
            params = jax.jit(lambda k, c=cfg: J.model.init_params(k, c))(jax.random.PRNGKey(0))
        state = J.state.TrainState.create(params, opt.init(params))
        step = jax.jit(J.step.build_train_step(cfg, opt))

        def loss_fn(p, b, c=cfg):
            p = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x,
                             p)
            return J.model.train_loss(p, c, b)

        grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        ds = jdata.SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)
        steps = []
        for i in range(3):
            batch = jdata.host_batch(ds, i)
            (_, _), g = grad(state.params, batch)
            state, m = step(state, batch)
            steps.append(dict(metrics={k: float(v) for k, v in m.items()},
                              grads=jax.tree.map(np.asarray, g),
                              params=jax.tree.map(np.asarray, state.params)))
        out[arch] = (jax.tree.map(np.asarray, params), steps)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(reference_runs, arch):
    """Three AdamW steps from the reference's parameters: loss, ce,
    moe_aux and lr_scale, every leaf's gradient and the parameters after
    each step."""
    params0, steps = reference_runs[arch]
    cfg = registry.get_smoke_config(arch)
    opt = api.make_optimizer("adamw", lr=3e-3)
    params = convert.model_params(params0)
    state = TrainState.create(params, opt.init(params))
    step = build_train_step(cfg, opt)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)
    for i, want in enumerate(steps):
        loss, metrics, grads = step.grads(state.params, host_batch(ds, i, device="cpu"))
        state, m = step.apply(state, loss, metrics, grads)
        assert set(m) == set(want["metrics"])
        for k, v in want["metrics"].items():
            assert abs(float(m[k]) - v) <= LOSS_TOL, (i, k, float(m[k]), v)
        want_g = dict(tree.paths(want["grads"]))
        for key, g in tree.paths(grads):
            assert g.dtype == torch.float32, key
            assert _rel_l2(g, want_g[key]) <= GRAD_TOL, (i, key, _rel_l2(g, want_g[key]))
        want_p = dict(tree.paths(want["params"]))
        for key, p in tree.paths(state.params):
            np.testing.assert_allclose(_np(p), want_p[key], atol=PARAM_TOL, rtol=0,
                                       err_msg=f"step {i} {key}")
    assert int(state.step) == 3


def test_microbatch_equals_full_batch():
    """Gradient accumulation is a memory knob: one step with microbatch 4
    equals one with microbatch 1 on the same batch."""
    cfg = registry.get_smoke_config("qwen3-8b")
    opt = api.make_optimizer("adamw", lr=1e-3)
    batch = host_batch(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8), 0,
                       device="cpu")
    runs = []
    for mb in (1, 4):
        from repro_torch.models import model as M
        params = M.init_params(torch.Generator().manual_seed(0), cfg)
        state = TrainState.create(params, opt.init(params))
        runs.append(build_train_step(cfg, opt, microbatch=mb)(state, batch))
    (s1, m1), (s4, m4) = runs
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=2e-4)
    for a, b in zip(tree.leaves(s1.params), tree.leaves(s4.params)):
        np.testing.assert_allclose(_np(a), _np(b), atol=3e-5, rtol=3e-3)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_loss_decreases(name):
    """25 steps of the reference test's run: the loss goes down."""
    from repro_torch.models import model as M

    cfg = registry.get_smoke_config("qwen3-8b")
    opt = api.make_optimizer(name, lr=1e-2 if name == "adamw" else 3e-2)
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    state = TrainState.create(params, opt.init(params))
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    step = build_train_step(cfg, opt)
    losses = []
    for i in range(25):
        state, m = step(state, host_batch(ds, i, device="cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert int(state.step) == 25


def _manifest_sha1s(path):
    import json

    with open(os.path.join(path, "manifest.json")) as f:
        return {k: v["sha1"] for k, v in json.load(f)["arrays"].items()}


def test_cli_resume_equals_the_straight_run(tmp_path, capsys):
    """``--smoke --device cpu``: 6 steps straight, checkpoints every 3; then
    a run resumed from the step-3 checkpoint alone: the two final
    checkpoints are equal, SHA1 for SHA1."""
    common = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--steps", "6",
              "--ckpt-every", "3", "--seq-len", "32", "--global-batch", "4"]
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    train_cli.main(common + ["--ckpt-dir", str(straight)])
    assert ckpt.latest_step(str(straight)) == 6
    shutil.copytree(straight / "step_00000003", resumed / "step_00000003")
    (resumed / "LATEST").write_text("3")
    state = train_cli.main(common + ["--ckpt-dir", str(resumed), "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert int(state.step) == 6
    want = _manifest_sha1s(straight / "step_00000006")
    assert _manifest_sha1s(resumed / "step_00000006") == want
    assert any(k.startswith(".opt_state/.m/") for k in want) and ".step" in want
