"""The port's dense serving path against the JAX model zoo, on the CPU.

The JAX model imports `repro.dist.sharding`, which the tree does not hold;
the module-scoped `jax_model` fixture of `_torch_zoo_reference` imports it
under a stub with a no-op `shard` and removes both when the module's tests
end.  No global JAX or torch setting is touched, and every reference call
is jitted.

Both packages run the same weights (the reference's `init_params`, carried
over by `convert.model_params`) on the same prompts: `smoke()` of qwen3-8b
and of h2o-danube-3-4b (whose window of 32 makes the 48-token prompt wrap
the ring-buffer cache), B = 2, 48 prompt tokens, then 8 decode steps
teacher-forced with the reference's greedy tokens, so that one near-tie
cannot cascade.

Tolerance.  On this CPU the port equals the reference bit for bit in every
logit, and its caches differ in one bf16 entry by 3e-8 (the two packages'
matrix products sum in other orders).  That is because the port follows
the reference's compiled rounding: XLA keeps the attention residual's sum
in f32 for the FFN's norm and rounds every op of bf16 `silu`.  Other
compiled roundings of the same program (every residual rounded; the
residual kept in f32; `silu` rounded once) move the logits by up to 0.047
(0.038 of ``1 + |logit|``), and which one a JAX version compiles is not
fixed.  So logits and caches are compared with ``atol = rtol = 5e-2``, and
greedy tokens exactly wherever the reference's top-1 / top-2 margin
exceeds twice that.
"""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_zoo_reference import QUANT, configs, jax_model  # noqa: E402,F401
from repro.configs import registry as jregistry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import LayerSpec  # noqa: E402
from repro_torch.launch.serve import generate, prompts, serve_batch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train.step import build_prefill_step  # noqa: E402

TOL = 5e-2
ARCHS = ("qwen3-8b", "h2o-danube-3-4b")
B, S, STEPS = 2, 48, 8


@pytest.fixture(scope="module")
def runs(jax_model):
    """Per arch: the reference's and the port's logits and caches."""
    JM = jax_model
    out = {}
    for arch in ARCHS:
        jcfg, cfg = jregistry.get_smoke_config(arch), registry.get_smoke_config(arch)
        params = jax.jit(lambda key, c=jcfg: JM.init_params(key, c))(jax.random.PRNGKey(0))
        tokens = prompts(cfg, B, S, "cpu")
        toks = tokens.numpy()
        prefill = jax.jit(lambda p, t, c, cfg_=jcfg: JM.prefill(p, cfg_, {"tokens": t}, c))
        decode = jax.jit(lambda p, t, pos, c, cfg_=jcfg: JM.decode_step(p, cfg_, t, pos, c))
        cache = jax.jit(lambda c=jcfg: JM.make_cache(c, B, S + STEPS + 1))()
        lg, cache = prefill(params, toks, cache)
        ref_cache_prefill = jax.tree.map(np.asarray, cache)
        logits = [np.asarray(lg)]
        for g in range(STEPS):
            feed = np.argmax(logits[-1], axis=-1).astype(np.int32)
            lg, cache = decode(params, feed[:, None], np.full(B, S + g, np.int32), cache)
            logits.append(np.asarray(lg))
        ref_logits = np.stack(logits)
        ref_tokens = np.argmax(ref_logits, axis=-1).astype(np.int32).T  # [B, STEPS + 1]

        np_params = jax.tree.map(np.asarray, params)
        port_params = M.compute_params(convert.model_params(np_params))
        step = build_prefill_step(cfg)
        _, port_cache_prefill, port_prefill_logits = step(
            port_params, {"tokens": tokens}, M.make_cache(cfg, B, S + STEPS + 1, device="cpu"))
        run = generate(port_params, cfg, {"tokens": tokens}, STEPS + 1,
                       forced=torch.as_tensor(ref_tokens))
        out[arch] = dict(
            cfg=cfg, jcfg=jcfg, np_params=np_params, ref_logits=ref_logits,
            ref_tokens=ref_tokens, ref_cache_prefill=ref_cache_prefill,
            ref_cache_end=jax.tree.map(np.asarray, cache),
            port_prefill_logits=port_prefill_logits, port_cache_prefill=port_cache_prefill,
            run=run)
    return out


def _close(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=TOL, rtol=TOL)


def _caches_close(port, ref):
    assert port.keys() == ref.keys()
    for sub in ref:
        for name in ("k", "v"):
            assert tuple(port[sub][name].shape) == ref[sub][name].shape
            assert port[sub][name].dtype == torch.bfloat16
            _close(port[sub][name], ref[sub][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_reference(runs, arch):
    r = runs[arch]
    _close(r["port_prefill_logits"], r["ref_logits"][0])
    _caches_close(r["port_cache_prefill"], r["ref_cache_prefill"])


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_reference(runs, arch):
    r = runs[arch]
    run = r["run"]
    assert run.logits.shape == r["ref_logits"].shape and run.logits.dtype == torch.float32
    _close(run.logits, r["ref_logits"])
    _caches_close(run.cache, r["ref_cache_end"])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_where_the_margin_allows(runs, arch):
    r = runs[arch]
    top2 = np.sort(r["ref_logits"], axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0] > 2 * TOL).T  # [B, STEPS + 1]
    got = r["run"].tokens.numpy()
    assert got.dtype == np.int32
    assert clear.sum() >= clear.size // 2
    np.testing.assert_array_equal(got[clear], r["ref_tokens"][clear])


def test_sliding_window_wraps_the_ring_buffer(runs):
    """h2o-danube's smoke window of 32 bounds its cache; 48 + 8 positions
    wrap it, and the last step wrote slot (48 + 7) % 32."""
    r = runs["h2o-danube-3-4b"]
    assert r["cfg"].window == 32
    assert r["run"].cache["sub0"]["k"].shape[2] == 32
    assert runs["qwen3-8b"]["run"].cache["sub0"]["k"].shape[2] == S + STEPS + 1


@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    for port, ref in ((registry.get_config(arch), jregistry.get_config(arch)),
                      (registry.get_smoke_config(arch), jregistry.get_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.head_dim == ref.head_dim and port.n_periods == ref.n_periods


def test_registry_knows_every_reference_id():
    """Every id resolves, and `all_configs` equals the reference's."""
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    port, ref = registry.all_configs(), jregistry.all_configs()
    assert list(port) == list(ref) == registry.ARCH_IDS
    for arch in registry.ARCH_IDS:
        assert dataclasses.asdict(port[arch]) == dataclasses.asdict(ref[arch])
        assert registry.get_config(arch) is port[arch]
    with pytest.raises(KeyError):
        registry.get_smoke_config("no-such-model")


# every arch, and qwen3-8b with the int8 KV cache
TREES = (*jregistry.ARCH_IDS, QUANT)


@pytest.fixture(scope="module")
def trees(jax_model):
    """Per case: the reference's parameter tree and a decode cache of its
    layout filled with seeded values of each leaf's dtype (numpy)."""
    rng = np.random.default_rng(0)
    out = {}
    for case in TREES:
        jcfg, cfg = configs(case)
        params = jax.jit(lambda key, c=jcfg: jax_model.init_params(key, c))(
            jax.random.PRNGKey(0))
        cache = jax.tree.map(np.asarray, jax.jit(lambda c=jcfg: jax_model.make_cache(c, 2, 8))())

        def fill(a):
            if a.dtype == np.int8:
                return rng.integers(-127, 128, a.shape).astype(np.int8)
            return rng.standard_normal(a.shape).astype(a.dtype)

        out[case] = dict(cfg=cfg, params=jax.tree.map(np.asarray, params),
                         cache=jax.tree.map(fill, cache))
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("arch", TREES)
def test_convert_round_trips_params_and_caches(trees, arch):
    """`convert` carries every leaf across with its bits and dtype: the
    encoder, the projector, MoE routers and experts, arctic's dense branch,
    the recurrent blocks' f32 leaves; int8 caches with their f32 scales,
    Mamba's h / conv, mLSTM's C / n / m and sLSTM's c / n / m / h."""
    r = trees[arch]

    def walk(p, ref):
        assert p.keys() == ref.keys()
        for k in ref:
            if isinstance(ref[k], dict):
                walk(p[k], ref[k])
            else:
                assert str(p[k].dtype).split(".")[1] == ref[k].dtype.name, k
                got = p[k].view(torch.int16) if p[k].dtype == torch.bfloat16 else p[k]
                np.testing.assert_array_equal(got.numpy(), _bits(ref[k]))

    walk(convert.model_params(r["params"]), r["params"])
    walk(convert.model_cache(r["cache"]), r["cache"])


@pytest.mark.parametrize("arch", TREES)
def test_port_params_have_the_reference_layout(trees, arch):
    """`init_params` from a torch.Generator builds the reference's tree:
    the same keys, shapes and dtypes (not its numbers); so does
    `make_cache`.  `compute_params` casts the leaves the reference casts."""
    r = trees[arch]
    port = M.init_params(torch.Generator().manual_seed(0), r["cfg"])

    def walk(p, ref):
        assert p.keys() == ref.keys()
        for k in ref:
            if isinstance(ref[k], dict):
                walk(p[k], ref[k])
            else:
                assert tuple(p[k].shape) == ref[k].shape, k
                assert str(p[k].dtype).split(".")[1] == ref[k].dtype.name, k

    walk(port, r["params"])
    walk(M.make_cache(r["cfg"], 2, 8, device="cpu"), r["cache"])
    bf16 = M.compute_params(port)
    sub = bf16["layers"]["sub0"]
    assert sub["mixer"][next(iter(sub["mixer"]))].dtype == torch.bfloat16
    assert bf16["head"] is port["head"] and bf16["embed"] is port["embed"]


def test_unported_kinds_raise():
    """Every sublayer kind and FFN of the zoo is ported; a kind the zoo
    does not have raises before anything is allocated, and training
    (`train_loss`, ported since) raises on it before it runs a layer."""
    cfg = registry.get_smoke_config("qwen3-8b")
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(gen, cfg)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    for period in ((LayerSpec("conv", "mlp"),), (LayerSpec("attn", "glu"),)):
        bad = dataclasses.replace(cfg, period=period)
        with pytest.raises(ValueError, match="unknown sublayer"):
            M.init_params(gen, bad)
        with pytest.raises(ValueError, match="unknown sublayer"):
            M.make_cache(bad, 1, 8, device="cpu")
        with pytest.raises(ValueError, match="unknown sublayer"):
            M.train_loss(params, bad, batch)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_every_arch_builds_caches_and_prefills(arch):
    """Each of the ten archs builds, makes a cache and serves at smoke size
    on the CPU: the serving CLI's batch, prefill, two decode steps, finite
    logits of the vocabulary's width."""
    cfg = registry.get_smoke_config(arch)
    params = M.compute_params(M.init_params(torch.Generator().manual_seed(0), cfg))
    run = generate(params, cfg, serve_batch(cfg, 2, 16, "cpu"), 3)
    assert run.logits.shape == (3, 2, cfg.vocab_size)
    assert bool(torch.isfinite(run.logits).all())
    assert run.tokens.shape == (2, 3) and run.tokens.dtype == torch.int32


def test_qkv_with_biases_matches_reference(jax_model):
    """`_qkv` with the optional q/k/v biases (no ported config sets them)
    and without qk-norm, against the reference's on the same inputs."""
    jlayers = sys.modules["repro.models.layers"]
    from repro_torch.models import layers

    cfg = dataclasses.replace(registry.get_smoke_config("qwen3-8b"), qkv_bias=True,
                              qk_norm=False)
    jcfg = dataclasses.replace(jregistry.get_smoke_config("qwen3-8b"), qkv_bias=True,
                               qk_norm=False)
    params = jax.jit(lambda key: jlayers.init_attention(key, jcfg))(jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    params = {k: np.asarray(v) for k, v in params.items()}
    for name in ("bq", "bk", "bv"):
        params[name] = rng.standard_normal(params[name].shape).astype(np.float32)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32).astype(jax.numpy.bfloat16)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    want = jax.jit(lambda p, x, pos: jlayers._qkv(p, jcfg, x, pos))(params, x, pos)
    got = layers._qkv(convert.model_params(params), cfg, convert.model_cache({"x": x})["x"],
                      torch.as_tensor(pos))
    for g, w in zip(got, want):
        _close(g, w)


def test_plain_flag_runs_the_plain_versions_on_the_cpu():
    """On CPU tensors the kernels' wrappers run the plain versions, so a
    run with ``plain=True`` is the same run."""
    cfg = registry.get_smoke_config("h2o-danube-3-4b")
    params = M.compute_params(M.init_params(torch.Generator().manual_seed(1), cfg))
    tokens = prompts(cfg, 2, 40, "cpu")
    a = generate(params, cfg, {"tokens": tokens}, 4)
    b = generate(params, cfg, {"tokens": tokens}, 4, plain=True)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.logits, b.logits)
