"""The port's dense serving path against the JAX model zoo, on the CPU.

The JAX model imports `repro.dist.sharding`, which the tree does not hold.
Outside a mesh its `shard` is a no-op (`models/layers.py`), so a
module-scoped fixture puts a stub with a no-op `shard` into `sys.modules`,
imports the reference model under it and, when the module's tests end,
removes the stub and every `repro.models*` / `repro.dist*` module it
brought in.  No global JAX or torch setting is touched, and every
reference call is jitted.

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
import importlib
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import LayerSpec  # noqa: E402
from repro_torch.launch.serve import generate, prompts  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train.step import build_prefill_step  # noqa: E402

TOL = 5e-2
ARCHS = ("qwen3-8b", "h2o-danube-3-4b")
B, S, STEPS = 2, 48, 8


def _stubbed_prefix(name: str) -> bool:
    return name.split(".")[:2] in (["repro", "models"], ["repro", "dist"])


@pytest.fixture(scope="module")
def jax_model():
    """The reference's `repro.models.model`, imported under a no-op
    `repro.dist.sharding` stub that lives only as long as this fixture."""
    assert "repro.dist" not in sys.modules
    before = set(sys.modules)
    dist = types.ModuleType("repro.dist")
    sharding = types.ModuleType("repro.dist.sharding")
    sharding.shard = lambda x, *axes, **kw: x
    sharding.batch_shard_count = lambda: 1
    dist.sharding = sharding
    sys.modules["repro.dist"] = dist
    sys.modules["repro.dist.sharding"] = sharding
    try:
        yield importlib.import_module("repro.models.model")
    finally:
        for name in sorted(set(sys.modules) - before, reverse=True):
            if not _stubbed_prefix(name):
                continue
            module = sys.modules.pop(name)
            parent, _, child = name.rpartition(".")
            if getattr(sys.modules.get(parent), child, None) is module:
                delattr(sys.modules[parent], child)
        assert "repro.dist" not in sys.modules
        assert not any(_stubbed_prefix(n) for n in set(sys.modules) - before)


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
        run = generate(port_params, cfg, tokens, STEPS + 1, forced=torch.as_tensor(ref_tokens))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trips_params_and_caches(runs, arch):
    r = runs[arch]
    port = convert.model_params(r["np_params"])

    def walk(p, ref):
        assert p.keys() == ref.keys()
        for k in ref:
            if isinstance(ref[k], dict):
                walk(p[k], ref[k])
            else:
                assert p[k].dtype == torch.float32
                np.testing.assert_array_equal(p[k].numpy(), ref[k])

    walk(port, r["np_params"])
    cache = convert.model_cache(r["ref_cache_end"])
    for name in ("k", "v"):
        got = cache["sub0"][name]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      r["ref_cache_end"]["sub0"][name].view(np.int16))


def test_port_params_have_the_reference_layout(runs):
    """`init_params` from a torch.Generator builds the reference's tree:
    the same keys, shapes and dtypes (not its numbers)."""
    r = runs["qwen3-8b"]
    port = M.init_params(torch.Generator().manual_seed(0), r["cfg"])

    def walk(p, ref):
        assert p.keys() == ref.keys()
        for k in ref:
            if isinstance(ref[k], dict):
                walk(p[k], ref[k])
            else:
                assert tuple(p[k].shape) == ref[k].shape and p[k].dtype == torch.float32

    walk(port, r["np_params"])
    bf16 = M.compute_params(port)
    assert bf16["layers"]["sub0"]["mixer"]["wq"].dtype == torch.bfloat16
    assert bf16["head"] is port["head"] and bf16["embed"] is port["embed"]


def test_unported_kinds_raise():
    cfg = registry.get_smoke_config("qwen3-8b")
    gen = torch.Generator().manual_seed(0)
    for period in ((LayerSpec("mamba", "none"),), (LayerSpec("attn", "moe"),)):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 11"):
            M.init_params(gen, dataclasses.replace(cfg, period=period))
    with pytest.raises(NotImplementedError):
        M.make_cache(dataclasses.replace(cfg, kv_quant=True), 1, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        M.init_params(gen, dataclasses.replace(cfg, encoder_layers=2))
    with pytest.raises(NotImplementedError):
        M.init_params(gen, dataclasses.replace(cfg, mlp_kind="gelu"))
    # the real configs of an MoE, an xLSTM and an encoder-decoder arch
    # resolve, and their models raise until their kinds are ported
    for arch in ("dbrx-132b", "xlstm-350m", "whisper-large-v3"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 11"):
            M.init_params(gen, registry.get_config(arch))
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 11"):
            M.make_cache(registry.get_config(arch), 1, 8, device="cpu")


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
    a = generate(params, cfg, tokens, 4)
    b = generate(params, cfg, tokens, 4, plain=True)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.logits, b.logits)
