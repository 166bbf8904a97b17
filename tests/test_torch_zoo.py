"""The port's serving path for the rest of the model zoo against the JAX
model, on the CPU: the gelu MLP (starcoder2), qkv biases (qwen1.5), MoE
(dbrx, arctic with its dense branch), Mamba + attention + MoE (jamba),
mLSTM / sLSTM (xlstm), whisper's encoder-decoder, llava's patch projector,
and qwen3-8b with the int8 KV cache (``kv_quant``).

Both packages run the same weights (the reference's `init_params`, carried
over by `convert.model_params`) on the same inputs (prompts from
`prompts`, patches and frames from a numpy seed): `smoke()` of each arch,
B = 2, 48 prompt positions (llava's 8 patches among them; whisper's
encoder reads 40 frames, so its cross-attention caches are 40 long, not
the 57 `make_cache` gave them), then 8 decode steps teacher-forced with
the reference's greedy tokens.  The reference model is imported under the
`repro.dist.sharding` stub of `_torch_zoo_reference`, and every reference
call is jitted.

Tolerance.  As `test_torch_model.py`: logits, caches and states within
``atol = rtol = 5e-2``.  The port follows the reference's compiled bf16
rounding where it is systematic (bf16 products taken in f32 and rounded
once; every op of silu and gelu; the residual sums that XLA keeps in f32
inside a period; the unrounded silu product in Mamba's scan), and three
of the nine cases agree bit for bit in their logits.  XLA's f32 sin, cos,
exp and tanh differ from torch's by an ulp now and then, which rounds a
bf16 value to its neighbour, and through a few layers (and an MoE's gates)
that moves a logit by up to ~0.035 here.  An int8 cache is compared as the
values it stands for (``kv_dequantize``), since one such step moves an
entry by one quantisation step; its scales are compared directly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_zoo_reference import QUANT, configs, jax_model  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.launch.serve import generate, prompts  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train.step import build_prefill_step  # noqa: E402

TOL = 5e-2
B, S, STEPS, ENC = 2, 48, 8, 40
ARCHS = ("qwen1.5-4b", "starcoder2-3b", "dbrx-132b", "arctic-480b", "jamba-v0.1-52b",
         "xlstm-350m", "whisper-large-v3", "llava-next-mistral-7b", QUANT)


def batch_of(cfg, rng):
    """The prefill batch (numpy): prompts, and patches or frames drawn from
    ``rng`` in bf16."""
    tokens = prompts(cfg, B, S, "cpu").numpy()
    batch = {"tokens": tokens}
    if cfg.frontend == "vision_patches":
        s_img = min(cfg.prefix_tokens, S // 2)
        batch = {"tokens": tokens[:, :S - s_img],
                 "patches": rng.standard_normal((B, s_img, cfg.d_model)).astype(jnp.bfloat16)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal((B, ENC, cfg.d_model)).astype(jnp.bfloat16)
    return batch


def port_batch(batch):
    out = convert.model_cache({k: v for k, v in batch.items() if k != "tokens"})
    out["tokens"] = torch.as_tensor(batch["tokens"])
    return out


@pytest.fixture(scope="module")
def runs(jax_model):
    """Per case: the reference's and the port's logits, caches and states."""
    JM = jax_model
    out = {}
    for arch in ARCHS:
        jcfg, cfg = configs(arch)
        params = jax.jit(lambda key, c=jcfg: JM.init_params(key, c))(jax.random.PRNGKey(0))
        batch = batch_of(cfg, np.random.default_rng(1))
        prefill = jax.jit(lambda p, b, c, cfg_=jcfg: JM.prefill(p, cfg_, b, c))
        decode = jax.jit(lambda p, t, pos, c, cfg_=jcfg: JM.decode_step(p, cfg_, t, pos, c))
        cache = jax.jit(lambda c=jcfg: JM.make_cache(c, B, S + STEPS + 1))()
        lg, cache = prefill(params, batch, cache)
        ref_cache_prefill = jax.tree.map(np.asarray, cache)
        logits = [np.asarray(lg)]
        for g in range(STEPS):
            feed = np.argmax(logits[-1], axis=-1).astype(np.int32)
            lg, cache = decode(params, feed[:, None], np.full(B, S + g, np.int32), cache)
            logits.append(np.asarray(lg))
        ref_logits = np.stack(logits)
        ref_tokens = np.argmax(ref_logits, axis=-1).astype(np.int32).T  # [B, STEPS + 1]

        port_params = M.compute_params(convert.model_params(jax.tree.map(np.asarray, params)))
        pbatch = port_batch(batch)
        _, port_cache_prefill, port_prefill_logits = build_prefill_step(cfg)(
            port_params, pbatch, M.make_cache(cfg, B, S + STEPS + 1, device="cpu"))
        run = generate(port_params, cfg, pbatch, STEPS + 1, forced=torch.as_tensor(ref_tokens))
        out[arch] = dict(cfg=cfg, ref_logits=ref_logits, ref_tokens=ref_tokens,
                         ref_cache_prefill=ref_cache_prefill,
                         ref_cache_end=jax.tree.map(np.asarray, cache),
                         port_prefill_logits=port_prefill_logits,
                         port_cache_prefill=port_cache_prefill, run=run)
    return out


def _close(got, want, tol=TOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


def _caches_close(port, ref):
    """Every sublayer's cache or state: the reference's keys, shapes and
    dtypes; values within TOL (int8 entries as the values they stand for)."""
    assert port.keys() == ref.keys()
    for sub in ref:
        assert port[sub].keys() == ref[sub].keys(), sub
        for name, want in ref[sub].items():
            got = port[sub][name]
            assert tuple(got.shape) == want.shape, (sub, name)
            assert str(got.dtype).split(".")[1] == want.dtype.name, (sub, name)
            if want.dtype == np.int8:
                scale = ref[sub][f"{name}_scale"]
                got = layers.kv_dequantize(got, port[sub][f"{name}_scale"])
                want = (want.astype(np.float32) * scale[..., None])
            _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_reference(runs, arch):
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


def test_cross_attention_caches_take_the_frames_length(runs):
    """whisper's cross-attention caches hold the encoder's 40 frames after
    prefill (the reference's replace), its self-attention caches the 57
    positions `make_cache` gave them."""
    r = runs["whisper-large-v3"]
    cache = r["run"].cache
    assert cache["sub1"]["k"].shape[2] == ENC == r["ref_cache_end"]["sub1"]["k"].shape[2]
    assert cache["sub0"]["k"].shape[2] == S + STEPS + 1


def test_kv_quantize_equals_the_reference_bit_for_bit(jax_model):
    """int8 entries and f32 scales bit-equal, half-way ties included (both
    round half to even), and the dequantized cache too."""
    import sys
    jlayers = sys.modules["repro.models.layers"]
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((16, 40, 4, 32))
         * rng.uniform(1e-3, 30.0, (16, 40, 4, 1))).astype(jnp.bfloat16)
    x[0, 0, 0] = np.arange(32) - 16   # scale 16/127: several entries on a .5 tie
    x[0, 0, 1] = 0                    # the 1e-8 floor
    q_ref, s_ref = jax.jit(jlayers.kv_quantize)(x)
    q, s = layers.kv_quantize(convert.model_cache({"x": x})["x"])
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(s_ref).view(np.int32))
    deq_ref = np.asarray(jax.jit(jlayers.kv_dequantize)(q_ref, s_ref))
    deq = layers.kv_dequantize(q, s)
    np.testing.assert_array_equal(deq.view(torch.int16).numpy(), deq_ref.view(np.int16))


def test_gelu_equals_the_reference_on_every_bf16_value():
    """`gelu` rounds as the reference's compiled ``jax.nn.gelu`` on bf16:
    the same value for every finite bf16 value, up to XLA's flushing of
    denormals (inputs are taken normal; results may differ by 1.2e-38, the
    smallest normal f32, which is far below one bf16 step of any value
    above 1e-36)."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    vals = bits.view(jnp.bfloat16)
    f = vals.astype(np.float32)
    vals = vals[np.isfinite(f) & ((np.abs(f) >= np.finfo(np.float32).tiny) | (f == 0))]
    want = np.asarray(jax.jit(jax.nn.gelu)(vals))
    got = layers.gelu(convert.model_cache({"x": vals})["x"]).float().numpy()
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=0,
                               atol=np.finfo(np.float32).tiny)


def _unit_inputs(jax_model, arch, seed):
    """(reference layers module, reference / port configs, the first
    period's first-sublayer params as numpy and as the port's compute tree,
    an input x [B, S, D] in bf16)."""
    import sys
    jlayers = sys.modules["repro.models.layers"]
    jcfg, cfg = configs(arch)
    params = jax.jit(lambda key: jax_model.init_params(key, jcfg))(jax.random.PRNGKey(seed))
    sub = jax.tree.map(lambda t: np.asarray(t[0]), params["layers"])
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(jnp.bfloat16)
    return jlayers, jcfg, cfg, sub, M.compute_params(convert.model_params(sub)), x


def test_gelu_mlp_matches_reference(jax_model):
    """starcoder2's gelu MLP (``w_up``, ``w_down``, no gate) against the
    reference's `mlp` on the same input."""
    jlayers, jcfg, cfg, sub, port, x = _unit_inputs(jax_model, "starcoder2-3b", 2)
    assert set(sub["sub0"]["ffn"]) == {"w_up", "w_down"}
    want = jax.jit(lambda p, x: jlayers.mlp(p, jcfg, x))(sub["sub0"]["ffn"], x)
    got = layers.mlp(port["sub0"]["ffn"], cfg, convert.model_cache({"x": x})["x"])
    assert got.dtype == torch.bfloat16
    _close(got, want)


def test_cross_attention_matches_reference(jax_model):
    """Cross-attention (Sq 48 != Sk 40, no RoPE, non-causal) against the
    reference's `attention(..., kv=)`, with whisper's weights."""
    jlayers, jcfg, cfg, sub, port, x = _unit_inputs(jax_model, "whisper-large-v3", 3)
    rng = np.random.default_rng(3)
    kv = [rng.standard_normal((B, ENC, cfg.n_kv_heads, cfg.head_dim)).astype(jnp.bfloat16)
          for _ in range(2)]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want = jax.jit(lambda p, x, k, v: jlayers.attention(p, jcfg, x, pos, causal=False,
                                                        rotary=False, kv=(k, v)))(
        sub["sub1"]["mixer"], x, *kv)
    t = convert.model_cache({"x": x, "k": kv[0], "v": kv[1]})
    got, k, v = layers.attention(port["sub1"]["mixer"], cfg, t["x"], torch.as_tensor(pos),
                                 rotary=False, kv=(t["k"], t["v"]))
    assert k is t["k"] and v is t["v"]
    _close(got, want)


def test_encoder_matches_reference(jax_model):
    """whisper's encoder (frame projection, sinusoidal signal, non-causal
    self-attention with RoPE, MLP, final norm) against the reference's
    `_encode` on 40 frames."""
    jcfg, cfg = configs("whisper-large-v3")
    params = jax.jit(lambda key: jax_model.init_params(key, jcfg))(jax.random.PRNGKey(4))
    frames = np.random.default_rng(4).standard_normal((B, ENC, cfg.d_model)).astype(
        jnp.bfloat16)
    want = jax.jit(lambda p, f: jax_model._encode(p, jcfg, f))(params, frames)
    port = M.compute_params(convert.model_params(jax.tree.map(np.asarray, params)))
    got = M._encode(port, cfg, convert.model_cache({"f": frames})["f"], plain=False)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _close(got, want)


def test_sinusoidal_matches_reference(jax_model):
    pos = np.broadcast_to(np.arange(1500, dtype=np.int32), (2, 1500)).copy()
    want = jax.jit(lambda p: jax_model._sinusoidal(p, 64))(pos)
    got = M._sinusoidal(torch.as_tensor(pos), 64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)

