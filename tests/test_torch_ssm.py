"""The port's recurrent blocks (`models/ssm.py`: Mamba, mLSTM, sLSTM)
against the JAX package's, on the CPU.

Same weights (the reference's `init_*`, carried over by
`convert.model_params`; jamba's and xlstm's smoke widths) and the same
bf16 inputs, made with numpy from a seed.  Held: the prefill outputs and
final states, a decode step from the reference's state, and the port's
prefill then decode equal to its longer prefill.

Scan form.  The reference scans Mamba with an ``associative_scan`` inside
each chunk; the port scans by a plain loop over time in f32, and runs the
reference's own step for mLSTM and sLSTM.  Tolerance: states (f32) within
tests/test_kernels.py's f32 ``atol = rtol = 2e-5``; the bf16 outputs within
its bf16 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_zoo_reference import jax_model  # noqa: E402,F401
from repro.configs import registry as jregistry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

F32_TOL, BF16_TOL = 2e-5, 2e-2
B = 2
# kind -> (arch whose smoke width it takes, prompt length): Mamba's S must
# tile by min(64, S)
KINDS = {"mamba": ("jamba-v0.1-52b", 32), "mlstm": ("xlstm-350m", 24),
         "slstm": ("xlstm-350m", 24)}


def _close(got, want, tol):
    want = want.float().numpy() if torch.is_tensor(want) else np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def cases(jax_model):
    """Per kind: configs, numpy and port params, inputs, and the reference's
    prefill (x[:, :S]) and decode (x[:, S]) results."""
    import sys
    jssm = sys.modules["repro.models.ssm"]
    out = {}
    for i, (kind, (arch, S)) in enumerate(KINDS.items()):
        jcfg, cfg = jregistry.get_smoke_config(arch), registry.get_smoke_config(arch)
        params = jax.jit(lambda key, c=jcfg, k=kind: getattr(jssm, f"init_{k}")(key, c))(
            jax.random.PRNGKey(10 + i))
        params = jax.tree.map(np.asarray, params)
        x = np.random.default_rng(i).standard_normal((B, S + 1, cfg.d_model)).astype(
            jnp.bfloat16)
        y, state = jax.jit(lambda p, x, c=jcfg, k=kind: getattr(jssm, f"{k}_prefill")(p, c, x))(
            params, x[:, :S])
        y1, state1 = jax.jit(lambda p, x, s, c=jcfg, k=kind: getattr(jssm, f"{k}_decode")(
            p, c, x, s))(params, x[:, S:], state)
        y_long, state_long = jax.jit(
            lambda p, x, c=jcfg, k=kind: getattr(jssm, f"{k}_prefill")(p, c, x))(params, x)
        out[kind] = dict(
            cfg=cfg, S=S, x=convert.model_cache({"x": x})["x"],
            params=M.compute_params(convert.model_params(params)),
            ref=(np.asarray(y), jax.tree.map(np.asarray, state)),
            ref_decode=(np.asarray(y1), jax.tree.map(np.asarray, state1)),
            ref_long=(np.asarray(y_long), jax.tree.map(np.asarray, state_long)))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_output_and_state_match_reference(cases, kind):
    c = cases[kind]
    y, state = getattr(ssm, f"{kind}_prefill")(c["params"], c["cfg"], c["x"][:, :c["S"]])
    y_ref, state_ref = c["ref"]
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == y_ref.shape
    _close(y, y_ref, BF16_TOL)
    assert state.keys() == state_ref.keys()
    for name, want in state_ref.items():
        assert str(state[name].dtype).split(".")[1] == want.dtype.name
        _close(state[name], want, F32_TOL if want.dtype == np.float32 else BF16_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_continues_the_reference_state(cases, kind):
    c = cases[kind]
    state = convert.model_cache(c["ref"][1])
    y, state = getattr(ssm, f"{kind}_decode")(c["params"], c["cfg"], c["x"][:, c["S"]:], state)
    y_ref, state_ref = c["ref_decode"]
    _close(y, y_ref, BF16_TOL)
    for name, want in state_ref.items():
        _close(state[name], want, F32_TOL if want.dtype == np.float32 else BF16_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_then_decode_equals_the_longer_prefill(cases, kind):
    """S tokens of prefill and one of decode leave the state and last
    output of S + 1 tokens of prefill (Mamba then scans one chunk of 33 steps).

    For Mamba this holds only as far as it holds in the reference: its
    compiled prefill scans silu's product unrounded and its decode step
    rounds it to bf16 (the port follows both), so the two states differ by
    a bf16 rounding of the last step's input.  The port's two states must
    differ as the reference's do, to f32 rounding."""
    c = cases[kind]
    S, p, cfg, x = c["S"], c["params"], c["cfg"], c["x"]
    _, state = getattr(ssm, f"{kind}_prefill")(p, cfg, x[:, :S])
    y1, state1 = getattr(ssm, f"{kind}_decode")(p, cfg, x[:, S:], state)
    y_long, state_long = getattr(ssm, f"{kind}_prefill")(p, cfg, x)
    _close(y1, y_long[:, S:], BF16_TOL)
    for name, want in state_long.items():
        if want.dtype != torch.float32:
            _close(state1[name], want, BF16_TOL)
        elif kind == "mamba":
            ref_gap = c["ref_decode"][1][name] - c["ref_long"][1][name]
            _close(state1[name] - want, ref_gap, F32_TOL)
            _close(state1[name], want, BF16_TOL)
        else:
            _close(state1[name], want, F32_TOL)


def test_mamba_prefill_over_two_chunks_matches_reference(jax_model, cases):
    """128 tokens: two chunks of 64, the state carried from one to the next."""
    import sys
    jssm = sys.modules["repro.models.ssm"]
    c = cases["mamba"]
    jcfg = jregistry.get_smoke_config(KINDS["mamba"][0])
    params = jax.jit(lambda key: jssm.init_mamba(key, jcfg))(jax.random.PRNGKey(20))
    x = np.random.default_rng(20).standard_normal((B, 128, jcfg.d_model)).astype(jnp.bfloat16)
    y_ref, state_ref = jax.jit(lambda p, x: jssm.mamba_prefill(p, jcfg, x))(params, x)
    port = M.compute_params(convert.model_params(jax.tree.map(np.asarray, params)))
    y, state = ssm.mamba_prefill(port, c["cfg"], convert.model_cache({"x": x})["x"])
    _close(y, y_ref, BF16_TOL)
    _close(state["h"], state_ref["h"], F32_TOL)
    _close(state["conv"], state_ref["conv"], BF16_TOL)


def test_mamba_sequence_must_tile_by_its_chunk(cases):
    c = cases["mamba"]
    with pytest.raises(ValueError, match="must tile by 64"):
        ssm.mamba_prefill(c["params"], c["cfg"], torch.zeros((1, 96, c["cfg"].d_model),
                                                              dtype=torch.bfloat16))


def test_softplus_is_logaddexp():
    x = torch.linspace(-100, 100, 2001)
    want = np.asarray(jax.jit(jax.nn.softplus)(x.numpy()))
    np.testing.assert_allclose(ssm.softplus(x).numpy(), want, atol=F32_TOL, rtol=F32_TOL)
