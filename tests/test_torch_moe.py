"""The port's MoE layer (`models/moe.py`) against the JAX package's `moe`,
on the CPU.

Same weights (the reference's `init_moe`, carried over by
`convert.model_params`) and the same bf16 input, made with numpy from a
seed.  Cases: dbrx's and arctic's smoke configs (4 experts top-2; 8
experts top-2); a capacity factor small enough that tokens are dropped;
duplicated token rows, so that the experts' capacity top-C meets exact
ties (the lower token index first, as ``lax.top_k``); and top-4 routing,
where a token's four rows are added in expert order with a bf16 rounding
after each add.

Tolerance: ``y`` within bf16's ``atol = rtol = 2e-2`` (tests/test_kernels.py's),
the f32 aux loss within 2e-5.  On this CPU both agree bit for bit in
these cases (bf16 products taken in f32 and rounded once, as XLA's); an
f32 exp of another library may round a gate, and so a value, to its
neighbour, which the tolerance covers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_zoo_reference import jax_model  # noqa: E402,F401
from repro.configs import registry as jregistry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import moe  # noqa: E402

BF16_TOL, F32_TOL = 2e-2, 2e-5
B, S = 2, 48


def _configs(arch, **changes):
    return (dataclasses.replace(jregistry.get_smoke_config(arch), **changes),
            dataclasses.replace(registry.get_smoke_config(arch), **changes))


def _inputs(seed, cfg, distinct=None):
    """x [B, S, D] bf16 from ``default_rng(seed)``; with ``distinct`` only
    that many different token rows, repeated."""
    rng = np.random.default_rng(seed)
    n = distinct or B * S
    rows = rng.standard_normal((n, cfg.d_model)).astype(np.float32)
    return rows[np.arange(B * S) % n].reshape(B, S, cfg.d_model).astype(jnp.bfloat16)


def _run(jax_model, arch, seed, distinct=None, exact=False, **changes):
    import sys
    jmoe = sys.modules["repro.models.moe"]
    jcfg, cfg = _configs(arch, **changes)
    params = jax.jit(lambda key: jmoe.init_moe(key, jcfg))(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    x = _inputs(seed, cfg, distinct)
    y_ref, aux_ref = jax.jit(lambda p, x: jmoe.moe(p, jcfg, x))(params, x)
    y, aux = moe.moe(convert.model_params(params), cfg, convert.model_cache({"x": x})["x"])
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    if exact:
        np.testing.assert_array_equal(y.view(torch.int16).numpy(),
                                      np.asarray(y_ref).view(np.int16))
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_ref, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), atol=F32_TOL, rtol=F32_TOL)
    return cfg, params, x, y


@pytest.mark.parametrize("arch", ["dbrx-132b", "arctic-480b"])
def test_moe_matches_reference(jax_model, arch):
    _run(jax_model, arch, 0)


def _gates(cfg, params, x):
    """The token-choice gates [T, E] (0 where a token did not choose the
    expert), routed as the layer routes them."""
    T = x.shape[0] * x.shape[1]
    xt = torch.as_tensor(np.asarray(x, np.float32)).reshape(T, -1)
    probs = torch.softmax(xt @ torch.as_tensor(params["router"]), dim=-1)
    top_w, top_ids = moe._top(probs, cfg.moe_top_k)
    return torch.zeros_like(probs).scatter_(1, top_ids, top_w / top_w.sum(-1, keepdim=True))


def test_moe_drops_tokens_over_capacity(jax_model):
    """capacity_factor 0.3: C = max(ceil(96 * 2 * 0.3 / 4), 8) = 15 slots an
    expert for 192 choices, so most choices are dropped, and y still
    matches."""
    cfg, params, x, _ = _run(jax_model, "dbrx-132b", 1, capacity_factor=0.3)
    C = moe.capacity(cfg, B * S)
    assert C == 15
    chosen = (_gates(cfg, params, x) > 0).sum(0)
    assert int(chosen.clamp(max=C).sum()) < int(chosen.sum()) == B * S * cfg.moe_top_k


def test_moe_capacity_ties_take_the_lower_token_first(jax_model):
    """Six distinct token rows repeated 16 times: every copy of a row has
    the same gate, so an expert's top-C (C = 60 of 96) cuts through exact
    ties; y matches only if the kept copies are the lower indices, as
    ``lax.top_k`` keeps them."""
    cfg, params, x, _ = _run(jax_model, "dbrx-132b", 2, distinct=6)
    C = moe.capacity(cfg, B * S)
    assert C == 60
    ranked = _gates(cfg, params, x).T.sort(dim=-1, descending=True).values   # [E, T]
    cut = (ranked[:, C - 1] > 0) & (ranked[:, C - 1] == ranked[:, C])
    assert cut.any()


def test_moe_top4_folds_in_expert_order(jax_model):
    """Top-4 of 8 experts (arctic's smoke width): a token's four gated rows
    add in ascending expert order, rounded to bf16 after each add; another
    order rounds some sums to the other neighbour, so this case is held bit
    for bit (the products and gates equal the reference's here)."""
    _run(jax_model, "arctic-480b", 3, exact=True, moe_top_k=4, capacity_factor=4.0)


def test_capacity_formula():
    cfg = registry.get_config("jamba-v0.1-52b")
    assert moe.capacity(cfg, 4 * 2048) == 1280      # ceil(8192 * 2 * 1.25 / 16)
    assert moe.capacity(cfg, 4) == 4               # never above T
    assert moe.capacity(dataclasses.replace(cfg, capacity_factor=0.01), 64) == 8


def test_routes_replay_the_recorded_choices():
    """A recorded run replayed on its own input gives the same output and
    no flips; replayed on another input, the layer takes the recorded
    choices (the tokens' experts and the experts' tokens) with that input's
    own gates, and counts where its own choices differ."""
    cfg = registry.get_smoke_config("dbrx-132b")
    g = torch.Generator().manual_seed(0)
    p = moe.init_moe(g, cfg, "cpu")
    x = torch.randn((B, S, cfg.d_model), generator=g).bfloat16()
    routes = moe.Routes()
    y, _ = moe.moe(p, cfg, x, routes)
    assert len(routes.calls) == 2 and routes.calls[0].shape == (B * S, cfg.moe_top_k)
    y2, _ = moe.moe(p, cfg, x, routes.replay())
    assert torch.equal(y, y2) and int(routes.flips) == 0 and routes.choices == B * S + 4
    other = torch.randn((B, S, cfg.d_model), generator=g).bfloat16()
    free, _ = moe.moe(p, cfg, other)
    forced, _ = moe.moe(p, cfg, other, routes.replay())
    assert int(routes.flips) > 0 and not torch.equal(free, forced)
