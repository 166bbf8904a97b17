"""The recurrent blocks' training forms (`models/ssm.py`: ``mamba``,
``mlstm``, ``slstm`` over `chunked_scan`) against the JAX package's, on the
CPU, and the memory their time chunks save.

Same weights (the reference's `init_*`, carried over by
`convert.model_params`; jamba's and xlstm's smoke widths: d 64, 4 heads)
with every f32 leaf cast to bf16, as both trainers cast them at step
entry, and the same bf16 inputs of 256 tokens (4 chunks of 64), made with
numpy from a seed.  The loss is ``sum(y * w)`` for a seeded f32 cotangent
``w``; its gradients in the input and every parameter go through
``jax.grad`` of the reference's ``ssm.mamba / mlstm / slstm``.

Tolerances, those of the tests that already hold these blocks: outputs
(bf16) within `test_torch_ssm.py`'s bf16 ``atol = rtol = 2e-2``;
gradients per leaf within `test_torch_train_zoo.py`'s 5e-2 in relative L2
(Mamba's within its jamba tolerance, 0.1: the reference's associative scan
sums in another order, and bf16 roundings downstream flip with it).

The chunked forms run the prefill forms' ops, so on one device their
outputs and gradients are equal to the prefill's under autograd (the
unchunked form), bit for bit.  The memory test counts the mLSTM's
matrix-memory-sized tensors (``[B, H, dh, dh]`` f32): those autograd saves
in the forward (``saved_tensors_hooks``), and those alive at once over the
forward and the backward (a dispatch mode that follows every storage an op
makes): one carry a chunk plus one chunk's steps, against two a step
unchunked.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from _torch_memory import LiveStorages  # noqa: E402
from _torch_zoo_reference import jax_model, one_torch_thread  # noqa: E402,F401
from repro.configs import registry as jregistry  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

BF16_TOL, GRAD_TOL = 2e-2, {"mamba": 0.1, "mlstm": 5e-2, "slstm": 5e-2}
B, S, CHUNK = 2, 256, 64
KINDS = {"mamba": "jamba-v0.1-52b", "mlstm": "xlstm-350m", "slstm": "xlstm-350m"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread a worker (`one_torch_thread`)."""
    with one_torch_thread():
        yield


def _bf16_leaves(tree_):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == np.float32 else a, tree_)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def cases(jax_model):
    """Per kind: the port's config, params (bf16 leaves), input and
    cotangent, and the reference's output and gradients (input, params)."""
    jssm = sys.modules["repro.models.ssm"]
    out = {}
    for i, (kind, arch) in enumerate(KINDS.items()):
        jcfg, cfg = jregistry.get_smoke_config(arch), registry.get_smoke_config(arch)
        params = jax.jit(lambda key, c=jcfg, k=kind: getattr(jssm, f"init_{k}")(key, c))(
            jax.random.PRNGKey(30 + i))
        params = _bf16_leaves(jax.tree.map(np.asarray, params))
        rng = np.random.default_rng(30 + i)
        x = rng.standard_normal((B, S, cfg.d_model)).astype(jnp.bfloat16)
        w = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        fwd = jax.jit(lambda p, x, c=jcfg, k=kind: getattr(jssm, k)(p, c, x))
        loss = jax.jit(jax.grad(lambda p, x, c=jcfg, k=kind: jnp.sum(
            getattr(jssm, k)(p, c, x).astype(jnp.float32) * w), argnums=(0, 1)))
        gp, gx = loss(params, x)
        out[kind] = dict(cfg=cfg, params=convert.model_params(params), x=x, w=w,
                         y=np.asarray(fwd(params, x)), gx=np.asarray(gx),
                         gp=dict(tree.paths(jax.tree.map(np.asarray, gp))))
    return out


def _run(fn, cfg, params, x, w):
    """``fn``'s output and the gradients of ``sum(y * w)`` in x and params."""
    leaves = tree.map_leaves(lambda t: t.detach().clone().requires_grad_(), params)
    xx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).requires_grad_()
    y = fn(leaves, cfg, xx)
    grads = torch.autograd.grad((y.float() * torch.from_numpy(w)).sum(),
                                [xx, *tree.leaves(leaves)])
    return y.detach(), grads[0], dict(zip([k for k, _ in tree.paths(leaves)], grads[1:]))


def _unchunked(kind):
    """The prefill form's output: the scan without checkpoints."""
    prefill = getattr(ssm, f"{kind}_prefill")
    return lambda p, cfg, x: prefill(p, cfg, x)[0]


@pytest.mark.parametrize("kind", KINDS)
def test_training_form_and_gradients_match_reference(cases, kind):
    c = cases[kind]
    y, gx, gp = _run(getattr(ssm, kind), c["cfg"], c["params"], c["x"], c["w"])
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == c["y"].shape
    np.testing.assert_allclose(y.float().numpy(), c["y"].astype(np.float32), atol=BF16_TOL,
                               rtol=BF16_TOL)
    errs = {"x": _rel_l2(gx.float().numpy(), c["gx"])}
    errs.update({k: _rel_l2(g.float().numpy(), c["gp"][k]) for k, g in gp.items()})
    assert gp.keys() == c["gp"].keys()
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL[kind], (worst, errs)


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_equals_unchunked_bit_for_bit(cases, kind):
    """4 checkpointed chunks against the prefill form under autograd."""
    c = cases[kind]
    y, gx, gp = _run(getattr(ssm, kind), c["cfg"], c["params"], c["x"], c["w"])
    y0, gx0, gp0 = _run(_unchunked(kind), c["cfg"], c["params"], c["x"], c["w"])
    assert torch.equal(y, y0) and torch.equal(gx, gx0)
    for k, g in gp.items():
        assert torch.equal(g, gp0[k]), k


@pytest.mark.parametrize("kind", KINDS)
def test_training_form_sequence_must_tile_by_its_chunk(cases, kind):
    c = cases[kind]
    x = torch.zeros((1, 96, c["cfg"].d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must tile by 64"):
        getattr(ssm, kind)(c["params"], c["cfg"], x)


def _matrix_memories(fn, cfg, params, x, w, match):
    """(storages of tensors that ``match`` saved in the forward, the most
    alive at once over the forward and backward)."""
    leaves = tree.map_leaves(lambda t: t.detach().clone().requires_grad_(), params)
    xx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).requires_grad_()
    inputs = {t.untyped_storage().data_ptr() for t in [xx, *tree.leaves(leaves)]}
    saved = set()

    def pack(t):
        if match(t):
            saved.add(t.untyped_storage().data_ptr())
        return t

    live = LiveStorages(match)
    with live:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y = fn(leaves, cfg, xx)
        torch.autograd.grad((y.float() * torch.from_numpy(w)).sum(), [xx, *tree.leaves(leaves)])
    return len(saved - inputs), live.peak


def _in_sublayer_checkpoint(p, cfg, x):
    """The training form inside a sublayer's checkpoint, as
    `transformer.run_stack_train` runs it: its recomputation runs the
    chunks' checkpoints again."""
    return checkpoint(ssm.mlstm, p, cfg, x, use_reentrant=False)


def test_chunked_mlstm_holds_a_carry_a_chunk_plus_one_chunk(cases):
    """At 256 and 512 tokens: the chunked mLSTM's forward saves the S / 64
    incoming carries' matrix memories, and its backward holds at most
    those plus one chunk's two a step (and the gradient's few), inside a
    sublayer's checkpoint too (whose recomputation keeps no chunk's
    internals); the unchunked form saves two a step, 2 S."""
    c = cases["mlstm"]
    cfg = c["cfg"]
    dh = int(cfg.xlstm_proj_factor * cfg.d_model) // cfg.n_heads
    nbytes = B * cfg.n_heads * dh * dh * 4

    def match(t):  # C, k v^T and their views
        return tuple(t.shape[-2:]) == (dh, dh) and t.untyped_storage().nbytes() == nbytes

    rng = np.random.default_rng(40)
    for n in (256, 512):
        x = rng.standard_normal((B, n, cfg.d_model)).astype(jnp.bfloat16)
        w = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
        saved, peak = _matrix_memories(ssm.mlstm, cfg, c["params"], x, w, match)
        _, nested = _matrix_memories(_in_sublayer_checkpoint, cfg, c["params"], x, w, match)
        saved0, peak0 = _matrix_memories(_unchunked("mlstm"), cfg, c["params"], x, w, match)
        assert saved == n // CHUNK, (n, saved)
        for p in (peak, nested):
            assert n // CHUNK < p <= n // CHUNK + 2 * CHUNK + 4, (n, peak, nested)
        assert saved0 >= 2 * n and peak0 >= 2 * n, (n, saved0, peak0)
