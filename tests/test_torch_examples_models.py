"""The port's serving and training examples (`examples/torch_serve_batched.py`,
`torch_train_tiny_lm.py`) against the reference library, on the CPU.

Serving: `serve` runs the reference's smoke qwen3-8b weights (its
`init_params`, carried over by `convert.model_params`) at the example's
`SMOKE` sizes, teacher-forced on the reference's greedy tokens: logits
within `tests/test_torch_model.py`'s ``atol = rtol = 5e-2``, and tokens
equal wherever the reference's top-1 / top-2 margin exceeds twice that.
Training: `train` runs the reference's weights of the example's smoke
model for 4 AdamW steps against the reference trainer's same steps:
every loss within `tests/test_torch_train.py`'s 2e-3; and through `main`
(`SMOKE_ARGV`), a run stopped at step 2 and resumed to 4 leaves final
checkpoint files equal, SHA1 for SHA1, to the straight run's.
"""
import hashlib
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_zoo_reference import jax_train, one_torch_thread  # noqa: E402,F401
from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch.serve import prompts  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL, LOSS_TOL = 5e-2, 2e-3
ARCH = "qwen3-8b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread a worker (`one_torch_thread`)."""
    with one_torch_thread():
        yield


def example(name):
    spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                  ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_batched_matches_reference(jax_train):
    ex = example("serve_batched")
    B, S, G = (ex.SMOKE[k] for k in ("batch", "prompt_len", "gen"))
    JM = jax_train.model
    jcfg, cfg = jregistry.get_smoke_config(ARCH), registry.get_smoke_config(ARCH)
    params = jax.jit(lambda k: JM.init_params(k, jcfg))(jax.random.PRNGKey(0))
    prefill = jax.jit(lambda p, b, c: JM.prefill(p, jcfg, b, c))
    decode = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jcfg, t, pos, c))
    cache = jax.jit(lambda: JM.make_cache(jcfg, B, S + G))()
    lg, cache = prefill(params, {"tokens": prompts(cfg, B, S, "cpu").numpy()}, cache)
    logits = [np.asarray(lg)]
    for g in range(G - 1):
        feed = np.argmax(logits[-1], axis=-1).astype(np.int32)
        lg, cache = decode(params, feed[:, None], np.full(B, S + g, np.int32), cache)
        logits.append(np.asarray(lg))
    want = np.stack(logits)                                     # [G, B, V]
    tokens = np.argmax(want, axis=-1).astype(np.int32).T       # [B, G]

    port = M.compute_params(convert.model_params(jax.tree.map(np.asarray, params)))
    got = ex.serve(port, cfg, B, S, G, torch.device("cpu"), forced=torch.as_tensor(tokens))
    np.testing.assert_allclose(got["logits"], want, atol=TOL, rtol=TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0] > 2 * TOL).T
    np.testing.assert_array_equal(got["tokens"][clear], tokens[clear])
    assert clear.mean() > 0.5

    cli = ex.main(["--device", "cpu", "--batch", str(B), "--prompt-len", str(S),
                   "--gen", str(G)])
    assert cli["tokens"].shape == (B, G) and cli["logits"].shape == (G, B, cfg.vocab_size)


def test_train_tiny_lm_matches_reference(jax_train, tmp_path):
    ex = example("train_tiny_lm")
    J = jax_train
    dims = ex.SMOKE_SIZES["smoke"]
    jcfg = jbase.ArchConfig(name="tiny-lm-smoke", family="dense",
                            period=(jbase.LayerSpec("attn", "mlp"),), mlp_kind="swiglu", **dims)
    steps, seq, batch = (int(ex.SMOKE_ARGV[ex.SMOKE_ARGV.index(f) + 1])
                         for f in ("--steps", "--seq-len", "--batch"))
    with jax.threefry_partitionable(False):
        params = jax.jit(lambda k: J.model.init_params(k, jcfg))(jax.random.PRNGKey(0))
    opt = J.api.make_optimizer("adamw", lr=3e-3)
    state = J.state.TrainState.create(params, opt.init(params))
    step = jax.jit(J.step.build_train_step(jcfg, opt))
    ds = jdata.SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=seq, global_batch=batch)
    want = {}
    for i in range(steps):
        state, m = step(state, jdata.host_batch(ds, i))
        want[i + 1] = float(m["loss"])

    got = ex.train(convert.model_params(jax.tree.map(np.asarray, params)),
                   ex.tiny_config("smoke", ex.SMOKE_SIZES), steps=steps, seq_len=seq,
                   batch=batch, ckpt_dir=str(tmp_path / "ref_weights"), log_every=1,
                   ckpt_every=2)
    assert got["step"] == steps and got["losses"].keys() == want.keys()
    for k, v in want.items():
        assert abs(got["losses"][k] - v) <= LOSS_TOL, (k, got["losses"][k], v)


def _sha1s(ckpt_dir: pathlib.Path) -> dict:
    step = ckpt_dir / f"step_{int((ckpt_dir / 'LATEST').read_text()):08d}"
    return {f.name: hashlib.sha1(f.read_bytes()).hexdigest() for f in sorted(step.iterdir())}


def test_train_tiny_lm_resume_equals_the_straight_run(tmp_path):
    ex = example("train_tiny_lm")
    argv = ["--device", "cpu", *ex.SMOKE_ARGV]
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    out = ex.main(argv + ["--ckpt-dir", str(straight)], **ex.SMOKE)
    assert out["step"] == 4 and sorted(out["losses"]) == [1, 2, 3, 4]
    half = list(argv)
    half[half.index("--steps") + 1] = "2"
    assert ex.main(half + ["--ckpt-dir", str(resumed)], **ex.SMOKE)["step"] == 2
    again = ex.main(argv + ["--ckpt-dir", str(resumed), "--resume"], **ex.SMOKE)
    assert again["step"] == 4 and sorted(again["losses"]) == [3, 4]
    assert again["losses"] == {k: out["losses"][k] for k in (3, 4)}
    assert _sha1s(resumed) == _sha1s(straight)
