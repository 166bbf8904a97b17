"""The port's checkpoints: the JAX package's `test_ckpt.py` cases, ported
(atomicity, integrity, async, gc, resume, re-placing by a template),
and both directions of cross-restore with the reference's checkpoints of
the same training state at smoke size (qwen3-8b, AdamW and Adafactor).
Restored arrays are compared bit for bit.

The reference trainer's state is built under the `jax_train` fixture's
stubs (`_torch_zoo_reference`); its checkpoint module needs none.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_zoo_reference import jax_train, one_torch_thread  # noqa: E402,F401
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, host_batch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.api import make_optimizer  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread a worker (`one_torch_thread`)."""
    with one_torch_thread():
        yield


def _tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": [torch.ones((2,)), torch.zeros((5,), dtype=torch.bfloat16)],
    }


def _bits(t) -> np.ndarray:
    if torch.is_tensor(t):
        t = t.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _equal(a, b) -> bool:
    return _bits(a).dtype.itemsize == _bits(b).dtype.itemsize and np.array_equal(_bits(a),
                                                                                 _bits(b))


def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(t, str(tmp_path), 3)
    r = ckpt.restore(str(tmp_path), t)
    for a, b in zip(tree.leaves(t), tree.leaves(r)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4):
        ckpt.save(t, str(tmp_path), s)
    assert ckpt.latest_step(str(tmp_path)) == 4
    ckpt.gc_checkpoints(str(tmp_path), keep_last=2)
    left = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert left == ["step_00000003", "step_00000004"]


def test_async_save_snapshots_the_tree(tmp_path):
    """The write happens in a thread from a host copy taken at the call:
    changing the tree afterwards does not change the checkpoint."""
    t = _tree()
    th = ckpt.save_async(t, str(tmp_path), 9)
    t["params"]["w"].add_(100.0)
    th.join()
    assert ckpt.latest_step(str(tmp_path)) == 9
    r = ckpt.restore(str(tmp_path), t)
    assert torch.equal(r["params"]["w"], torch.arange(12, dtype=torch.float32).reshape(3, 4))


def test_atomicity_stale_tmp_ignored(tmp_path):
    """A crashed half-write (.tmp dir) does not corrupt the store."""
    t = _tree()
    ckpt.save(t, str(tmp_path), 1)
    os.makedirs(tmp_path / "step_00000002.tmp")  # simulated crash
    assert ckpt.latest_step(str(tmp_path)) == 1
    r = ckpt.restore(str(tmp_path), t)
    assert int(r["step"]) == 7
    ckpt.gc_checkpoints(str(tmp_path), keep_last=1)
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_checksum_verification(tmp_path):
    t = _tree()
    path = ckpt.save(t, str(tmp_path), 5)
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        man = json.load(f)
    k = next(iter(man["arrays"]))
    man["arrays"][k]["sha1"] = "0" * 40
    with open(mpath, "w") as f:
        json.dump(man, f)
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), t)
    assert ckpt.restore(str(tmp_path), t, verify=False) is not None


def test_restore_places_by_the_template(tmp_path):
    """The elastic case on one host: a checkpoint restores into any
    template of the tree's structure, each leaf on its template leaf's
    device, with the checkpoint's shapes and dtypes (the reference
    re-places it under another mesh's shardings)."""
    t = _tree()
    ckpt.save(t, str(tmp_path), 1)
    template = tree.map_leaves(lambda x: torch.empty(0, dtype=torch.int8), t)
    r = ckpt.restore(str(tmp_path), template)
    for a, b in zip(tree.leaves(t), tree.leaves(r)):
        assert b.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a, b)


def test_resume_training_state(tmp_path):
    """Save mid-run, restore, and the next step is the uninterrupted run's,
    bit for bit (the data pipeline needs no state)."""
    cfg = registry.get_smoke_config("starcoder2-3b")
    opt = make_optimizer("adamw", lr=1e-3)
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    state = TrainState.create(params, opt.init(params))
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    step = build_train_step(cfg, opt)
    for i in range(3):
        state, _ = step(state, host_batch(ds, i, device="cpu"))
    ckpt.save(state, str(tmp_path), int(state.step))
    restored = ckpt.restore(str(tmp_path), state)
    state_a, _ = step(state, host_batch(ds, 3, device="cpu"))
    state_b, _ = step(restored, host_batch(ds, int(restored.step), device="cpu"))
    for a, b in zip(tree.leaves(state_a), tree.leaves(state_b)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def reference_states(jax_train):
    """The reference's qwen3-8b smoke TrainState after one step, with AdamW
    and with Adafactor (numpy leaves), and a bf16 leaf among the params."""
    J = jax_train
    cfg = jregistry.get_smoke_config("qwen3-8b")
    out = {}
    for name in ("adamw", "adafactor"):
        opt = J.api.make_optimizer(name, lr=1e-3)
        with jax.threefry_partitionable(False):
            params = jax.jit(lambda k: J.model.init_params(k, cfg))(jax.random.PRNGKey(0))
        params["final_norm"] = params["final_norm"].astype(jnp.bfloat16)
        state = J.state.TrainState.create(params, opt.init(params))
        ds = jax_data_batch(cfg)
        state, _ = jax.jit(J.step.build_train_step(cfg, opt))(state, ds)
        out[name] = state
    return out


def jax_data_batch(cfg):
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.data.pipeline import host_batch as jhost_batch

    return jhost_batch(JSyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4), 0)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_port_restores_the_reference_checkpoint(reference_states, tmp_path, name):
    state = reference_states[name]
    jckpt.save(state, str(tmp_path), 1)
    host = jax.tree.map(np.asarray, state)
    template = convert.train_state(host)
    got = ckpt.restore(str(tmp_path), template)
    keys = [k for k, _ in tree.paths(got)]
    assert keys == list(jckpt._flatten(state))
    for (key, a), b in zip(tree.paths(got), jax.tree.leaves(host)):
        assert _equal(a, b), key
    assert got.step.dtype == torch.int32 and int(got.step) == 1


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_reference_restores_the_port_checkpoint(reference_states, tmp_path, name):
    state = reference_states[name]
    host = jax.tree.map(np.asarray, state)
    port = convert.train_state(host)
    path = ckpt.save(port, str(tmp_path), 1)
    tmpl = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
    got = jckpt.restore(str(tmp_path), tmpl)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(host)):
        assert a.dtype == b.dtype and _equal(a, b)
    with open(os.path.join(path, "manifest.json")) as f:
        port_manifest = json.load(f)
    ref_path = jckpt.save(state, str(tmp_path / "ref"), 1)
    with open(os.path.join(ref_path, "manifest.json")) as f:
        assert json.load(f) == port_manifest
