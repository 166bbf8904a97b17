"""The JAX model zoo as the port's tests run it (not a test module).

The reference model imports `repro.dist.sharding`, which the tree does not
hold.  Outside a mesh its `shard` is a no-op (`models/layers.py`), so the
`jax_model` fixture puts a stub with a no-op `shard` (and one data group,
`batch_shard_count() == 1`) into `sys.modules`, imports the reference
model under it and, when the importing module's tests end, removes the
stub and every `repro.models*` / `repro.dist*` module it brought in.  The
reference trainer (`repro.train.step`) also imports
`repro.dist.sprayed_collectives`: the stub holds that module too, whose
functions raise if called, and the `jax_train` fixture imports the
trainer under it; `repro.train*` and `repro.launch.train` are removed with
the rest, so nothing leaks into `test_train.py`'s
``importorskip("repro.dist")``.  A test module takes a fixture with
``from _torch_zoo_reference import jax_model`` (or ``jax_train``); pytest
scopes it to that module.  `reference_zoo` is the context both fixtures
run in.  `configs` names the zoo's cases for both packages.

`one_torch_thread` runs a module's tests with one torch intra-op thread
(restored after): the suite runs six workers on the machine's cores, and
six processes of one thread each run a smoke model's training step ~80x
faster than six of eight threads each, which spin against one another.
"""
import contextlib
import dataclasses
import importlib
import sys
import types

import pytest

from repro.configs import registry as jregistry
from repro_torch.configs import registry

# the int8 KV cache: qwen3-8b's smoke config with ``kv_quant``
QUANT = "qwen3-8b+kv_quant"


def configs(case: str):
    """(reference config, port config) of a case: an arch's smoke config,
    or `QUANT`."""
    name = case.split("+")[0]
    jcfg, cfg = jregistry.get_smoke_config(name), registry.get_smoke_config(name)
    if case == QUANT:
        jcfg, cfg = (dataclasses.replace(c, kv_quant=True) for c in (jcfg, cfg))
    return jcfg, cfg


def _stubbed_prefix(name: str) -> bool:
    parts = name.split(".")
    return (parts[:2] in (["repro", "models"], ["repro", "dist"], ["repro", "train"])
            or parts[:3] == ["repro", "launch", "train"])


def _refuse(*args, **kwargs):
    raise RuntimeError("repro.dist is a test stub: the port's tests never call it")


@contextlib.contextmanager
def reference_zoo():
    """Import-time stubs of `repro.dist.sharding` (no-op `shard`, one data
    group) and `repro.dist.sprayed_collectives` (raising), removed on exit
    with every `repro.models*`, `repro.dist*`, `repro.train*` and
    `repro.launch.train` module imported meanwhile."""
    assert "repro.dist" not in sys.modules
    before = set(sys.modules)
    dist = types.ModuleType("repro.dist")
    sharding = types.ModuleType("repro.dist.sharding")
    sharding.shard = lambda x, *axes, **kw: x
    sharding.batch_shard_count = lambda: 1
    sprayed = types.ModuleType("repro.dist.sprayed_collectives")
    sprayed.route_schedule = sprayed.sprayed_psum = _refuse
    dist.sharding, dist.sprayed_collectives = sharding, sprayed
    sys.modules["repro.dist"] = dist
    sys.modules["repro.dist.sharding"] = sharding
    sys.modules["repro.dist.sprayed_collectives"] = sprayed
    try:
        yield
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
def jax_model():
    """The reference's `repro.models.model`, imported under the stubs of
    `reference_zoo`, which live only as long as this fixture."""
    with reference_zoo():
        yield importlib.import_module("repro.models.model")


@pytest.fixture(scope="module")
def jax_train():
    """The reference's model, trainer, train state and optimizer facade
    (`types.SimpleNamespace` of modules: ``model``, ``step``, ``state``,
    ``api``), imported under the stubs of `reference_zoo`."""
    with reference_zoo():
        yield types.SimpleNamespace(**{
            k: importlib.import_module(f"repro.{m}") for k, m in (
                ("model", "models.model"), ("step", "train.step"), ("state", "train.state"),
                ("api", "optim.api"))})


@contextlib.contextmanager
def one_torch_thread():
    """torch's intra-op threads set to one, restored on exit."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
