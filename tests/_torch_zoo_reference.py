"""The JAX model zoo as the port's tests run it (not a test module).

The reference model imports `repro.dist.sharding`, which the tree does not
hold.  Outside a mesh its `shard` is a no-op (`models/layers.py`), so the
`jax_model` fixture puts a stub with a no-op `shard` (and one data group,
`batch_shard_count() == 1`) into `sys.modules`, imports the reference
model under it and, when the importing module's tests end, removes the
stub and every `repro.models*` / `repro.dist*` module it brought in.  A
test module takes the fixture with ``from _torch_zoo_reference import
jax_model``; pytest scopes it to that module.  `configs` names the zoo's
cases for both packages.
"""
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
