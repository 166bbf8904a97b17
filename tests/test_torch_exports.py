"""The port's public API: `repro_torch.core` and `repro_torch.net` export
every name `repro.core` and `repro.net` export, each the very object of
the port's counterpart module; importing them loads no JAX, nothing of
`repro` and no kernel, and touches no device."""
import ast
import importlib
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402
import repro.net  # noqa: E402
import repro_torch.core  # noqa: E402
import repro_torch.net  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("core", "net")


def _reference_imports(pkg: str) -> dict:
    """name -> the reference module its ``__init__`` imports it from."""
    tree = ast.parse((ROOT / "src" / "repro" / pkg / "__init__.py").read_text())
    return {a.asname or a.name: node.module for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_exports_are_the_references_names(pkg):
    ref, port = (importlib.import_module(f"{root}.{pkg}") for root in ("repro", "repro_torch"))
    assert sorted(port.__all__) == sorted(ref.__all__)
    namespace: dict = {}
    exec(f"from repro_torch.{pkg} import *", namespace)
    assert set(ref.__all__) <= set(namespace)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_each_export_is_its_port_modules_object(pkg):
    port = importlib.import_module(f"repro_torch.{pkg}")
    sources = _reference_imports(pkg)
    ref = importlib.import_module(f"repro.{pkg}")
    for name in ref.__all__:
        if name in sources:
            module = importlib.import_module(sources[name].replace("repro.", "repro_torch.", 1))
            assert getattr(port, name) is getattr(module, name), name
        else:  # a submodule the package's imports bound to it
            assert getattr(port, name) is importlib.import_module(f"repro_torch.{pkg}.{name}"), \
                name


def test_importing_the_api_loads_no_jax_no_reference_and_no_kernel():
    code = (
        "import json, sys, torch\n"
        "import repro_torch.core, repro_torch.net\n"
        "from repro_torch.kernels import build\n"
        "print(json.dumps({'modules': sorted(m for m in sys.modules if m in ('jax', 'jaxlib')\n"
        "                  or m == 'repro' or m.startswith('repro.')),\n"
        "                  'kernels': sorted(build._LOADED),\n"
        "                  'cuda': torch.cuda.is_initialized()}))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert json.loads(out.splitlines()[-1]) == {"modules": [], "kernels": [], "cuda": False}
