"""sed_tpu_torch stands alone: it imports neither JAX nor anything of sed_tpu,
nor msgpack (the card's host has no such package; the port reads sed_tpu's
msgpack checkpoints with its own decoder)."""

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "sed_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "chex", "msgpack", "sed_tpu"}


def port_sources():
    return sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_top_levels(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_sed_tpu():
    sources = port_sources()
    assert len(sources) > 10
    for path in sources:
        bad = FORBIDDEN.intersection(imported_top_levels(path))
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_every_module_imports_with_jax_unimportable():
    script = f"""
import importlib, pkgutil, sys
for name in {sorted(FORBIDDEN)!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(REPO)!r})
import sed_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sed_tpu_torch.__path__, "sed_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15


def test_no_source_reaches_into_sed_tpus_native_directory():
    """The native reader is built from the port's own copy of its source
    (``sed_tpu_torch/io/csrc``): no string in the port names the repository's
    ``native/`` directory or its library."""
    for path in port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                v = node.value
                assert not (v == "native" or v.startswith("native/") or "/native/" in v
                            or "libsed_native.so" in v or "native/Makefile" in v), (
                    f"{path.relative_to(REPO)}: {v[:80]!r}")
