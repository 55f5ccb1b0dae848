"""Package boundary of the port: no module under ``src/repro_torch/`` and
not ``chip_smoke.py`` imports ``jax`` or anything of the JAX package
``repro`` (the card's machine has neither), found by an AST scan of every
import statement."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
SCANNED = PORT_FILES + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_has_modules_to_scan():
    assert len(PORT_FILES) > 20
    assert (ROOT / "chip_smoke.py").exists()
    # the tensor- and sequence-parallel serving package is scanned too
    names = {p.name for p in PORT_FILES if p.parent.name == "distributed"}
    assert {"__init__.py", "meshes.py", "comm.py", "sharding.py",
            "launch.py"} <= names


def test_sharded_training_modules_are_scanned():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES}
    assert {"distributed/zero.py", "distributed/compression.py",
            "distributed/pipeline.py", "launch/mesh.py",
            "train/steps.py"} <= names


@pytest.mark.parametrize("path", SCANNED,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import masks\n"
                 "import repro_torch\nfrom repro_torch.core import masks\n")
    assert [n for n in _imported_modules(f) if _forbidden(n)] == \
        ["jax.numpy", "repro.core"]
