"""The port stands alone: it imports no JAX, no optax and nothing of the
JAX package, whose name ``tinygp_tpu`` is a prefix of the port's own."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tinygp_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def forbidden(module: str) -> bool:
    """Whether a module name is JAX or the JAX package (exact name or a
    submodule; ``tinygp_tpu_torch`` is neither)."""
    return any(
        module == name or module.startswith(name + ".")
        for name in ("jax", "jaxlib", "optax", "tinygp_tpu")
    )


def test_forbidden_matches_names_not_prefixes():
    assert forbidden("jax.numpy") and forbidden("tinygp_tpu.gp") and forbidden("optax")
    assert not forbidden("tinygp_tpu_torch") and not forbidden("jaxtyping_x")


def test_import_loads_no_jax():
    code = (
        "import sys, tinygp_tpu_torch, tinygp_tpu_torch.convert, "
        "tinygp_tpu_torch.cuda_build, tinygp_tpu_torch.fit\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'optax', 'tinygp_tpu')"
        " or m.startswith(('jax.', 'jaxlib.', 'optax.', 'tinygp_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
