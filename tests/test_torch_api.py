"""The port's root namespace against the JAX package's: the names each
package's ``__init__`` binds for its users match, except those ROADMAP.md
lists as not to port."""

import ast
import pathlib

import tinygp_tpu
import tinygp_tpu_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

# ROADMAP.md, "Not to port": numpyro_support (numpyro is JAX-only),
# solvers/quasisep/pallas_gate.py, solvers/quasisep/block.py and the JAX
# pytree system utils/module.py.
NOT_TO_PORT = {"numpyro_support", "pallas_gate", "block", "module", "Module"}


def bound_names(package: str) -> set[str]:
    """Public names bound at the top level of ``<package>/__init__.py``."""
    tree = ast.parse((ROOT / package / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom | ast.Import):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_root_names_match_the_jax_package():
    assert bound_names("tinygp_tpu_torch") == bound_names("tinygp_tpu") - NOT_TO_PORT


def test_root_names_resolve():
    for name in bound_names("tinygp_tpu"):
        if name not in NOT_TO_PORT:
            assert hasattr(tinygp_tpu, name) and hasattr(tinygp_tpu_torch, name), name


def test_condition_result_is_exported():
    from tinygp_tpu_torch.gp import ConditionResult

    assert tinygp_tpu_torch.ConditionResult is ConditionResult
    assert tinygp_tpu_torch.ConditionResult._fields == tinygp_tpu.ConditionResult._fields
