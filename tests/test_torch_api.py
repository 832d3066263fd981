"""The port's namespaces against the JAX package's: the names each
package's ``__init__`` binds for its users, and each subpackage's
``__all__``, match, except those ROADMAP.md lists as not to port or as
queued."""

import ast
import importlib
import pathlib

import pytest

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


# ROADMAP.md, queue A: names still to port, and subpackages still to port
# as a whole (none of either).
QUEUED: set[str] = set()
QUEUED_SUBPACKAGES: set[str] = set()


def declared_all(module: str) -> set[str] | None:
    """The names of ``__all__`` in the file of ``module`` (dotted, from the
    repository root), or None where it declares none."""
    path = ROOT / module.replace(".", "/")
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets
        ):
            return set(ast.literal_eval(node.value))
    return None


def subpackages(package: str) -> list[str]:
    """Dotted names of ``package``'s subpackages, below the root."""
    root = ROOT / package
    return sorted(
        ".".join(p.parent.relative_to(ROOT).parts[1:])
        for p in root.rglob("__init__.py")
        if p.parent != root
    )


# Modules whose ``__all__`` the subpackages' own do not reach.
MODULES = [
    "kernels.quasisep",
    "parallel.mesh",
    "parallel.scan",
    "parallel.dense",
    "parallel.sharded",
    "utils.checkpoint",
]


@pytest.mark.parametrize("sub", subpackages("tinygp_tpu") + MODULES)
def test_subpackage_all_matches_the_jax_package(sub):
    """Each subpackage's (and each of MODULES') ``__all__`` is the
    reference's, less what is not to port or queued; a queued subpackage is
    absent from the port."""
    want = declared_all(f"tinygp_tpu.{sub}")
    if sub.split(".")[0] in QUEUED_SUBPACKAGES or want is None:
        port = ROOT / "tinygp_tpu_torch" / sub.replace(".", "/")
        assert not port.exists() or declared_all(f"tinygp_tpu_torch.{sub}") is None
        return
    got = declared_all(f"tinygp_tpu_torch.{sub}")
    assert got == want - NOT_TO_PORT - QUEUED
    module = importlib.import_module(f"tinygp_tpu_torch.{sub}")
    assert all(hasattr(module, name) for name in got)


def test_test_utils_exports_the_jax_package_names():
    from tinygp_tpu_torch import test_utils

    want = declared_all("tinygp_tpu.test_utils")
    assert want <= declared_all("tinygp_tpu_torch.test_utils")
    assert all(hasattr(test_utils, name) for name in want)


@pytest.mark.parametrize("scale", [1.0, 1.0 + 1e-9, 1.0 + 1e-3])
def test_assert_pytrees_allclose_agrees_with_the_jax_package(scale):
    """Over nested dicts, lists and tuples, the port's assertion passes and
    fails where the reference's does, on the same float64 numpy leaves."""
    import numpy as np

    from tinygp_tpu import test_utils as jtu
    from tinygp_tpu_torch import test_utils as ttu

    rng = np.random.default_rng(0)
    tree = {"a": [rng.normal(size=3), (rng.normal(size=(2, 2)), 1.5)], "b": {"c": rng.normal()}}
    other = {"a": [tree["a"][0] * scale, (tree["a"][1][0], 1.5)], "b": {"c": tree["b"]["c"]}}
    outcomes = []
    for check in (jtu.assert_pytrees_allclose, ttu.assert_pytrees_allclose):
        try:
            check(other, tree)
            outcomes.append(True)
        except AssertionError:
            outcomes.append(False)
    assert outcomes[0] == outcomes[1] == (scale < 1.0 + 1e-6)
    with pytest.raises(AssertionError):
        ttu.assert_pytrees_allclose({"a": tree["a"]}, tree)
