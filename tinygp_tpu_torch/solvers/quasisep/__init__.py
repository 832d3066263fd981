"""The O(N) quasiseparable solver, its matrix classes and its scans."""

__all__ = ["QuasisepSolver"]

from tinygp_tpu_torch.solvers.quasisep.solver import QuasisepSolver
