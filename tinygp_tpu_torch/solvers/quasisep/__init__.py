"""The O(N) quasiseparable solver and its scans."""

__all__ = ["QuasisepSolver"]

from tinygp_tpu_torch.solvers.quasisep.solver import QuasisepSolver
