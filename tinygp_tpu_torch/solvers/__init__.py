"""Linear-algebra backends for GP computations. The port carries the O(N)
:class:`QuasisepSolver` and its quasiseparable matrix algebra
(``solvers.quasisep``); the dense, Kalman and low-rank solvers are ROADMAP
items N3 and L2."""

__all__ = ["QuasisepSolver"]

from tinygp_tpu_torch.solvers.quasisep import QuasisepSolver
