"""Linear-algebra backends for GP computations. This slice of the port
carries the O(N) :class:`QuasisepSolver`; the dense, Kalman and low-rank
solvers are ROADMAP items N3 and L2."""

__all__ = ["QuasisepSolver"]

from tinygp_tpu_torch.solvers.quasisep import QuasisepSolver
