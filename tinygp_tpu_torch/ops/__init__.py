"""Dense linear algebra and the kernel matrix: the blocked Cholesky
(:mod:`~tinygp_tpu_torch.ops.dense`), its CUDA kernels B4, B5 and B6
(:mod:`~tinygp_tpu_torch.ops.cuda_dense`), and the tiled gram builder with
its CUDA kernel B7 (:mod:`~tinygp_tpu_torch.ops.gram`)."""

from tinygp_tpu_torch.ops.dense import (
    blocked_cholesky,
    cholesky_with_fallback,
    split_matmul,
    split_syrk,
)

__all__ = [
    "blocked_cholesky",
    "cholesky_with_fallback",
    "split_matmul",
    "split_syrk",
]
