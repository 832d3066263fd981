"""Dense linear algebra: the blocked Cholesky (:mod:`~tinygp_tpu_torch.ops.dense`)
and its CUDA kernels B4, B5 and B6 (:mod:`~tinygp_tpu_torch.ops.cuda_dense`)."""
