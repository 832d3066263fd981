"""Drive the PyTorch port on one CUDA card and check it end to end.

Run from the root of the repository, on a machine with one NVIDIA card and
``nvcc``::

    python3 chip_smoke.py

Phases, each printing its numbers on lines of its own:

1. the card's name and power limit; the build of every CUDA kernel, and
   ``nvcc -Xptxas -v``'s registers, shared memory and spills of each
   kernel of ``csrc/dense_tc.cu`` (with its GEMM's tiles, stages and
   dynamic shared memory), ``dense_syrk.cu`` and the B1-B2 sources
   ``quasisep_loglik_bwd.cu``, ``quasisep_loglik_generic.cu`` and
   ``quasisep_loglik_wide.cu``;
2. each kernel against its plain PyTorch version on random operands
   (m = 1..4, and 5, 8, 9, 16, 20, 24 and 32 through the generic-order
   sources, at N = 17,161 in float64 and float32; m = 1..4 at N = 1e5 in
   both; m = 2 at N = 1e6 in both): B1 (the log-likelihood),
   B1r (with the residuals a gradient needs) and B2 (the backward, on
   B1r's residuals, with random scalar cotangents; a second launch equal
   bit for bit); at m <= 4, 5 and 9 also B1 and B1r against their one
   launch's association in plain PyTorch, each repeated bit for bit.
   Before it, the process's first ``torch.profiler`` traces: a B1 and a
   B1r call at m = 1..4 and 5, 9, 16, 20, 32 (N = 1e5, above 16
   N = 17,161; float32 and float64) are one kernel and one memset each,
   and so is each B3 scan at
   m = 1..4 (N = 17,161: the affine scan with 1 and 16 columns, the
   congruence, the Riccati flow, the coupling), each coupling (2, 4),
   (4, 8), (6, 6), (8, 8), and at m = 5, 8, 12 and 16 the Riccati flow,
   the affine scan with 1 and 16 columns and the reverse congruence scan,
   and a B2 call at m = 9, 12, 16, 20 and 32; the main path's,
   gradient path's and trainer's calls below are traced too (no other
   kernel, no more than one launch a call);
3. the kernel path's ``log_probability`` and its float64 gradient against
   a dense numpy/scipy Cholesky log-likelihood built from the kernels'
   closed forms and its central differences;
4. the forward main path at full size in float32, as ``bench.py`` runs
   it: ``GaussianProcess(kernel, X, diag=0.1, assume_sorted=True)
   .log_probability(y)`` for Matern32 at N = 1e5 and 1e6, the flagship SHO
   and the 2-term celerite at N = 1e5, with the kernel launches counted
   over each call, and CUDA-event timings of the whole call, of the
   constructor alone, of the kernel alone and of the plain version;
5. the gradient main path: ``bench.py``'s gradient of the Matern32
   log-likelihood with respect to ``amp`` and ``scale`` at N = 1e5 and
   1e6 in float32, against the float64 kernel gradient and the float32
   plain one, and held to the float64 kernels run on the same float32
   operands, with launches counted and CUDA-event timings of the whole
   forward and backward, of B1r, of B2 and of their plain versions; B2
   repeated bit for bit, and one kernel and one memset per call in a
   ``torch.profiler`` trace;
6. the trainer: 20 Adam steps of ``fit_map`` on the Matern32 model's log
   hyperparameters at N = 1e5 and 1e6 in float32, with one B1r and one B2
   launch per step;
7. kernel B3, the generic monoid scan, against its plain version on random
   operands for every monoid (affine forward and reverse, exclusive and
   inclusive, with 1 and 8 columns; congruence forward and reverse; the
   Riccati flow; the coupling forward and reverse), m = 1..4 at N = 17,161
   in float64 and float32 and m = 2 at N = 1e6; and the generic-order
   source at m = 5, 8, 12 and 16 (every monoid, both directions and
   outputs, 1 and 8 columns), the congruence at every m = 5..16 in both
   directions and the couplings (2, 4), (4, 8) and (6, 6), at N = 17,161
   in float64 and float32, with its launches counted and each one-launch
   kernel's second launch equal bit for bit;
8. conditioning at the light-curve example's size
   (``examples/quasisep_lightcurve.py:23-77``): ``condition(y)`` and
   ``predict(y, t_test)`` of ``1.0 * SHO(omega=2.1, quality=2.0)`` on the
   example's data thinned to N = 5000, in float32 (finite, positive
   variances) and in float64 against a dense numpy/scipy posterior built
   from SHO's closed form;
9. the conditioning main path at ``bench.py``'s headline data
   (Matern32, N = 1e5, float32): ``condition(y)``, ``predict(y, X_test)``
   at 1000 points and ``sample(generator, (16,))``, with B3's launches by
   monoid counted over the run and no plain scan on the card; the log
   probability against B1's; the float64 variance on the card against the
   float64 plain version on the CPU; the float32 mean and variance (the
   float64 twin's, C8) within 5e-4 of the card's float64 ones, none
   negative; CUDA-event times of each entry point,
   and of B3 per monoid at the path's shapes beside its bound and its
   plain version;
10. the dense path's kernels against their plain versions in float64 on
    the same values: B5 (the panel product at both orders, at the blocked
    Cholesky's offsets and with a ragged row count), B4 with and without
    its row side products (in place, on the lower triangle, T outside its
    lower tiles unchanged bit for bit, the side products bit for bit
    against ``plain_row_sums``) at each of the 19 trailing sizes of
    N = 1e4 at block 512, and B6 at ``benchmarks/dense_micro.py``'s shapes,
    each timed beside its bound, its plain version and the library call
    (``matmul``, a float64 ``matmul`` for B5's 3-term order, ``addmm``),
    with the ratio of the sums; the split pass bit for bit against
    ``split_pieces`` (the panels, W^T read through its strides, L), and B5,
    B4 and B6 within 1e-6 of ``plain_split_dots``, the float64 sum of the
    same exact piece products, with their signed mean error;
11. the dense main path at ``bench.py``'s dense workload
    (``1.5 * Matern32(scale=2.5)``, ``diag=0.1``, N = 1e4, float32):
    ``log_probability`` against a float64 Cholesky, with its launches and
    the guard's re-factorizations counted, and timed whole, by strip build
    and by kernel beside the native float32 Cholesky;
12. its gradient in ``(amp, scale)`` against float64 autograd through
    ``torch.linalg.cholesky``, with the native float32 route's error
    beside it, and a 10-step ``fit_map``;
13. ``condition``, ``predict(return_var=True)`` at 1000 new points and
    ``sample`` against a float64 dense posterior, with the native float32
    route beside it as the yardstick;
14. the ill-conditioned route: ``ExpSquared(scale=1.0)`` with the float32
    default jitter (3-term order, the guards) on 4096 points and on
    ``bench.py``'s dense data at N = 1e4 (timed whole), against float64 and
    the native float32 route; kernel B7 launches 0 times over phases
    11-14; before them, a table of B5's 3-term order at each panel shape
    beside a float64 ``matmul`` and its bound, with the sums;
14b. the dense path's and the conditioning path's limits again (phases
    3, 8, 9, 11-14) with TF32 turned on globally, the yardsticks at the
    defaults, which are restored after;
15. kernel B7, the tiled gram builder, on its entry point
    ``ops.gram.gram_tiled``: ``benchmarks/dense_pieces.py``'s
    ``1.5 * Matern32(scale=2.5)`` at N = M = 1e4 and the gradient in
    ``(amp, scale, X1)`` of ``sum(sin(K) w)`` at N = 2048 (against float64
    autograd, 1e-4 per parameter), with B7's launches counted; B7 against
    float64 on the same float32 values, within twice the float32 plain
    version's error plus 1e-6 of the largest entry, for every leaf with
    either metric on ragged 1-d and 3-d points, the JAX test's kernels,
    each root transform, and the 1e4 gram; timed at 1e4 (CUDA events, and
    B7's device time from a ``torch.profiler`` trace) and summed over
    the dense path's 20 strip shapes (through ``gram_tiled`` and launched
    directly), beside its bound, its plain version and
    ``kernel(X[lo:n], X[lo:cr])`` as the strip build calls it, and the host
    time of one small ``gram_tiled`` call;
16. every quasiseparable order at ``bench.py``'s data (N = 1e5): in
    float32 Matern52's ``condition``, ``predict(return_var=True)`` and
    ``sample``, the 2-term celerite's ``condition``, and
    ``1.2 * SHO + 1.5 * Matern52`` (m = 5): its value (also at N = 1e6),
    its gradient in four hyperparameters and 20 ``fit_map`` steps; the
    same sum with the 2-term celerite (m = 9): its value and its gradient
    in six hyperparameters, one B1r and one B2 launch (B2's tensor-core
    kernel) a gradient, timed; the order-20 asteroseismic model (two
    granulation terms and a comb of eight modes, ``sum20_kernel``): its
    value, its gradient in six hyperparameters and 5 ``fit_map`` steps,
    one B1r and one B2 launch (the block-a-team kernels) a gradient; in
    float64 the posterior processes (order 8, 12 and 16) of Matern32,
    Matern52 and the 2-term celerite, ``log_probability`` and ``sample``,
    with their default jitter at N = 1e5 (reported: the reference's O(N)
    factor does not hold there) and given ``diag=1e-3`` at N = 5000; the
    generic-order launches counted over the path, each held to its plain
    version on the path's well-posed operands and timed beside its bound
    (B2 repeated bit for bit, one launch a call); B1, B1r and B2 at
    m = 8, 9, 12, 16 and 32 on random operands against their plain
    versions, timed beside their bounds; the float64 entry points (the
    m = 5, 9 and 20 models' values and gradients at N = 5000, the order-20
    model's within 1e-9 and 1e-6) against the CPU's plain version;
17. B1, B1r and B2 with a chain axis (one launch for every chain): at
    (chains, N, m) = (1024, 512, 2) in float32 with the data shared by every
    chain and not, (64, 1e5, 2) in float32 and (16, 4096, 4) in float64,
    each against its plain version (per chain and output stream) and bit
    for bit against the unbatched launch on each chain's operands, timed
    beside its bound (the unbatched bytes times the chains, y once where
    shared), the plain version and, for B1r, the chains' unbatched
    launches in turn;
18. the samplers: ``run_mcmc(..., sampler="nuts")`` on
    ``benchmarks/nuts_throughput.py``'s model (``amp * SHO``, 1024 chains,
    N = 512, float32, ``max_tree_depth=6``, ``steps_per_dispatch=25``) with
    half its 100 warmup steps and a quarter of its 100 samples, every batched gradient
    evaluation one chain-axis B1r and one B2 launch by the counts, the
    accept statistic, split R-hat and four chains against the plain
    version on the CPU held to limits; a checkpointed run interrupted and
    resumed equal to the uninterrupted one; samples/s and one evaluation's
    split; then ``hmc`` on 64 chains of ``bench.py``'s Matern32 model at
    N = 1e5;
19. ADVI (``fit_advi``) at ``benchmarks/smc_vi_rate.py``'s settings
    (``amp * SHO``, ``diag=0.09``, N = 512, float32, 8 ELBO draws, lr 1e-2),
    mean-field and full-rank, 200 steps: first the gradient of a vmapped
    log density taken outside the ``vmap`` (``c6`` lines, at m = 2 and
    m = 5) and the ELBO's gradient at fixed noise, card against the plain
    path on the CPU; one chain-axis B1r and one B2 launch a step by the
    counts, a finite and rising ELBO trace; steps/s cold and warm and one
    step's split;
20. tempered SMC (``run_smc``) at the same script's settings (1024
    particles, 5 mutations), cold and warm: one chain-axis B1 launch a
    batched evaluation and nothing else, the ladder, acceptance and
    evidence, four particles against the CPU; ``test_vi_smc.py``'s
    Gaussian target against its analytic posterior and evidence;
21. CARMA(2, 1) of ``benchmarks/model_family_bench.py`` on ``bench.py``'s
    data at N = 1e5 in float32 and float64: the value (B1) and the gradient
    (B1r, B2), each kernel against its plain version; in float64 the value
    at N = 2000 and ``condition``/``predict`` at N = 5000 against dense
    references of Kelly's autocovariance; a p = 3 process through the
    value; the constructor's and the calls' times;
22. gradients through conditioning (N8): the gradient in (amp, scale) of
    ``sum(w * mu) + sum(var)`` from ``predict(y, linspace(0, 10, 1000),
    return_var=True)`` for ``bench.py``'s Matern32 in float32, held within
    5e-4 of the CPU plain path's float32 and of the card's float64 on every
    1000th point (N = 100), and at N = 1e5 held within twice the JAX
    package's own distance (4.67e-3 of the largest entry) of the card's
    float64 gradient, its value within 1e-5 of the JAX package's float32
    value (C7: a float32 quasiseparable process conditions at new points in
    float64, as the JAX package does under x64), and timed; the
    gradient of the posterior processes' ``log_probability`` (Matern32,
    Matern52, the 2-term celerite: orders 8, 12, 16) in float64, held
    within 1e-7 of the CPU plain path at N = 1000 (posterior ``diag=0.1``),
    driven, timed and printed at N = 5000 (``diag=1e-3``) beside a dense
    float64 posterior; and central differences of Matern32's posterior
    value at N = 1000, ``diag=1.0``, within 1e-6. Every B3 launch is counted, forward and backward
    apart: the backwards launch B3 in reverse (``cong``, ``aff``, ``cpl``),
    no plain scan runs on a CUDA tensor; each shape's B3 against its plain
    version;
23. the low-rank solver (L2) at ``benchmarks/lowrank_bench.py``'s settings
    (dense Matern32, M = 512, N = 1e4, 2e4, 1e5, float32): value and
    gradient, timed beside a dense Cholesky at 1e4, float64 against the CPU
    plain path at 1e4, under TF32 against the same call with TF32 off;
    ``tests/test_solvers/test_lowrank.py``'s limits on
    the card (``Z = X`` against ``DirectSolver``, duplicated inducing
    points, a NaN capacitance, clustered inducing points);
24. the Kalman oracle (L2): ``test_kalman.py``'s four kernels in float64
    at N = 5000 and 1e4 against ``QuasisepSolver`` (B1) on the card, the
    host loop timed;
25. the ``parallel`` subpackage (L4): in a one-rank NCCL group,
    ``run_mcmc_sharded`` at phase 18's model and width (25 warmup steps,
    25 samples) and ``run_smc_sharded`` at phase 20's, each bit for bit
    the unsharded sampler with the same seed, with one chain-axis B1r and
    B2 launch per NUTS evaluation and one chain-axis B1 per SMC
    evaluation; the sharded checkpoint's round trip of the MCMC result;
    ``sharded_loglik`` at N = 1e5 in float64 against ``log_probability``;
    ``cholesky_tp`` at n = 8192 in float32 against the float64 factor;
    then a two-rank gloo group of two processes on the same card
    (``--parallel-rank``, collectives staged through host memory) against
    the one-rank results: ``sharded_loglik``, ``sharded_loglik_chains`` on
    a (1, 2) mesh, ``cholesky_tp`` and a 64-chain ``run_mcmc_sharded``.

The line before the last is a JSON record of every kernel (B3 with one
record per monoid and shape of the conditioning path; B4 with and without
its side products, B5 at either order and B6 each summed over the shapes of
the dense main path; B7 at 1e4; one record per generic-order instantiation
of phase 16, and B1, B1r and B2 at m = 5, 9 and 20; B1, B1r and B2 with a chain
axis at the sampler's shape, with their launches on phases 18-20's and 25's
paths;
B1, B1r, B2 and B3 with CARMA's launches added, and B3 with phase 22's,
forward and reverse, a record of its own for each shape no earlier phase
launched); the last line
is ``{"ok": true, "device": {...}}``. Any failure raises, and the script
then exits non-zero without that line; it also exits non-zero where CUDA is
not available.

``python3 chip_smoke.py --dense-times`` runs phase 1 and then only times
B4 at each trailing size beside ``addmm`` and the dense value and gradient
calls, through entry points older trees share: copied into a parent
commit's checkout, it times the parent's kernels in the same chip call.
``python3 chip_smoke.py --riccati-panel-times`` does the same for B5's
3-term order per panel shape (beside a float64 ``matmul``), the
generic-order B1, B1r and B2 (as ``--b1-times generic``), and the
ill-conditioned dense ``log_probability`` at N = 1e4. ``python3 chip_smoke.py --b2-times`` does the same for B2 (the
Matern32 gradient's operands at N = 1e5 and 1e6, the m = 5 sum's at 1e5,
random m = 8 operands at 1e5): CUDA-event times, the passes of a
``torch.profiler`` trace, two launches compared bit for bit, B1 and B1r
on the same operands, and the whole gradient calls.
``python3 chip_smoke.py --b1-times`` does the same for B1 and B1r at
m <= 4 (Matern32 at N = 1e5 and 1e6, SHO and the 2-term celerite at 1e5)
and the whole Matern32 value and gradient calls, every CUDA-event time
taken before any trace; ``--b1-times generic`` for B1, B1r and B2 above
m = 4 (the m = 5, 9 and 20 models' operands, random ones at m = 8, 16 and
32, N = 1e5). ``python3 chip_smoke.py --b3-times`` does the same
for B3: the Matern32 conditioning path's scans at N = 1e5, the m = 2
scans at 1e6, Matern52's and the celerite's couplings (6, 6) and (8, 8),
the couplings (2, 2) and (4, 4) through either source, and the whole
Matern32, Matern52 and celerite ``condition`` calls.
``python3 chip_smoke.py --b3-times generic`` times B3's generic-order
sources alone: the posterior processes' Riccati and affine scans (orders
8-20), the order-5 and order-9 sums' conditioning couplings, and the
shapes the three-phase engine ran before these kernels (the couplings (12, 12) and
(16, 16), every monoid at m = 24 and 32), beside their bounds; copied into
a parent commit's checkout it times the parent at the same shapes.
``python3 chip_smoke.py --sampler`` runs phase 1 and then only phases 17
to 20, the NUTS run at ``nuts_throughput.py``'s full 100 warmup steps and
100 samples and ADVI at ``smc_vi_rate.py``'s 1000 steps, and prints the
chain-axis records. ``python3 chip_smoke.py --c6`` runs phase 1 and then
only phase 19's ``c6`` checks; they use only what older trees share, so
copied into a parent commit's checkout it shows the parent's gradients.
``python3 chip_smoke.py --grad`` runs phase 1 and then only phases 22-24,
their TF32 reruns and the records of phase 22's B3 shapes.
``python3 chip_smoke.py --tf32-mutant`` runs phase 1 and then phases 22
and 23's TF32 reruns with the backward pins removed in its own process,
and exits 0 only if phase 23's fails, as it must (phase 22's float32
conditioning runs in float64, which TF32 does not reach).
``python3 chip_smoke.py --parallel`` runs phase 1 and then only phase 25.
``python3 chip_smoke.py --gram-times`` does the same for B7: at 1e4 x 1e4
and over the dense path's 20 strip shapes, each through ``gram_tiled`` and
launched directly, and the host time of one 64 x 64 ``gram_tiled`` call
with its ``cProfile`` split.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM data-sheet peaks: HBM bandwidth and float32 outside the tensor
# cores. They give each kernel's bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

N_LONG = 2 * 8192 + 777

# What the float32 kernels add to the float32 gradient (residuals and
# cotangents stored in float32) over float64 kernels on the same float32
# operands, per parameter, relative to the float64 gradient. The limits
# are about 2.5x the largest reading on an H100 (2.04e-3 at N = 1e5,
# 1.20e-2 at 1e6, both for amp; the readings repeat to the last digit).
KERNEL_GRAD_LIMITS = {"n1e5": 5e-3, "n1e6": 3e-2}


def log(*parts):
    print(*parts, flush=True)


def random_operands(m, n, dtype, seed):
    import torch

    from tinygp_tpu_torch.test_utils import random_qsm_operands

    arrays = random_qsm_operands(m, n, seed)
    return [torch.as_tensor(x, dtype=dtype, device="cuda") for x in arrays]


def cuda_ms(fn, reps, warmup):
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes, flops):
    """The larger of moving ``nbytes`` at the HBM rate and doing ``flops``
    at the float32 rate, and which of the two it is."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def loglik_bound_ms(m, n, itemsize, residuals=False):
    """Least time for (quad, logdet) (B1), or with the residuals F, e and
    1/c written too (B1r): read every operand once and write every output
    once, or do the sequential algorithm's operations."""
    values = m * m + 2 * m + 2 + (m * m + m + 1 if residuals else 0)
    # Per element: F p, p.Fp and a F p (4m^2 + 2m), alpha (2m + 4),
    # the affine step and its update (4m^2 + 2m), a F a^T + u u^T / c2
    # (4m^3 + 3m^2), c and log c (4).
    flops = n * (4 * m**3 + 11 * m**2 + 6 * m + 8)
    return bound_ms(values * n * itemsize + 2 * itemsize, flops)


def bwd_bound_ms(m, n, itemsize):
    """Least time for B2: read (ps, qs, as_, y, F, e, ic) and the two
    cotangents once and write (dbar, psbar, qsbar, asbar, ybar) once, or do
    the per-element operations (about 8m^3 + 25m^2 + 30m + 25: the
    recomputed emissions, both adjoint steps, the glue and the outputs)."""
    values = 3 * m * m + 5 * m + 4
    flops = n * (8 * m**3 + 25 * m**2 + 30 * m + 25)
    return bound_ms(values * n * itemsize + 2 * itemsize, flops)


def stream_errors(got, want):
    """Per output: (largest error relative to the stream's largest
    magnitude, largest absolute error), both computed in float64."""
    out = []
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        diff = float((g - w).abs().max())
        out.append((diff / max(float(w.abs().max()), 1e-300), diff))
    return out


def reset_counts():
    """Set every kernel's launch count to 0: B1, B1r, B2 and B3's, and
    those of the generic-order sources."""
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik, cuda_scan

    cuda_loglik.LAUNCHES = cuda_loglik.LAUNCHES_RES = cuda_loglik.LAUNCHES_BWD = 0
    for counts in (cuda_scan.LAUNCHES, cuda_scan.LAUNCHES_GENERIC, cuda_loglik.LAUNCHES_GENERIC):
        for key in counts:
            counts[key] = 0


def read_counts():
    """Launches of B1, B1r and B2 since the last reset."""
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    return [cuda_loglik.LAUNCHES, cuda_loglik.LAUNCHES_RES, cuda_loglik.LAUNCHES_BWD]


def rel_err(got, want):
    return abs(got - want) / max(abs(want), 1e-300)


def phase_build():
    import torch

    from tinygp_tpu_torch import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    global CARD
    CARD = smi.stdout.strip()
    log("card name and power limit (nvidia-smi):")
    log(CARD)
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}"
    )
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for stem in ("dense_tc", "dense_syrk", "quasisep_loglik", "quasisep_loglik_bwd",
                 "quasisep_loglik_generic", "quasisep_loglik_wide", "gram"):
        if stem in libs:  # a parent tree, timed with this script, may lack one
            log_ptxas(stem)


def log_ptxas(stem, only=None):
    """Each kernel of ``csrc/<stem>.cu`` (those whose name matches the
    regular expression ``only``, if given) as ``nvcc -Xptxas -v`` reported
    it (registers, shared memory, spills), and the dense GEMM's dynamic
    shared memory, which ptxas does not see."""
    import re

    from tinygp_tpu_torch import cuda_build
    from tinygp_tpu_torch.ops import cuda_dense

    name, report = None, {}
    for line in cuda_build.build_log(stem).splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            # Drop the anonymous namespace nvcc names after the source.
            mangled = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_ZN", mangled)
            kind = re.search(r"tc_gemmILi(\d)E", mangled)
            plain = re.search(r"\d+([a-z_0-9]*(?:kernel|pass|gemm|chunk|totals))(.*)", mangled)
            # Template arguments <storage type, order[, residuals]> as the
            # B1-B3 kernels take them.
            targs = plain and re.match(r"I([fd])Li(\d+)E(?:Lb([01])E)?", plain.group(2))
            res = targs and targs.group(3) and (", true" if targs.group(3) == "1" else ", false")
            name = (f"tc_gemm for {('B5', 'B6', 'B4')[int(kind.group(1))]}" if kind
                    else "split_kernel" if "split_kernel" in mangled
                    else f"{plain.group(1)}<{'float' if targs.group(1) == 'f' else 'double'}, "
                         f"{targs.group(2)}{res or ''}>"
                    if targs
                    else f"{plain.group(1)} {plain.group(2)[:48]}" if plain else mangled)
            if only and not re.search(only, name):
                name = None
            else:
                report[name] = []
        elif name and ("registers" in line or "spill" in line or "smem" in line):
            report[name].append(line.split(":", 1)[-1].strip())
    for name, lines in report.items():
        log(f"ptxas {stem}.cu {name}: {'; '.join(lines)}")
    if stem != "dense_tc":
        return
    cfg = cuda_dense.gemm_config()
    log(f"ptxas {stem}.cu tc_gemm: {cfg['bm']} x {cfg['bn']} tiles, {cfg['stages']} stages, "
        f"{cfg['smem']} bytes of dynamic shared memory")


def phase_dense_precision():
    """The port's plain float32 products must run in full float32: TF32
    off for matmuls, "highest" precision."""
    import torch

    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    log(f"float32 matmul: allow_tf32 {tf32}, float32_matmul_precision {precision!r}")
    if tf32 is not False or precision != "highest":
        raise AssertionError("float32 products would run in TF32")


@contextlib.contextmanager
def float32_defaults():
    """PyTorch's default float32 product precision (TF32 off, "highest")
    inside the block, whatever is set outside it: the yardsticks of the
    limits are computed so under :func:`phase_tf32` too."""
    import torch

    saved = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]


def phase_tf32():
    """The dense path's and the conditioning path's limits (phases 3, 8,
    9, 11-14, the float32 part of 22 and 23) rerun with TF32 turned on globally, as a user does with
    ``torch.set_float32_matmul_precision("high")``: the port's entry points
    must meet them whatever the global setting, as the reference pins its
    contractions' precision (``tinygp_tpu/helpers.py:26-34``). The
    yardsticks stay at the defaults; the defaults are restored after."""
    import torch

    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    log(f"tf32: allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, float32_matmul_precision "
        f"{torch.get_float32_matmul_precision()!r}; rerunning the dense and conditioning phases")
    try:
        for phase in (phase_dense_check, phase_example_condition, phase_condition_path,
                      phase_dense_loglik, phase_dense_path_gradient, phase_dense_condition,
                      phase_dense_ill_conditioned, phase_condition_gradient, phase_lowrank):
            if phase in (phase_condition_gradient, phase_lowrank):
                phase(tf32=True)
            else:
                phase()
            log(f"tf32: {phase.__name__} passed with TF32 on")
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    phase_dense_precision()


def phase_kernel_vs_plain():
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    # m = 1..4 run the templated kernels, 5..16 the generic-order source
    # (B1 and B1r on the float64 tensor cores, B2's warp kernel up to 8 and
    # its tensor-core kernel above), 17..32 the block-a-team source; each in
    # one launch.
    orders = (1, 2, 3, 4, 5, 8, 9, 16, 20, 24, 32)
    cases = [(m, N_LONG, torch.float64, 1e-8) for m in orders]
    cases += [(m, N_LONG, torch.float32, 5e-4) for m in orders]
    cases += [(m, 100_000, torch.float32, 5e-4) for m in (1, 2, 3, 4)]
    # At 1e6 the headline order only (m = 1, 3 and 4 at 1e6 took about a
    # minute of plain versions; they are held at 1e5 and N_LONG above).
    cases += [(2, 1_000_000, dtype, rtol)
              for dtype, rtol in ((torch.float64, 1e-8), (torch.float32, 5e-4))]
    failures = []
    for m, n, dtype, rtol in cases:
        args = random_operands(m, n, dtype, seed=m)
        got_t = cuda_loglik.fused_loglik_terms(*args)
        got = [float(x) for x in got_t]
        want = [float(x) for x in cuda_loglik.plain_loglik_terms(*args)]
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        ok = all(e <= rtol and math.isfinite(g) for e, g in zip(errs, got))
        log(
            f"kernel-vs-plain m={m} N={n} {str(dtype)[6:]}: quad {got[0]!r} vs "
            f"{want[0]!r}, logdet {got[1]!r} vs {want[1]!r}, rel err "
            f"{max(errs):.3e} (rtol {rtol:g}) {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            failures.append(("B1", m, n, dtype))

        # B1r: the same sums as B1, and residuals that match the plain ones;
        # a second launch of each equal bit for bit.
        res = cuda_loglik.fused_loglik_res(*args)
        plain_res = cuda_loglik.plain_loglik_terms_res(*args)
        same = [float(x) for x in res[:2]] == got
        repeats = all(torch.equal(a, b) for a, b in zip(
            (*cuda_loglik.fused_loglik_terms(*args), *cuda_loglik.fused_loglik_res(*args)),
            (*got_t, *res)))
        errs = stream_errors(res, plain_res)
        ok = same and repeats and max(e for e, _ in errs) <= rtol and all(
            bool(torch.isfinite(x).all()) for x in res
        )
        log(
            f"kernel-vs-plain B1r m={m} N={n} {str(dtype)[6:]}: sums equal B1's "
            f"{same}, rel err per stream (quad, logdet, F, e, 1/c) "
            f"{[f'{e:.2e}' for e, _ in errs]} (rtol {rtol:g}), a second launch of B1 and "
            f"B1r equal bit for bit {repeats} {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            failures.append(("B1r", m, n, dtype))
        if m <= 4 or m in (5, 9):
            # The one launch: B1 and B1r against their association in plain
            # PyTorch, in float64 on the same values; repeated bit for bit.
            tile, sub = cuda_loglik.b1_schedule(m, dtype)
            tiled = cuda_loglik.plain_loglik_terms_res_tiled(
                *(x.double() for x in args), tile, sub)
            terrs = stream_errors(res, tiled)
            same = all(torch.equal(a, b) for a, b in zip(
                (*cuda_loglik.fused_loglik_terms(*args), *cuda_loglik.fused_loglik_res(*args)),
                (*got_t, *res)))
            ok = max(e for e, _ in terrs) <= rtol and same
            log(
                f"kernel-vs-plain one-launch B1/B1r m={m} N={n} {str(dtype)[6:]}: against the "
                f"tiled plain version in float64 (tile {tile}, {sub} a team) rel err per "
                f"stream {[f'{e:.2e}' for e, _ in terrs]} (rtol {rtol:g}); a second launch of "
                f"each equal bit for bit {same} {'ok' if ok else 'FAIL'}"
            )
            if not ok:
                failures.append(("B1 one launch", m, n, dtype))

        # B2 on B1r's residuals, with random scalar cotangents on the card.
        rng = np.random.default_rng(100 + m)
        qbar, lbar = (torch.tensor(v, dtype=dtype, device="cuda") for v in rng.normal(size=2))
        bwd_args = (*args[1:], *res[2:], qbar, lbar)
        bars = cuda_loglik.fused_loglik_bwd(*bwd_args)
        same = all(torch.equal(a, b) for a, b in zip(bars, cuda_loglik.fused_loglik_bwd(*bwd_args)))
        plain_bars = cuda_loglik.plain_loglik_bwd(*bwd_args)
        errs = stream_errors(bars, plain_bars)
        ok = same and max(e for e, _ in errs) <= rtol and all(
            bool(torch.isfinite(x).all()) for x in bars
        )
        log(
            f"kernel-vs-plain B2 m={m} N={n} {str(dtype)[6:]}: rel err per "
            f"stream (dbar, psbar, qsbar, asbar, ybar) "
            f"{[f'{e:.2e}' for e, _ in errs]} (rtol {rtol:g}), a second launch equal bit "
            f"for bit {same} {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            failures.append(("B2", m, n, dtype))
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")


def dense_loglik(K, y):
    import scipy.linalg

    L = np.linalg.cholesky(K)
    alpha = scipy.linalg.solve_triangular(L, y, lower=True)
    n = y.shape[0]
    return -0.5 * (alpha @ alpha) - np.sum(np.log(np.diag(L))) - 0.5 * n * math.log(2 * math.pi)


def phase_dense_check():
    import torch

    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    rng = np.random.default_rng(2048)
    n = 2048
    X = np.sort(rng.uniform(0, 10, n))
    y = rng.normal(size=n)
    tau = np.abs(X[:, None] - X[None, :])

    f = math.sqrt(3.0) / 2.5
    k_m32 = 1.5 * (1 + f * tau) * np.exp(-f * tau)
    terms = [(1.0, 0.1, 0.5, 1.0), (0.5, 0.05, 1.5, 3.0)]
    k_cel = sum(
        np.exp(-c * tau) * (a * np.cos(d * tau) + b * np.sin(d * tau))
        for a, b, c, d in terms
    )
    models = {
        "matern32": (lambda: 1.5 * quasisep.Matern32(scale=2.5), k_m32),
        "celerite2": (
            lambda: quasisep.Celerite(*terms[0]) + quasisep.Celerite(*terms[1]),
            k_cel,
        ),
        # m = 5: the generic-order B1 (the Riccati flow's rank-one fold).
        "sho+matern52": (
            lambda: 1.2 * quasisep.SHO(omega=1.5, quality=3.0) + 1.5 * quasisep.Matern52(scale=2.5),
            1.2 * sho_closed_form(tau, 1.5, 3.0) + dense_m52(tau, 1.5, 2.5),
        ),
    }
    failures = []
    for name, (kernel, K) in models.items():
        want = dense_loglik(K + 0.1 * np.eye(n), y)
        before = cuda_loglik.LAUNCHES
        gp = GaussianProcess(
            kernel(), torch.as_tensor(X), diag=0.1, assume_sorted=True
        )
        got = gp.log_probability(y).item()
        launched = cuda_loglik.LAUNCHES - before
        err = rel_err(got, want)
        ok = err <= 1e-9 and launched == 1
        log(
            f"dense-check {name} N={n} float64: kernel path {got!r} vs dense "
            f"Cholesky {want!r}, rel err {err:.3e} (rtol 1e-9), launches "
            f"{launched} {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            failures.append(name)
    if failures:
        raise AssertionError(f"dense check failed: {failures}")


def dense_m32(tau, amp, scale):
    f = math.sqrt(3.0) / scale
    return amp * (1 + f * tau) * np.exp(-f * tau)


def dense_m52(tau, amp, scale):
    f = math.sqrt(5.0) / scale
    return amp * (1 + f * tau + (f * tau) ** 2 / 3) * np.exp(-f * tau)


def dense_celerite(tau, terms):
    return sum(
        np.exp(-c * tau) * (a * np.cos(d * tau) + b * np.sin(d * tau))
        for a, b, c, d in terms
    )


def central_difference(f, x):
    """df/dx by the five-point central stencil (error O(h^4))."""
    h = 1e-3 * max(1.0, abs(x))
    return (
        -f(x + 2 * h) + 8 * f(x + h) - 8 * f(x - h) + f(x - 2 * h)
    ) / (12 * h)


def phase_dense_gradient():
    """The float64 gradient of ``log_probability`` on the card against
    central differences of the dense Cholesky log-likelihood."""
    import torch

    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    rng = np.random.default_rng(2048)
    n = 2048
    X = np.sort(rng.uniform(0, 10, n))
    y = rng.normal(size=n)
    tau = np.abs(X[:, None] - X[None, :])
    eye = np.eye(n)
    terms = [[1.0, 0.1, 0.5, 1.0], [0.5, 0.05, 1.5, 3.0]]

    def celerite_kernel(p):
        return quasisep.Celerite(a=p["a1"], b=0.1, c=p["c1"], d=1.0) + quasisep.Celerite(
            a=p["a2"], b=0.05, c=p["c2"], d=3.0
        )

    def celerite_dense(p):
        t = [[p["a1"], 0.1, p["c1"], 1.0], [p["a2"], 0.05, p["c2"], 3.0]]
        return dense_celerite(tau, t) + 0.1 * eye

    models = {
        "matern32": (
            lambda p: p["amp"] * quasisep.Matern32(scale=p["scale"]),
            lambda p: dense_m32(tau, p["amp"], p["scale"]) + p["diag"] * eye,
            {"amp": 1.5, "scale": 2.5, "diag": 0.1},
        ),
        "celerite2": (
            celerite_kernel,
            celerite_dense,
            {"a1": terms[0][0], "c1": terms[0][2], "a2": terms[1][0], "c2": terms[1][2]},
        ),
        # m = 5: the generic-order B1r and B2.
        "sho+matern52": (
            lambda p: p["amp1"] * quasisep.SHO(omega=p["omega"], quality=3.0)
            + p["amp2"] * quasisep.Matern52(scale=p["scale"]),
            lambda p: p["amp1"] * sho_closed_form(tau, p["omega"], 3.0)
            + dense_m52(tau, p["amp2"], p["scale"]) + 0.1 * eye,
            dict(zip(("amp1", "omega", "amp2", "scale"), SUM5_PARAMS)),
        ),
    }
    failures = []
    for name, (kernel, dense, point) in models.items():
        leaves = {
            k: torch.tensor(v, dtype=torch.float64, device="cuda", requires_grad=True)
            for k, v in point.items()
        }
        reset_counts()
        gp = GaussianProcess(
            kernel(leaves), torch.as_tensor(X), diag=leaves.get("diag", 0.1),
            assume_sorted=True,
        )
        lp = gp.log_probability(y)
        grads = torch.autograd.grad(lp, list(leaves.values()))
        torch.cuda.synchronize()
        counts = read_counts()
        ok = counts == [0, 1, 1]
        parts = []
        for (key, x), g in zip(point.items(), grads):
            fd = central_difference(
                lambda v: dense_loglik(dense(dict(point, **{key: v})), y), x
            )
            err = rel_err(float(g), fd)
            ok = ok and err <= 1e-6 and math.isfinite(float(g))
            parts.append(f"{key} {float(g)!r} vs {fd!r} (rel {err:.2e})")
        log(
            f"dense-gradient {name} N={n} float64: {'; '.join(parts)} (rtol 1e-6); "
            f"launches B1 {counts[0]} B1r {counts[1]} B2 {counts[2]} "
            f"{'ok' if ok else 'FAIL'}"
        )
        if not ok:
            failures.append(name)
    if failures:
        raise AssertionError(f"dense gradient check failed: {failures}")


def bench_data():
    """``bench.py``'s draws, in its order: X, y at 1e5, then at 1e6."""
    rng = np.random.default_rng(42)
    X5 = np.sort(rng.uniform(0, 10, 100_000))
    y5 = rng.normal(size=100_000)
    X6 = np.sort(rng.uniform(0, 10, 1_000_000))
    y6 = rng.normal(size=1_000_000)
    return (X5, y5), (X6, y6)


def phase_main_path():
    """The main path at full size; returns the kernel's JSON record."""
    import torch

    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    (X5, y5), (X6, y6) = bench_data()

    def on_card(a):
        return torch.as_tensor(a, dtype=torch.float32, device="cuda")

    data5 = (on_card(X5), on_card(y5))
    data6 = (on_card(X6), on_card(y6))
    configs = {
        "matern32_n1e5": (lambda: 1.5 * quasisep.Matern32(scale=2.5), data5),
        "matern32_n1e6": (lambda: 1.5 * quasisep.Matern32(scale=2.5), data6),
        "sho_n1e5": (lambda: 1.2 * quasisep.SHO(omega=1.5, quality=3.0), data5),
        "celerite2_n1e5": (
            lambda: quasisep.Celerite(a=1.0, b=0.1, c=0.5, d=1.0)
            + quasisep.Celerite(a=0.5, b=0.05, c=1.5, d=3.0),
            data5,
        ),
    }
    record = None
    total_launches = 0
    failures = []
    with torch.inference_mode():
        for name, (kernel, (X, y)) in configs.items():

            def log_probability():
                gp = GaussianProcess(kernel(), X, diag=0.1, assume_sorted=True)
                return gp.log_probability(y)

            # The main path, once, with the launch count read around it.
            reset_counts()
            value = log_probability()
            torch.cuda.synchronize()
            launches = cuda_loglik.LAUNCHES
            total_launches += launches

            gp = GaussianProcess(kernel(), X, diag=0.1, assume_sorted=True)
            d, ps, qs, as_ = gp.solver.ssm
            r = (y - gp.loc).contiguous()
            m, n = ps.shape
            got = [float(v) for v in cuda_loglik.fused_loglik_terms(d, ps, qs, as_, r)]
            want = [float(v) for v in cuda_loglik.plain_loglik_terms(d, ps, qs, as_, r)]
            abs_err = max(abs(g - w) for g, w in zip(got, want))
            rel = max(rel_err(g, w) for g, w in zip(got, want))

            e2e_ms = cuda_ms(log_probability, reps=30, warmup=3)
            # The constructor alone: hyperparameters to the card and the
            # eager elementwise generation of the stacked operands.
            construct_ms = cuda_ms(
                lambda: GaussianProcess(kernel(), X, diag=0.1, assume_sorted=True),
                reps=30,
                warmup=3,
            )
            kernel_ms = cuda_ms(
                lambda: cuda_loglik.fused_loglik_terms(d, ps, qs, as_, r),
                reps=50,
                warmup=3,
            )
            plain_ms = cuda_ms(
                lambda: cuda_loglik.plain_loglik_terms(d, ps, qs, as_, r),
                reps=3,
                warmup=1,
            )
            bound_ms, bound_by = loglik_bound_ms(m, n, 4)
            # After the timings: one B1 call is one kernel and one memset.
            one, ops_report = b1_one_launch(
                lambda: cuda_loglik.fused_loglik_terms(d, ps, qs, as_, r))
            shape_ok = value.shape == ()
            value = value.item()
            ok = launches > 0 and shape_ok and math.isfinite(value) and rel <= 5e-4 and one
            log(
                f"main-path {name} m={m} N={n} float32: log_probability "
                f"{value!r}, kernel launches {launches}, kernel-vs-plain abs "
                f"err {abs_err:.4g} rel {rel:.3e} (rtol 5e-4), whole call "
                f"{e2e_ms:.4f} ms (constructor {construct_ms:.4f} ms), kernel "
                f"{kernel_ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); B1's trace: "
                f"{ops_report} {'ok' if ok else 'FAIL'}"
            )
            if not ok:
                failures.append(name)
            if name == "matern32_n1e6":
                record = {
                    "name": "quasisep_loglik",
                    "route": "cuda",
                    "source": "tinygp_tpu_torch/csrc/quasisep_loglik.cu",
                    "replaces": "tinygp_tpu/solvers/quasisep/pallas_loglik.py:86",
                    "max_abs_err": abs_err,
                    "ms": kernel_ms,
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "library_ms": None,
                }
    if failures:
        raise AssertionError(f"main path failed: {failures}")
    record["launches"] = total_launches
    return record


def matern32_gp(X, amp, scale):
    """``bench.py``'s model: ``amp * Matern32(scale)``, ``diag=0.1``."""
    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep

    return GaussianProcess(amp * quasisep.Matern32(scale=scale), X, diag=0.1, assume_sorted=True)


def matern32_grad(X, y):
    """The main path's gradient: d log_probability / d (amp, scale) at
    (1.5, 2.5), as ``bench.py`` takes it."""
    import torch

    amp, scale = (
        torch.tensor(v, dtype=X.dtype, device=X.device, requires_grad=True) for v in (1.5, 2.5)
    )
    lp = matern32_gp(X, amp, scale).log_probability(y)
    return torch.autograd.grad(lp, [amp, scale])


def matern32_plain_grad(X, y):
    """The same gradient through the plain versions of B1r and B2 (with
    autograd only for the operands' construction)."""
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    amp, scale = (
        torch.tensor(v, dtype=X.dtype, device=X.device, requires_grad=True) for v in (1.5, 2.5)
    )
    gp = matern32_gp(X, amp, scale)
    d, ps, qs, as_ = (x.contiguous() for x in gp.solver.ssm)
    r = (y - gp.loc).contiguous()
    with torch.no_grad():
        res = cuda_loglik.plain_loglik_terms_res(d, ps, qs, as_, r)
        # log_probability = -0.5 quad - logdet - const
        qbar, lbar = (torch.tensor(v, dtype=X.dtype, device=X.device) for v in (-0.5, -1.0))
        bars = cuda_loglik.plain_loglik_bwd(ps, qs, as_, r, *res[2:], qbar, lbar)
    roots = [(x, g) for x, g in zip((d, ps, qs, as_, r), bars) if x.requires_grad]
    torch.autograd.backward(*zip(*roots))
    return amp.grad, scale.grad


def matern32_grad_f64_kernels(X, y):
    """The same gradient from float32 operands, as the constructor builds
    them, with B1r and B2 run on them in float64: it separates the error of
    the float32 operands from that of the float32 residuals."""
    import torch

    from tinygp_tpu_torch.solvers.quasisep import ops

    amp, scale = (
        torch.tensor(v, dtype=X.dtype, device=X.device, requires_grad=True) for v in (1.5, 2.5)
    )
    gp = matern32_gp(X, amp, scale)
    operands = (*gp.solver.ssm, y - gp.loc)
    quad, logdet = ops.stacked_loglik_terms(*(x.double() for x in operands))
    return torch.autograd.grad(-0.5 * quad - logdet, [amp, scale])


def b2_launch_checks(bwd_args, bars):
    """B2 launched again on ``bwd_args`` gives ``bars`` bit for bit; and,
    from a ``torch.profiler`` trace, one call is one kernel launch and at
    most one memset. Returns (same bits, (one launch, report))."""
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    same = all(torch.equal(a, b) for a, b in zip(bars, cuda_loglik.fused_loglik_bwd(*bwd_args)))
    split, per_call = kernel_split(lambda: cuda_loglik.fused_loglik_bwd(*bwd_args))
    if split is None:
        return same, (True, "device operations per call not measured (no device time "
                            "in the trace)")
    kernels = [k for k in split if not k.startswith("Memset")]
    one = len(kernels) == 1 and all(per <= 1 for _, per in split.values())
    return same, (one, f"{per_call:g} device operations per call ("
                       + ", ".join(f"{k} {ms:.4f} ms x {per:g}" for k, (ms, per) in split.items())
                       + ")")


# A trace that lost events (seen late in a long process: the first
# operations of one of the traced calls missing) is taken again, up to this
# many traces in all. Lost events only lower the counts; the faults the
# one-launch checks look for (a second launch, another kernel) raise them,
# so only a trace short of the expected counts, with nothing unexpected in
# it, is taken again.
TRACE_TRIES = 5


def trace_lost_events(got, want):
    """Whether the launch counts ``got`` of a trace fall short of ``want``
    with nothing beyond it: the mark of a trace that lost events."""
    return got is None or (got != want and all(
        k in want and per <= want[k] for k, per in got.items()))


def retraced(attempt):
    return f" (trace {attempt + 1}: the earlier lost events)" if attempt else ""


def b1_one_launch(fn, alone=True):
    """From a ``torch.profiler`` trace of calls of ``fn``: whether no call
    launches the one-launch B1/B1r kernel (``b1_tile_kernel``) more than
    once and, alone (a B1 or B1r call), nothing but it and at most one
    memset. Returns that and the trace's report. A trace taken late in a
    long process drops events (seen: 1 of 5 calls'), so this is the check
    after :func:`phase_b1_launches`'s exact counts."""
    split, per_call = kernel_split(fn)
    if split is None:
        return True, "device operations per call not measured (no device time in the trace)"
    rest = [k for k in split if "b1_tile_kernel" not in k]
    one = all(per <= 1 for k, (_, per) in split.items() if "b1_tile_kernel" in k)
    if alone:
        one = one and all(k.startswith("Memset") and split[k][1] <= 1 for k in rest)
    return one, (f"{per_call:g} device operations per call ("
                 + ", ".join(f"{k} {ms:.4f} ms x {per:g}" for k, (ms, per) in split.items()) + ")")


# B1 and B1r's one-launch kernels above m = 4 (quasisep_loglik_generic.cu
# up to 16, quasisep_loglik_wide.cu above), as phase_b1_launches traces
# them: their names by order and storage type.
B1_TRACED_GENERIC_ORDERS = (5, 9, 16, 20, 32)


def b1_kernel_name(m, dtype):
    import torch

    t = "float" if dtype == torch.float32 else "double"
    if m <= 16:
        return f"b1_tc_kernel<{8 if m <= 8 else 16}, {t}>"
    return f"b1_wide_kernel<{24 if m <= 24 else 32}, {t}>"


def phase_b1_launches():
    """B1 and B1r at m = 1..4 and 5, 9, 16, 20, 32 in float32 and float64
    (random operands, N = 1e5; above m = 16 N = 17,161, as B3's traces
    above 16: with GB of operands allocated a trace lost launches five times
    running): one call of each is exactly one kernel launch
    (``b1_tile_kernel`` at m <= 4, ``b1_tc_kernel`` to 16,
    ``b1_wide_kernel`` above) and one memset in a ``torch.profiler``
    trace. Run first, while the process's traces still hold every event; a
    trace short of the counts with nothing else in it is taken again (at
    most ``TRACE_TRIES`` traces)."""
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    failures = []
    for dtype in (torch.float32, torch.float64):
        for m in (1, 2, 3, 4) + B1_TRACED_GENERIC_ORDERS:
            n = 100_000 if m <= 16 else N_LONG
            args = random_operands(m, n, dtype, seed=m)
            if m <= 4:
                want = {f"b1_tile_kernel<{'float' if dtype == torch.float32 else 'double'}, "
                        f"{m}, {res}>": 1.0 for res in ("false", "true")}
            else:
                want = {b1_kernel_name(m, dtype): 2.0}
            want["Memset"] = 2.0
            for attempt in range(TRACE_TRIES):
                split, per_call = kernel_split(lambda: (cuda_loglik.fused_loglik_terms(*args),
                                                        cuda_loglik.fused_loglik_res(*args)))
                got = None if split is None else {k: per for k, (_, per) in split.items()}
                ok = got == want
                if ok or not trace_lost_events(got, want):
                    break
            shown = ("no device time in the trace" if split is None else
                     ", ".join(f"{k} {ms:.4f} ms x {per:g}" for k, (ms, per) in split.items()))
            log(f"b1-launches m={m} N={n} {str(dtype)[6:]}: a B1 call and a B1r call, "
                f"{per_call:g} device operations ({shown}){retraced(attempt)} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append((m, dtype))
            del args
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"B1/B1r is not one kernel and one memset a call: {failures}")


# B3's one-launch scans, as phase_b3_launches traces them: (monoid, r,
# reverse, inclusive) at each m = 1..4, and the generic couplings.
B3_TRACED = (("aff", 1, False, False), ("aff", 16, True, True), ("cong", 1, True, False),
             ("ric", 1, False, False), ("cpl", 1, False, False))
# The generic sources' couplings, (kernel, pairs of orders, N), each pair
# in both directions: a warp a team to order 8, on the tensor cores to 16,
# a block a team above.
B3_TRACED_COUPLINGS = ((("cpl_tile_kernel",), ((2, 4), (4, 8), (6, 6), (8, 8)), 100_000),
                       (("cpl_tc_tile_kernel", "cpl_wide_kernel"),
                        ((9, 9), (10, 10), (16, 16), (18, 18), (32, 32)), N_LONG))
# The generic sources' one-launch Riccati flow, affine and congruence
# scans: (kernel, (monoid, r, reverse, inclusive) ..., orders, N): the
# congruence at every order to 16, in both directions, at N_LONG; above 16
# each at N_LONG.
B3_TRACED_GENERIC_ORDERS = (5, 8, 12, 16)
B3_TRACED_WIDE_ORDERS = (17, 20, 24, 32)
B3_TRACED_GENERIC = ((("ric_tile_kernel",), (("ric", 1, False, False),),
                      B3_TRACED_GENERIC_ORDERS, 100_000),
                     (("aff_tile_kernel",), (("aff", 1, False, False), ("aff", 16, True, True)),
                      B3_TRACED_GENERIC_ORDERS, 100_000),
                     (("cong_tile_kernel",), (("cong", 1, True, False), ("cong", 1, False, False)),
                      tuple(range(5, 17)), N_LONG),
                     (("ric_wide_kernel", "aff_wide_kernel", "cong_wide_kernel"),
                      (("ric", 1, False, False), ("aff", 1, False, False), ("aff", 16, True, True),
                       ("cong", 1, True, False), ("cong", 1, False, False)),
                      B3_TRACED_WIDE_ORDERS, N_LONG))


def b3_one_launch(calls, names):
    """From a ``torch.profiler`` trace of the scans ``calls`` (each
    ``(monoid, m, m2, r, reverse, inclusive, operands)``): whether each is
    one launch of a kernel whose name holds one of ``names`` and one
    memset, and nothing else runs; and the trace's report. A trace short of those
    counts with nothing else in it lost events and is taken again (at most
    ``TRACE_TRIES`` traces)."""
    for attempt in range(TRACE_TRIES):
        split, per_call = kernel_split(lambda: [
            scan_kernel(monoid, m, r, reverse, inclusive, ops, m2=m2)
            for monoid, m, m2, r, reverse, inclusive, ops in calls], calls=2)
        if split is None:
            continue
        ours = [k for k in split if any(name in k for name in names)]
        kernels = sum(split[k][1] for k in ours)
        memsets = sum(per for k, (_, per) in split.items() if k.startswith("Memset"))
        others = [k for k in split if k not in ours and not k.startswith("Memset")]
        ok = kernels == memsets == len(calls) == per_call / 2 and not others
        if ok or others or kernels > len(calls) or memsets > len(calls):
            break
    if split is None:
        return False, "no device time in the trace"
    return ok, (f"{len(calls)} scans, {per_call:g} device operations per set ("
                + ", ".join(f"{k} {ms:.4f} ms x {per:g}" for k, (ms, per) in split.items())
                + ")" + retraced(attempt))


def phase_b3_launches():
    """B3's one-launch scans on random operands at N = 1e5, in float32 and
    float64: at each m = 1..4 the affine scan with 1 and 16 columns, the
    congruence, the Riccati flow and the coupling (``b3_tile_kernel``), and
    the couplings (2, 4), (4, 8), (6, 6) and (8, 8) (``cpl_tile_kernel``),
    (9, 9), (10, 10) and (16, 16) (``cpl_tc_tile_kernel``), (18, 18) and
    (32, 32) (``cpl_wide_kernel``) in both directions at N = 17,161, at m = 5, 8, 12 and
    16 the Riccati flow (``ric_tile_kernel``) and the affine scan with 1
    and 16 columns (``aff_tile_kernel``), and at every m = 5..16 the
    congruence scan in both directions (``cong_tile_kernel``, at N =
    17,161), and at N = 17,161 at m = 17, 20, 24 and 32 the same
    (``ric_wide_kernel``, ``aff_wide_kernel``, ``cong_wide_kernel``): in a
    ``torch.profiler`` trace each scan is one kernel and one memset. The traces run first with
    B1's, while the process's traces still hold every event; each set's
    operands are made just before its trace and freed after it (with
    several GB of operands allocated, traces lost the first launches of
    every set)."""
    import torch

    # The templated sets at N_LONG, to leave the script's time to the
    # generic orders' traces.
    n, failures = N_LONG, []
    sets = [(f"m={m}", ("b3_tile_kernel",), n, lambda m=m: [
        (monoid, m, m, r, rev, incl, scan_operands(monoid, m, n, r, dtype, seed=m))
        for dtype in (torch.float32, torch.float64)
        for monoid, r, rev, incl in B3_TRACED]) for m in (1, 2, 3, 4)]
    for names, pairs, n_set in B3_TRACED_COUPLINGS:
        sets.append(("couplings " + ", ".join(f"{a}x{b}" for a, b in pairs), names, n_set,
                     lambda pairs=pairs, n_set=n_set: [
                         ("cpl", a, b, 1, rev, rev,
                          scan_operands("cpl", a, n_set, 1, dtype, seed=a + b, m2=b))
                         for dtype in (torch.float32, torch.float64)
                         for a, b in pairs for rev in (False, True)]))
    for names, variants, orders, n_set in B3_TRACED_GENERIC:
        sets.append(("/".join(name.split("_")[0] for name in names) + " m="
                     + ", ".join(map(str, orders)), names, n_set,
                     lambda variants=variants, orders=orders, n_set=n_set: [
                         (monoid, m, m, r, rev, incl,
                          scan_operands(monoid, m, n_set, r, dtype, seed=m))
                         for dtype in (torch.float32, torch.float64)
                         for m in orders
                         for monoid, r, rev, incl in variants]))
    for label, names, n_set, make in sets:
        calls = make()
        ok, report = b3_one_launch(calls, names)
        log(f"b3-launches {label} N={n_set} float32 and float64: {report} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
        del calls
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"B3 is not one kernel and one memset a scan: {failures}")


B2_TRACED_ORDERS = (9, 12, 16, 20, 32)


def phase_b2_launches():
    """B2 at m = 9, 12, 16, 20 and 32 in float32 and float64 (random
    operands and B1r's residuals, N = 1e5; N = 17,161 above 16, as
    :func:`phase_b1_launches`): one call is exactly one ``b2_tc_kernel``
    launch (``b2_wide_kernel`` above 16) and one memset in a
    ``torch.profiler`` trace, as :func:`phase_b1_launches` traces B1 (a
    trace short of the counts with nothing else in it is taken again)."""
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    failures = []
    for dtype in (torch.float32, torch.float64):
        for m in B2_TRACED_ORDERS:
            n = 100_000 if m <= 16 else N_LONG
            args = random_operands(m, n, dtype, seed=m)
            res = cuda_loglik.fused_loglik_res(*args)
            qbar, lbar = (torch.tensor(v, dtype=dtype, device="cuda") for v in (-0.5, -1.0))
            bwd_args = (*args[1:], *res[2:], qbar, lbar)
            t = "float" if dtype == torch.float32 else "double"
            want = {(f"b2_tc_kernel<{t}>" if m <= 16 else
                     f"b2_wide_kernel<{24 if m <= 24 else 32}, {t}>"): 1.0, "Memset": 1.0}
            for attempt in range(TRACE_TRIES):
                split, per_call = kernel_split(lambda: cuda_loglik.fused_loglik_bwd(*bwd_args))
                got = None if split is None else {k: per for k, (_, per) in split.items()}
                ok = got == want
                if ok or not trace_lost_events(got, want):
                    break
            shown = ("no device time in the trace" if split is None else
                     ", ".join(f"{k} {ms:.4f} ms x {per:g}" for k, (ms, per) in split.items()))
            log(f"b2-launches m={m} N={n} {str(dtype)[6:]}: a B2 call, {per_call:g} device "
                f"operations ({shown}){retraced(attempt)} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append((m, dtype))
            del args, res, bwd_args
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"B2 is not one kernel and one memset a call: {failures}")


def phase_gradient_path():
    """The gradient main path at full size; returns the JSON records of B1r
    and B2, with their launches on this path."""
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    records = {}
    launches = [0, 0, 0]
    failures = []
    for label, (Xn, yn) in zip(("n1e5", "n1e6"), bench_data()):
        X, y = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (Xn, yn))
        n = X.shape[0]

        # The main path, once, with the launch counts read around it.
        reset_counts()
        g32 = matern32_grad(X, y)
        torch.cuda.synchronize()
        counts = read_counts()
        launches = [a + b for a, b in zip(launches, counts)]

        g64 = matern32_grad(X.double(), y.double())
        g_plain = matern32_plain_grad(X, y)
        g_mixed = matern32_grad_f64_kernels(X, y)
        errs = [rel_err(float(a), float(b)) for a, b in zip(g32, g64)]
        plain_errs = [rel_err(float(a), float(b)) for a, b in zip(g_plain, g64)]
        mixed_errs = [rel_err(float(a), float(b)) for a, b in zip(g_mixed, g64)]
        kernel_errs = [
            abs(float(a) - float(b)) / abs(float(w)) for a, b, w in zip(g32, g_mixed, g64)
        ]
        finite = all(math.isfinite(float(g)) for g in g32)
        grad_ok = all(e <= max(5e-4, pe) for e, pe in zip(errs, plain_errs)) and all(
            e <= KERNEL_GRAD_LIMITS[label] for e in kernel_errs
        )

        whole_ms = cuda_ms(lambda: matern32_grad(X, y), reps=20, warmup=3)

        # Each kernel against its plain version on the main path's operands:
        # in float32 as the caller runs it, and in float64 on the same
        # values, which is the kernels' own arithmetic.
        with torch.no_grad():
            gp = matern32_gp(X, torch.tensor(1.5), torch.tensor(2.5))
            d, ps, qs, as_ = gp.solver.ssm
            r = (y - gp.loc).contiguous()
            ops32 = (d, ps, qs, as_, r)
            ops64 = tuple(x.double() for x in ops32)
            qbar, lbar = (torch.tensor(v, device="cuda") for v in (-0.5, -1.0))
            res = cuda_loglik.fused_loglik_res(*ops32)
            bwd_args = (*ops32[1:], *res[2:], qbar, lbar)
            bars = cuda_loglik.fused_loglik_bwd(*bwd_args)
            res_err32 = stream_errors(res, cuda_loglik.plain_loglik_terms_res(*ops32))
            res_err64 = stream_errors(res, cuda_loglik.plain_loglik_terms_res(*ops64))
            bwd_err32 = stream_errors(bars, cuda_loglik.plain_loglik_bwd(*bwd_args))
            bwd_err64 = stream_errors(
                bars, cuda_loglik.plain_loglik_bwd(*(x.double() for x in bwd_args))
            )
            b2_same, b2_ops = b2_launch_checks(bwd_args, bars)
            kernels_ok = (
                max(e for e, _ in res_err64) <= 5e-4
                and max(e for e, _ in bwd_err64) <= 5e-4
                and max(e for e, _ in res_err32[:2]) <= 5e-4
                and b2_same and b2_ops[0]
            )

            res_ms = cuda_ms(lambda: cuda_loglik.fused_loglik_res(*ops32), reps=50, warmup=3)
            bwd_ms = cuda_ms(lambda: cuda_loglik.fused_loglik_bwd(*bwd_args), reps=50, warmup=3)
            plain_res_ms = cuda_ms(
                lambda: cuda_loglik.plain_loglik_terms_res(*ops32), reps=3, warmup=1
            )
            plain_bwd_ms = cuda_ms(
                lambda: cuda_loglik.plain_loglik_bwd(*bwd_args), reps=3, warmup=1
            )
            b1r_one, b1r_ops = b1_one_launch(lambda: cuda_loglik.fused_loglik_res(*ops32))
        m = ps.shape[0]
        res_bound, res_by = loglik_bound_ms(m, n, 4, residuals=True)
        bwd_bound, bwd_by = bwd_bound_ms(m, n, 4)
        ok = counts == [0, 1, 1] and finite and grad_ok and kernels_ok and b1r_one
        log(
            f"gradient-path matern32_{label} m={m} N={n} float32: grad (amp, scale) "
            f"{[float(g) for g in g32]}, float64 kernel {[float(g) for g in g64]}, "
            f"float32 plain {[float(g) for g in g_plain]}; rel err of float32 kernel "
            f"{[f'{e:.3e}' for e in errs]}, of float32 plain "
            f"{[f'{e:.3e}' for e in plain_errs]} (limit: the larger of 5e-4 and "
            f"the plain's); float32 operands with float64 kernels "
            f"{[float(g) for g in g_mixed]}, rel err {[f'{e:.3e}' for e in mixed_errs]}; "
            f"float32 kernel against float64 kernels on the float32 operands "
            f"{[f'{e:.3e}' for e in kernel_errs]} of the float64 gradient (limit "
            f"{KERNEL_GRAD_LIMITS[label]:g}); launches B1 {counts[0]} B1r {counts[1]} "
            f"B2 {counts[2]}"
        )
        log(
            f"gradient-path matern32_{label}: B1r vs plain rel err per stream "
            f"(quad, logdet, F, e, 1/c) float32 {[f'{e:.2e}' for e, _ in res_err32]}, "
            f"float64 {[f'{e:.2e}' for e, _ in res_err64]}; B2 vs plain (dbar, psbar, "
            f"qsbar, asbar, ybar) float32 {[f'{e:.2e}' for e, _ in bwd_err32]}, "
            f"float64 {[f'{e:.2e}' for e, _ in bwd_err64]} (rtol 5e-4 against "
            f"float64; the sums also against float32); B2 a second launch equal bit for "
            f"bit {b2_same}, {b2_ops[1]}; B1r {b1r_ops}"
        )
        log(
            f"gradient-path matern32_{label}: whole forward+backward {whole_ms:.4f} ms, "
            f"B1r {res_ms:.4f} ms (bound {res_bound:.4f} ms, {res_by}; plain "
            f"{plain_res_ms:.4f} ms), B2 {bwd_ms:.4f} ms (bound {bwd_bound:.4f} ms, "
            f"{bwd_by}; plain {plain_bwd_ms:.4f} ms) {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            failures.append(label)
        if label == "n1e6":
            common = {"route": "cuda", "library_ms": None}
            records["res"] = dict(
                common,
                name="quasisep_loglik_res",
                source="tinygp_tpu_torch/csrc/quasisep_loglik.cu",
                replaces="tinygp_tpu/solvers/quasisep/pallas_loglik.py:86 residuals=True",
                max_abs_err=max(a for _, a in res_err64),
                ms=res_ms,
                plain_ms=plain_res_ms,
                bound_ms=res_bound,
                bound_by=res_by,
            )
            records["bwd"] = dict(
                common,
                name="quasisep_loglik_bwd",
                source="tinygp_tpu_torch/csrc/quasisep_loglik_bwd.cu",
                replaces="tinygp_tpu/solvers/quasisep/pallas_loglik.py:414",
                max_abs_err=max(a for _, a in bwd_err64),
                ms=bwd_ms,
                plain_ms=plain_bwd_ms,
                bound_ms=bwd_bound,
                bound_by=bwd_by,
            )
    if failures:
        raise AssertionError(f"gradient path failed: {failures}")
    records["res"]["launches"] = launches[1]
    records["bwd"]["launches"] = launches[2]
    return records


def phase_trainer():
    """``fit_map`` on the Matern32 model's log hyperparameters at N = 1e5
    and 1e6; returns the launches of B1, B1r and B2 over the two fits."""
    import torch

    from tinygp_tpu_torch import fit_map

    steps = 20
    total = [0, 0, 0]
    for Xn, yn in bench_data():
        X, y = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (Xn, yn))

        def loss_fn(p):
            gp = matern32_gp(X, torch.exp(p["log_amp"]), torch.exp(p["log_scale"]))
            return -gp.log_probability(y)

        # Python numbers, as a user starts a fit: fit_map puts them on the
        # card in the requested dtype.
        init = {"log_amp": math.log(1.5), "log_scale": math.log(2.5)}
        # A two-step fit first: the first use of each CUDA function (Adam's
        # among them) loads its module, which is set-up, not a step.
        fit_map(loss_fn, init, num_steps=2, learning_rate=0.05, dtype=torch.float32)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit_map(loss_fn, init, num_steps=steps, learning_rate=0.05, dtype=torch.float32)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / steps * 1e3
        counts = read_counts()
        total = [a + b for a, b in zip(total, counts)]
        losses = [float(x) for x in res.losses]
        with torch.no_grad():
            again = float(loss_fn(res.params))
        best = float(res.loss)

        def step():
            p = {k: v.detach().requires_grad_() for k, v in res.params.items()}
            return torch.autograd.grad(loss_fn(p), list(p.values()))

        b1r_one, b1r_ops = b1_one_launch(step, alone=False)
        ok = (
            b1r_one
            and all(math.isfinite(x) for x in losses)
            and all(v.is_cuda and v.dtype == torch.float32 for v in res.params.values())
            and best < losses[0]
            and rel_err(again, best) <= 5e-4
            and counts == [0, steps, steps]
        )
        log(
            f"trainer fit_map matern32 N={X.shape[0]} float32, {steps} Adam steps at "
            f"lr 0.05: losses {losses[0]!r} -> {losses[-1]!r}, best {best!r} at "
            f"{ {k: float(v) for k, v in res.params.items()} }, re-evaluated "
            f"{again!r}; {step_ms:.4f} ms per step (host clock, forward and "
            f"backward); launches B1 {counts[0]} B1r {counts[1]} B2 {counts[2]}; a step's "
            f"trace: {b1r_ops} {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            raise AssertionError(f"trainer failed at N={X.shape[0]}")
    return total

# ---------------------------------------------------------------------------
# Kernel B3 and the conditioning path.
# ---------------------------------------------------------------------------

# (monoid, reverse, inclusive, columns): every direction and output of B3.
SCAN_VARIANTS = [
    ("aff", False, False, 1),
    ("aff", True, False, 1),
    ("aff", False, True, 1),
    ("aff", True, True, 1),
    ("aff", False, False, 8),
    ("aff", True, False, 8),
    ("aff", False, True, 8),
    ("aff", True, True, 8),
    ("cong", False, False, 1),
    ("cong", True, False, 1),
    ("ric", False, False, 1),
    ("cpl", False, False, 1),
    ("cpl", True, False, 1),
]


# The generic-order sources: a subset of the variants above at each order
# (every monoid, both directions, both outputs, 1 and 8 columns), and the
# coupling of unequal orders.
GENERIC_ORDERS = (5, 8, 12, 16)
GENERIC_SCAN_VARIANTS = [
    ("aff", False, False, 1),
    ("aff", True, True, 8),
    ("cong", True, False, 1),
    ("ric", False, False, 1),
    ("cpl", False, False, 1),
    ("cpl", True, True, 1),
]
COUPLING_PAIRS = ((2, 4), (4, 8), (6, 6))
# Above the generic source's one-warp orders: every monoid at m = 17..32
# (either padding), and the couplings whose larger order is 9..32, equal and
# unequal (phase 16 holds the path's (9, 9), (10, 10) and (18, 18)).
WIDE_ORDERS = (20, 32)
WIDE_COUPLING_PAIRS = ((16, 16), (5, 16), (16, 5), (20, 9), (32, 32))


def scan_operands(monoid, m, n, r, dtype, seed, m2=None):
    """B3's operands for one monoid on the card: contracting transitions
    from ``random_qsm_operands`` and normal loads; ``m2`` is the
    coupling's second order (``m`` if not given)."""
    import torch

    from tinygp_tpu_torch.test_utils import random_qsm_operands

    m2 = m if m2 is None else m2
    d, ps, qs, as_, _ = random_qsm_operands(m, n, seed)
    rng = np.random.default_rng(seed + 1)
    if monoid == "aff":
        arrays = (as_, rng.normal(size=(m * r, n)))
    elif monoid == "cong":
        arrays = (as_, rng.normal(size=(m * m, n)))
    elif monoid == "ric":
        arrays = (d, ps, qs, as_)
    else:
        arrays = (as_, random_qsm_operands(m2, n, seed + 2)[3], rng.normal(size=(m * m2, n)))
    return [torch.as_tensor(x, dtype=dtype, device="cuda") for x in arrays]


def scan_kernel(monoid, m, r, reverse, inclusive, operands, m2=None):
    """B3 through its wrapper."""
    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    if monoid == "aff":
        return cuda_scan.affine(*operands, m, r, reverse=reverse, exclusive=not inclusive)
    if monoid == "cong":
        return cuda_scan.congruence(*operands, m, reverse=reverse)
    if monoid == "ric":
        return cuda_scan.riccati(*operands)
    m2 = m if m2 is None else m2
    return cuda_scan.coupling(*operands, m, m2, reverse=reverse, exclusive=not inclusive)


def scan_plain(monoid, m, r, reverse, inclusive, operands, m2=None):
    """B3's plain version, the stacked scans of ``scan.py``, on the same
    tensors."""
    from tinygp_tpu_torch.solvers.quasisep import scan

    if monoid == "aff":
        return scan._affine_scan_s(*operands, m, r, reverse=reverse, exclusive=not inclusive)
    if monoid == "cong":
        return scan._congruence_scan_s(*operands, m, reverse=reverse)
    if monoid == "ric":
        return scan._riccati_scan_s(*operands, m)
    m2 = m if m2 is None else m2
    return scan._coupling_scan_s(
        *operands, m, m2, reverse=reverse, exclusive=not inclusive
    )


def scan_bound_ms(monoid, m, r, n, itemsize, m2=None):
    """Least time for one B3 scan: read each operand and write the state
    once, or do the sequential recurrence's operations (per element:
    A g + B, 2m^2 + m per column; A g A^T + B, 4m^3 + m^2; the Riccati
    step, 4m^3 + 6m^2 + 3m + 2; A g B^T + C with g of m x m2,
    2 m^2 m2 + 2 m m2^2 + m m2)."""
    m2 = m if m2 is None else m2
    values, flops = {
        "aff": (m * m + 2 * m * r, (2 * m * m + m) * r),
        "cong": (3 * m * m, 4 * m**3 + m * m),
        "ric": (1 + 2 * m + 2 * m * m, 4 * m**3 + 6 * m * m + 3 * m + 2),
        "cpl": (m * m + m2 * m2 + 2 * m * m2, 2 * m * m * m2 + 2 * m * m2 * m2 + m * m2),
    }[monoid]
    return bound_ms(values * n * itemsize, flops * n)


def phase_scan_vs_plain():
    import torch

    cases = [(m, N_LONG, torch.float64, 1e-8) for m in (1, 2, 3, 4)]
    cases += [(m, N_LONG, torch.float32, 5e-4) for m in (1, 2, 3, 4)]
    cases += [(2, 1_000_000, torch.float32, 5e-4)]
    failures = []
    for m, n, dtype, rtol in cases:
        parts = []
        for monoid, reverse, inclusive, r in SCAN_VARIANTS:
            operands = scan_operands(monoid, m, n, r, dtype, seed=10 * m)
            got = scan_kernel(monoid, m, r, reverse, inclusive, operands)
            want = scan_plain(monoid, m, r, reverse, inclusive, operands)
            (err, _), = stream_errors([got], [want])
            ok = err <= rtol and bool(torch.isfinite(got).all())
            tag = f"{monoid}{'-rev' if reverse else ''}{'-incl' if inclusive else ''}-r{r}"
            parts.append(f"{tag} {err:.2e}{'' if ok else ' FAIL'}")
            if not ok:
                failures.append((tag, m, n, dtype))
        log(
            f"kernel-vs-plain B3 m={m} N={n} {str(dtype)[6:]}: rel err per stream "
            f"(rtol {rtol:g}): {', '.join(parts)}"
        )

    # The generic-order sources, at N_LONG: every order of the slice's path,
    # the congruence scan at every order to 16 in both directions, every
    # monoid at m = 17, 20, 24 and 32, and the couplings of unequal orders
    # and above order 8, with their launches counted; each second launch
    # equal bit for bit.
    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    t0 = time.perf_counter()
    for dtype, rtol in ((torch.float64, 1e-8), (torch.float32, 5e-4)):
        cases = [(m, m, v) for m in GENERIC_ORDERS for v in GENERIC_SCAN_VARIANTS]
        cases += [(m, m, ("cong", m not in GENERIC_ORDERS, False, 1)) for m in range(5, 17)]
        cases += [(m1, m2, ("cpl", rev, rev, 1)) for m1, m2 in COUPLING_PAIRS + WIDE_COUPLING_PAIRS
                  for rev in (False, True)]
        cases += [(m, m, v) for m in WIDE_ORDERS for v in GENERIC_SCAN_VARIANTS]
        for m, m2, (monoid, reverse, inclusive, r) in cases:
            operands = scan_operands(monoid, m, N_LONG, r, dtype, seed=10 * m + m2, m2=m2)
            before = cuda_scan.LAUNCHES_GENERIC[monoid]
            got = scan_kernel(monoid, m, r, reverse, inclusive, operands, m2=m2)
            launched = cuda_scan.LAUNCHES_GENERIC[monoid] - before
            one = cuda_scan.b3_schedule(monoid, m, r, dtype, m2=m2) is not None
            same = not one or torch.equal(
                got, scan_kernel(monoid, m, r, reverse, inclusive, operands, m2=m2))
            want = scan_plain(monoid, m, r, reverse, inclusive, operands, m2=m2)
            (err, _), = stream_errors([got], [want])
            ok = err <= rtol and bool(torch.isfinite(got).all()) and launched == 1 and same
            tag = (f"{monoid}{'-rev' if reverse else ''}{'-incl' if inclusive else ''}-r{r} "
                   f"m={m}" + (f"x{m2}" if monoid == "cpl" else ""))
            log(f"kernel-vs-plain B3 generic {tag} N={N_LONG} {str(dtype)[6:]}: rel err "
                f"{err:.2e} (rtol {rtol:g}), generic launches {launched}"
                f"{', a second launch equal bit for bit ' + str(same) if one else ''} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append((tag, N_LONG, dtype))
    log(f"kernel-vs-plain B3 generic: {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError(f"B3 disagrees with its plain version: {failures}")


def sho_closed_form(tau, omega, quality):
    """SHO's kernel for quality > 1/2 (celerite's underdamped term)."""
    eta = math.sqrt(1.0 - 1.0 / (4.0 * quality**2))
    arg = eta * omega * tau
    return np.exp(-omega * tau / (2.0 * quality)) * (
        np.cos(arg) + np.sin(arg) / (2.0 * eta * quality)
    )


def example_data():
    """``examples/quasisep_lightcurve.py``'s draws at full size, thinned as
    its conditioning thins them: t, y of N = 5000 in float32."""
    rng = np.random.default_rng(11)
    n = 100_000
    t = np.sort(rng.uniform(0, 100, n)).astype(np.float32)
    y = (np.sin(2.1 * t) * np.exp(-0.01 * t) + 0.5 * rng.normal(size=n)).astype(np.float32)
    return t[::20], y[::20]


def dense_posterior(t, y, t_test, kernel, diag, post_jitter):
    """The log probability, the posterior mean at t and t_test and the
    posterior variance at t, by dense float64 linear algebra."""
    import scipy.linalg

    K = kernel(np.abs(t[:, None] - t[None, :]))
    n = t.shape[0]
    L = np.linalg.cholesky(K + diag * np.eye(n))
    alpha = scipy.linalg.cho_solve((L, True), y)
    logp = -0.5 * y @ alpha - np.sum(np.log(np.diag(L))) - 0.5 * n * math.log(2 * math.pi)
    V = scipy.linalg.solve_triangular(L, K, lower=True)
    var = np.diag(K) + post_jitter - np.sum(V * V, axis=0)
    mu_test = kernel(np.abs(t_test[:, None] - t[None, :])) @ alpha
    return logp, K @ alpha, var, mu_test


def rel_max(got, want):
    """Largest error relative to the reference's largest magnitude."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def phase_example_condition():
    """The light-curve example's conditioning at its size."""
    import torch

    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep
    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    omega, quality, diag = 2.1, 2.0, 0.25
    lags = torch.tensor([0.0, 0.05, 0.4, 1.3, 3.7], dtype=torch.float64)
    port = quasisep.SHO(omega=omega, quality=quality).evaluate(torch.zeros_like(lags), lags)
    form_err = rel_max(port.numpy(), sho_closed_form(lags.numpy(), omega, quality))
    log(f"example: SHO closed form against the port's evaluate at lags {lags.tolist()}: rel err {form_err:.2e}")
    if form_err > 1e-12:
        raise AssertionError("the SHO closed form disagrees with the port")

    t, y = example_data()
    t_test = np.linspace(10.0, 20.0, 500, dtype=np.float32)
    want = dense_posterior(
        t.astype(np.float64), y.astype(np.float64), t_test.astype(np.float64),
        lambda tau: sho_closed_form(tau, omega, quality), diag,
        math.sqrt(np.finfo(np.float64).eps),
    )
    for dtype in (torch.float32, torch.float64):
        gp = GaussianProcess(
            1.0 * quasisep.SHO(omega=omega, quality=quality),
            torch.as_tensor(t, dtype=dtype), diag=diag, assume_sorted=True,
        )
        reset_counts()
        log_prob, post = gp.condition(y)
        mu = gp.predict(y, t_test)
        got = (log_prob.item(), post.loc.cpu().numpy(), post.variance.cpu().numpy(), mu.cpu().numpy())
        torch.cuda.synchronize()
        counts = dict(cuda_scan.LAUNCHES)
        finite = math.isfinite(got[0]) and all(np.isfinite(x).all() for x in got[1:])
        shapes = got[1].shape == got[2].shape == (5000,) and got[3].shape == (500,)
        # One Riccati flow, the factor; for float32 a second one, the
        # float64 twin's that predicts at the new points (C7).
        ok = (finite and shapes and float(got[2].min()) > 0
              and counts["ric"] == (2 if dtype == torch.float32 else 1))
        errs = [rel_err(got[0], want[0])] + [rel_max(g, w) for g, w in zip(got[1:], want[1:])]
        if dtype == torch.float64:
            ok = ok and errs[0] <= 1e-9 and max(errs[1:]) <= 1e-8
        log(
            f"example condition SHO(2.1, 2.0) N=5000 {str(dtype)[6:]}: log prob {got[0]!r} "
            f"(dense {want[0]!r}); against the dense float64 posterior: log prob rel "
            f"{errs[0]:.2e}, mean {errs[1]:.2e}, variance {errs[2]:.2e}, predict at 500 "
            f"new points {errs[3]:.2e} (of the largest magnitude; float64 limits 1e-9 and "
            f"1e-8); min variance {float(got[2].min())!r}; B3 launches {counts} "
            f"{'ok' if ok else 'FAIL'}"
        )
        if not ok:
            raise AssertionError(f"example conditioning failed in {dtype}")


def phase_condition_path():
    """The conditioning main path at the headline data; returns B3's JSON
    records, one per monoid and shape the path runs."""
    import torch

    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik, cuda_scan, scan

    (X5, y5), _ = bench_data()
    X, y = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (X5, y5))
    X_test = torch.linspace(0, 10, 1000, dtype=torch.float32, device="cuda")
    n = X.shape[0]

    def model(X, device=None):
        return GaussianProcess(
            1.5 * quasisep.Matern32(scale=2.5), X, diag=0.1, assume_sorted=True, device=device
        )

    def run(gp, y, generator):
        log_prob, post = gp.condition(y)
        out = (log_prob, post.loc, post.variance, gp.predict(y, X_test.to(gp.device, gp.dtype)))
        return out + (gp.sample(generator, (16,)),)

    # The main path, once: every count set to 0 before it and read after;
    # B3's calls recorded with their operands, and any call of the plain
    # blocked scan on a CUDA tensor counted.
    calls, plain_on_card = [], [0]
    launch, monoid_scan = cuda_scan._launch, scan.monoid_scan

    def recording_launch(monoid, m, r, reverse, inclusive, operands, out_rows, m2=None):
        calls.append((monoid, m, r, reverse, inclusive, operands))
        return launch(monoid, m, r, reverse, inclusive, operands, out_rows, m2=m2)

    def counting_scan(combine, identity, elems, **kwargs):
        plain_on_card[0] += elems[0].is_cuda
        return monoid_scan(combine, identity, elems, **kwargs)

    cuda_scan._launch, scan.monoid_scan = recording_launch, counting_scan
    try:
        reset_counts()
        gp = model(X)
        out32 = run(gp, y, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        counts = dict(cuda_scan.LAUNCHES)
        b1 = read_counts()
    finally:
        cuda_scan._launch, scan.monoid_scan = launch, monoid_scan

    log_prob, loc, var32, mu, draws = out32
    lp_b1 = gp.log_probability(y).item()
    shapes = (loc.shape, var32.shape, mu.shape, draws.shape) == ((n,), (n,), (1000,), (16, n))
    finite = all(bool(torch.isfinite(x).all()) for x in out32)
    lp_err = rel_err(log_prob.item(), lp_b1)
    path_ok = (
        shapes and finite and lp_err <= 5e-4 and plain_on_card[0] == 0
        and all(counts[k] > 0 for k in ("aff", "ric", "cpl"))
    )
    log(
        f"condition-path matern32 N={n} float32: log prob {log_prob.item()!r} vs B1's "
        f"{lp_b1!r} (rel {lp_err:.2e}, limit 5e-4); loc, variance {tuple(var32.shape)}, "
        f"predict {tuple(mu.shape)}, sample {tuple(draws.shape)}, finite {finite}; "
        f"min variance {float(var32.min())!r}; B3 launches {counts}, plain scans on the "
        f"card {plain_on_card[0]}, B1/B1r/B2 launches {b1} {'ok' if path_ok else 'FAIL'}"
    )

    # The float64 variance on the card against the float64 plain version
    # (the CPU run) on the same operands. The posterior variance is the
    # small difference of the prior variance and M K^-1 M, so two float64
    # computations agree only to float64 rounding of those terms: the
    # error is taken relative to the largest prior variance, and also
    # printed relative to the posterior variance's own largest magnitude.
    X64, y64 = X.double(), y.double()
    prior = model(X64)
    card = prior.condition(y64)
    cpu = model(X64.cpu(), device="cpu").condition(y64.cpu())
    scale = float(prior.variance.abs().max())
    var_card = card[1].variance.cpu().numpy()
    var_cpu = cpu[1].variance.numpy()
    var_err = float(np.max(np.abs(var_card - var_cpu))) / scale
    var_own = rel_max(var_card, var_cpu)
    loc_err = rel_max(card[1].loc.cpu(), cpu[1].loc)
    lp64_err = rel_err(card[0].item(), cpu[0].item())
    # C8: the float32 process conditions through its float64 twin, so its
    # mean and variance at the training points hold to the card's float64
    # ones within 5e-4 of their largest magnitudes, and no variance is
    # negative (in float32 arithmetic the variance was 0.60 off at 1e4).
    f32_var = rel_max(var32.double().cpu(), var_card)
    f32_loc = rel_max(loc.double().cpu(), card[1].loc.cpu())
    f32_ok = max(f32_var, f32_loc) <= 5e-4 and float(var32.min()) > 0
    f64_ok = (max(var_err, loc_err, lp64_err) <= 1e-8 and float(var_card.min()) > 0
              and f32_ok)
    log(
        f"condition-path matern32 N={n} float64: card against the plain version on "
        f"the CPU: variance {var_err:.2e} of the largest prior variance {scale!r} "
        f"({var_own:.2e} of its own largest magnitude {float(np.max(np.abs(var_cpu)))!r}), "
        f"loc {loc_err:.2e}, log prob {lp64_err:.2e} (limit 1e-8); posterior variance "
        f"in [{float(var_card.min())!r}, {float(var_card.max())!r}]; C8: the float32 "
        f"variance and mean against the card's float64 ones {f32_var:.2e}, {f32_loc:.2e} of "
        f"their largest magnitudes (limit 5e-4), smallest float32 variance "
        f"{float(var32.min())!r} {'ok' if f64_ok else 'FAIL'}"
    )

    # Each entry point alone: its B3 launches and its CUDA-event time.
    entry_points = {
        "condition": lambda: (lambda r: (r[0], r[1].loc, r[1].variance))(model(X).condition(y)),
        "predict": lambda: model(X).predict(y, X_test),
        "sample": lambda: model(X).sample(torch.Generator(device="cuda").manual_seed(1), (16,)),
    }
    for name, fn in entry_points.items():
        reset_counts()
        fn()
        torch.cuda.synchronize()
        launched = {k: v for k, v in cuda_scan.LAUNCHES.items() if v}
        ms = cuda_ms(fn, reps=10, warmup=2)
        log(f"condition-path entry {name} (constructor included): {ms:.4f} ms, B3 launches {launched}")

    # B3 per monoid and shape at the path's operands, beside its bound and
    # its plain version.
    records = []
    seen = {}
    for call in calls:
        key = (*call[:3], call[5][0].dtype)
        seen.setdefault(key, []).append(call)
    for (monoid, m, r, dtype), group in seen.items():
        _, _, _, reverse, inclusive, operands = group[0]
        f64 = dtype == torch.float64
        got = scan_kernel(monoid, m, r, reverse, inclusive, operands)
        # Against the plain version in float64 on the same values, which
        # is the kernel's own arithmetic, and in the caller's type as the
        # caller runs it (the float64 scans are those of the float64 twin
        # that predicts at new points).
        want64 = scan_plain(monoid, m, r, reverse, inclusive, [x.double() for x in operands])
        (rel, abs_err), = stream_errors([got], [want64])
        (rel_own, _), = stream_errors([got], [scan_plain(monoid, m, r, reverse, inclusive,
                                                         operands)])
        ms = cuda_ms(lambda: scan_kernel(monoid, m, r, reverse, inclusive, operands), reps=30, warmup=3)
        plain_ms = cuda_ms(lambda: scan_plain(monoid, m, r, reverse, inclusive, operands), reps=3, warmup=1)
        bound, by = scan_bound_ms(monoid, m, r, operands[0].shape[-1], operands[0].element_size())
        rtol = 1e-8 if f64 else 5e-4
        log(
            f"condition-path B3 {monoid} m={m} r={r} N={operands[0].shape[-1]} "
            f"{str(dtype)[6:]} ({len(group)} launches on the path, first "
            f"{'reverse' if reverse else 'forward'} {'inclusive' if inclusive else 'exclusive'}): "
            f"{ms:.4f} ms, bound {bound:.4f} ms ({by}), plain {plain_ms:.4f} ms; against the "
            f"plain version in float64 rel {rel:.2e} (limit {rtol:g}), abs {abs_err:.3e}; in "
            f"{str(dtype)[6:]} rel {rel_own:.2e}"
        )
        path_ok = path_ok and rel <= rtol
        records.append({
            "name": f"quasisep_scan_{monoid}_m{m}" + (f"_r{r}" if r > 1 else "")
            + ("_f64" if f64 else ""),
            "route": "cuda",
            "source": "tinygp_tpu_torch/csrc/quasisep_scan.cu",
            "replaces": "tinygp_tpu/solvers/quasisep/pallas_scan.py:331",
            "launches": len(group),
            "max_abs_err": abs_err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,
        })
    if not (path_ok and f64_ok):
        raise AssertionError("conditioning path failed")
    return records


# ---------------------------------------------------------------------------
# Every quasiseparable order: the generic-order sources on the slice's path.
# ---------------------------------------------------------------------------

def celerite2():
    """``bench.py:331-345``'s 2-term celerite (order 4)."""
    from tinygp_tpu_torch.kernels import quasisep

    return quasisep.Celerite(a=1.0, b=0.1, c=0.5, d=1.0) + quasisep.Celerite(
        a=0.5, b=0.05, c=1.5, d=3.0
    )


def sum5_kernel(p):
    """``1.2 * SHO(omega=1.5, quality=3.0) + 1.5 * Matern52(scale=2.5)``
    (order 5), its four hyperparameters ``p = (amp1, omega, amp2, scale)``."""
    from tinygp_tpu_torch.kernels import quasisep

    return p[0] * quasisep.SHO(omega=p[1], quality=3.0) + p[2] * quasisep.Matern52(scale=p[3])


def sum5_gp(X, p):
    from tinygp_tpu_torch import GaussianProcess

    return GaussianProcess(sum5_kernel(p), X, diag=0.1, assume_sorted=True, device=X.device.type)


SUM5_PARAMS = (1.2, 1.5, 1.5, 2.5)


def sum5_value_and_grad(X, y):
    import torch

    p = [torch.tensor(v, dtype=X.dtype, device=X.device, requires_grad=True) for v in SUM5_PARAMS]
    lp = sum5_gp(X, p).log_probability(y)
    return lp.detach(), torch.autograd.grad(lp, p)


def sum9_gp(X, p):
    """``sum5_gp``'s sum plus ``bench.py:331-345``'s 2-term celerite,
    ``Celerite(a=p[4], b=0.1, c=0.5, d=1.0) + Celerite(a=p[5], b=0.05,
    c=1.5, d=3.0)`` (order 2 + 3 + 4 = 9): stellar rotation, granulation
    and a trend in one model, whose gradient runs B2's tensor-core kernel."""
    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep

    kernel = (p[0] * quasisep.SHO(omega=p[1], quality=3.0) + p[2] * quasisep.Matern52(scale=p[3])
              + quasisep.Celerite(a=p[4], b=0.1, c=0.5, d=1.0)
              + quasisep.Celerite(a=p[5], b=0.05, c=1.5, d=3.0))
    return GaussianProcess(kernel, X, diag=0.1, assume_sorted=True, device=X.device.type)


SUM9_PARAMS = SUM5_PARAMS + (1.0, 0.5)


def sum9_value_and_grad(X, y):
    import torch

    p = [torch.tensor(v, dtype=X.dtype, device=X.device, requires_grad=True) for v in SUM9_PARAMS]
    lp = sum9_gp(X, p).log_probability(y)
    return lp.detach(), torch.autograd.grad(lp, p)


def sum20_kernel(p):
    """The asteroseismic background-plus-modes model of the celerite paper
    (Foreman-Mackey et al. 2017, AJ 154, 220), as tests/test_torch_orders.py
    builds it: two granulation terms ``SHO(quality=1/sqrt(2))`` (the second
    at three times the first's frequency and half its amplitude) and a comb
    of eight modes ``SHO(omega0 + k domega, Q)``, k = 0..7, their
    amplitudes under a Gaussian envelope: order 20. ``p = (gran_amp,
    gran_omega, height, omega0, domega, Q)``."""
    from tinygp_tpu_torch.kernels import quasisep

    gran = 1.0 / math.sqrt(2.0)
    kernel = (p[0] * quasisep.SHO(omega=p[1], quality=gran)
              + (0.5 * p[0]) * quasisep.SHO(omega=3.0 * p[1], quality=gran))
    for k in range(8):
        envelope = math.exp(-0.5 * ((k - 3.5) / 2.0) ** 2)
        kernel = kernel + (p[2] * envelope) * quasisep.SHO(omega=p[3] + k * p[4], quality=p[5])
    return kernel


def sum20_gp(X, p):
    from tinygp_tpu_torch import GaussianProcess

    return GaussianProcess(sum20_kernel(p), X, diag=0.1, assume_sorted=True, device=X.device.type)


SUM20_PARAMS = (0.8, 1.2, 0.6, 12.0, 1.4, 15.0)
SUM20_NAMES = ("gran_amp", "gran_omega", "height", "omega0", "domega", "quality")


def sum20_value_and_grad(X, y):
    import torch

    p = [torch.tensor(v, dtype=X.dtype, device=X.device, requires_grad=True)
         for v in SUM20_PARAMS]
    lp = sum20_gp(X, p).log_probability(y)
    return lp.detach(), torch.autograd.grad(lp, p)


# B3's launches of the sums' condition(y), by (monoid, m, m2, reverse): the
# prior's Riccati flow, the mean's affine scans, the forward couplings of
# order m and the reverse coupling of order 2m that (L^-1 M).gram() runs
# (solvers/quasisep/solver.py: QuasisepSolver.condition).
SUM_CONDITION_LAUNCHES = {
    name: {("ric", m, m, False): 1, ("aff", m, m, False): 1, ("aff", m, m, True): 1,
           ("cpl", m, m, False): 2, ("cpl", 2 * m, 2 * m, True): 1}
    for name, m in (("sum5", 5), ("sum9", 9))
}


def b3_launches_of(fn):
    """``fn()`` and the B3 launches it made, by ``(monoid, m, m2,
    reverse)``."""
    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    seen = {}
    launch = cuda_scan._launch

    def counting(monoid, m, r, reverse, inclusive, operands, out_rows, m2=None):
        key = (monoid, m, m if m2 is None else m2, bool(reverse))
        seen[key] = seen.get(key, 0) + 1
        return launch(monoid, m, r, reverse, inclusive, operands, out_rows, m2=m2)

    cuda_scan._launch = counting
    try:
        return fn(), seen
    finally:
        cuda_scan._launch = launch


def raises_n10(fn):
    """Whether ``fn()`` raises ``NotImplementedError`` naming ROADMAP N10
    (orders above 32 on the card); any other error propagates."""
    try:
        fn()
    except NotImplementedError as err:
        return "N10" in str(err)
    return False


def dense_condition(kernel, X, y, diag):
    """``condition(y)``'s log probability, posterior mean and variance at
    X (with the posterior's default jitter) by dense float64 algebra on X's
    device."""
    import torch

    K = kernel(X, X)
    n = X.shape[0]
    L = torch.linalg.cholesky(K + diag * torch.eye(n, dtype=X.dtype, device=X.device))
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    logp = (-0.5 * (y @ alpha) - torch.sum(torch.log(torch.diagonal(L)))
            - 0.5 * n * math.log(2 * math.pi))
    V = torch.linalg.solve_triangular(L, K, upper=False)
    var = torch.diagonal(K) + math.sqrt(np.finfo(np.float64).eps) - torch.sum(V * V, dim=0)
    return logp.item(), (K @ alpha).cpu(), var.cpu()


def orders_path(X, y, X_test, generator):
    """The slice's float32 entry points at orders above 4, in the order a
    user calls them; returns every output by name, the generic B1, B1r
    and B2 launches of the m = 9 and m = 20 models' gradient calls, and
    the B3 launches of the m = 5 and m = 9 sums' ``condition(y)``."""
    import torch

    from tinygp_tpu_torch import GaussianProcess, fit_map
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    out = {}
    dev = X.device.type
    gp = GaussianProcess(matern52_kernel(), X, diag=0.1, assume_sorted=True, device=dev)
    lp, post = gp.condition(y)
    mu, var = gp.predict(y, X_test, return_var=True)
    out["matern52"] = (lp, post.loc, post.variance, mu, var, gp.sample(generator, (16,)))
    gp = GaussianProcess(celerite2(), X, diag=0.1, assume_sorted=True, device=dev)
    lp, post = gp.condition(y)
    out["celerite2"] = (lp, post.loc, post.variance)
    # The sums after a fit, conditioned (a light curve's detrending):
    # couplings of order 5, 9, 10 and 18.
    condition_launches = {}
    for name, gp_of, params in (("sum5", sum5_gp, SUM5_PARAMS), ("sum9", sum9_gp, SUM9_PARAMS)):
        (lp, post), condition_launches[name] = b3_launches_of(
            lambda: gp_of(X, params).condition(y))
        out[f"{name}_condition"] = (lp, post.loc, post.variance)
    with torch.no_grad():
        value = sum5_gp(X, SUM5_PARAMS).log_probability(y)
    out["sum5"] = (value, *sum5_value_and_grad(X, y)[1])
    with torch.no_grad():
        value = sum9_gp(X, SUM9_PARAMS).log_probability(y)
    before = dict(cuda_loglik.LAUNCHES_GENERIC)
    out["sum9"] = (value, *sum9_value_and_grad(X, y)[1])
    grad9_launches = count_diff(cuda_loglik.LAUNCHES_GENERIC, before)
    # The order-20 model: value, gradient in six hyperparameters, 5 fit_map
    # steps (B1r and B2 through the block-a-team kernels).
    with torch.no_grad():
        value = sum20_gp(X, SUM20_PARAMS).log_probability(y)
    before = dict(cuda_loglik.LAUNCHES_GENERIC)
    out["sum20"] = (value, *sum20_value_and_grad(X, y)[1])
    grad_launches = {9: grad9_launches, 20: count_diff(cuda_loglik.LAUNCHES_GENERIC, before)}

    def loss20(params):
        return -sum20_gp(X, [torch.exp(params[k]) for k in SUM20_NAMES]).log_probability(y)

    res = fit_map(loss20, {k: math.log(v) for k, v in zip(SUM20_NAMES, SUM20_PARAMS)},
                  num_steps=5, learning_rate=0.01, dtype=X.dtype, device=dev)
    out["sum20_fit"] = (res.losses, res.loss)

    def loss_fn(params):
        return -sum5_gp(X, [torch.exp(params[k]) for k in ("amp1", "omega", "amp2", "scale")]
                        ).log_probability(y)

    init = {k: math.log(v) for k, v in zip(("amp1", "omega", "amp2", "scale"), SUM5_PARAMS)}
    res = fit_map(loss_fn, init, num_steps=20, learning_rate=0.05, dtype=X.dtype, device=dev)
    out["sum5_fit"] = (res.losses, res.loss)
    return out, grad_launches, condition_launches


def matern32_kernel():
    from tinygp_tpu_torch.kernels import quasisep

    return 1.5 * quasisep.Matern32(scale=2.5)


def matern52_kernel():
    from tinygp_tpu_torch.kernels import quasisep

    return 1.5 * quasisep.Matern52(scale=2.5)


POSTERIOR_MODELS = {"matern32": matern32_kernel, "matern52": matern52_kernel,
                    "celerite2": celerite2, "sum5": lambda: sum5_kernel(SUM5_PARAMS)}


def posterior_path(X, y, post_diag, generator=None, noise=None):
    """Each model's posterior process at the training points (order 4m: 8,
    12, 16, 20): its log probability, and a sample of 16 draws through
    ``generator`` or the factor times ``noise``."""
    from tinygp_tpu_torch import GaussianProcess

    out = {}
    for name, kernel in POSTERIOR_MODELS.items():
        gp = GaussianProcess(kernel(), X, diag=0.1, assume_sorted=True, device=X.device.type)
        post = gp.condition(y, diag=post_diag)[1]
        draws = (post.sample(generator, (16,)) if noise is None
                 else post.solver.dot_triangular(noise))
        out[name] = (post.log_probability(y), draws)
    return out


def phase_orders_path():
    """The slice of every quasiseparable order at ``bench.py``'s data
    (N = 1e5). Float32, as ``bench.py`` runs: Matern52's ``condition``,
    ``predict`` with variances and ``sample``; the 2-term celerite's
    ``condition``; ``1.2 * SHO + 1.5 * Matern52`` (m = 5): value, gradient
    in its four hyperparameters, 20 ``fit_map`` steps, and the value at
    N = 1e6; the same sum with the 2-term celerite (m = 9): value and
    gradient in six hyperparameters; the order-20 asteroseismic model
    (``sum20_kernel``): value, gradient in six hyperparameters and 5
    ``fit_map`` steps, and in float64 at N = 5000 against the CPU's plain
    path (value 1e-9, gradient 1e-6). Float64: the posterior processes of Matern32, Matern52 and the
    2-term celerite (order 8, 12 and 16), ``log_probability`` and
    ``sample``, with their default 1.49e-8 jitter at N = 1e5, and given
    ``diag=1e-3`` at N = 5000 (every 20th point), where the O(N) algorithm
    holds (see tests/test_torch_orders.py and PERF.md: with the jitter the
    reference's O(N) posterior factor loses the state from N of a few
    hundred; the JAX package returns -inf for Matern32's at N = 2000).
    Every count is set to 0 before the path and read after it; each
    generic-order instantiation is held to its plain version on random
    operands of its path shape; the float64 entry points (the sums' values
    and gradients, Matern52's posterior) against the CPU's plain float64
    path, and the posteriors given diag=1e-3 against a dense
    Cholesky. Returns the JSON records of the generic-order kernels."""
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik, cuda_scan

    (X5, y5), (X6, y6) = bench_data()
    X, y = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (X5, y5))
    X_1e6, y_1e6 = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (X6, y6))
    X_test = torch.linspace(0, 10, 1000, dtype=torch.float32, device="cuda")
    X64, y64 = X.double(), y.double()
    Xs, ys = X64[::20].contiguous(), y64[::20].contiguous()
    noise = torch.as_tensor(np.random.default_rng(3).normal(size=(Xs.shape[0], 16)), device="cuda")
    n = X.shape[0]
    t0 = time.perf_counter()

    # The path, once, with the generic-order kernels' launches recorded with
    # their operands.
    calls = {}
    launch = cuda_scan._launch
    loglik_calls = {}  # B1 ("qsl_loglik"), B1r and B2 launches by (prefix, m)
    loglik_launch = cuda_loglik._launch

    def recording(monoid, m, r, reverse, inclusive, operands, out_rows, m2=None):
        key = (monoid, m, m if m2 is None else m2, r)
        if key[1] != key[2] or m > 4:
            calls.setdefault(key, []).append((reverse, inclusive, operands))
        return launch(monoid, m, r, reverse, inclusive, operands, out_rows, m2=m2)

    def recording_loglik(lib, prefix, work_elems_fn, m, n, tensors, chains=None, batched=None):
        loglik_calls[prefix, m] = loglik_calls.get((prefix, m), 0) + 1
        return loglik_launch(lib, prefix, work_elems_fn, m, n, tensors, chains, batched)

    cuda_scan._launch = recording
    cuda_loglik._launch = recording_loglik
    try:
        reset_counts()
        out, grad_launches, condition_launches = orders_path(
            X, y, X_test, torch.Generator(device="cuda").manual_seed(0))
        with torch.no_grad():
            out["sum5_n1e6"] = (sum5_gp(X_1e6, SUM5_PARAMS).log_probability(y_1e6),)
        jittered = posterior_path(X64, y64, None, torch.Generator(device="cuda").manual_seed(1))
        noisy = posterior_path(Xs, ys, 1e-3, noise=noise)
        torch.cuda.synchronize()
        scan_counts = dict(cuda_scan.LAUNCHES_GENERIC)
        loglik_counts = dict(cuda_loglik.LAUNCHES_GENERIC)
        b123 = read_counts()
    finally:
        cuda_scan._launch = launch
        cuda_loglik._launch = loglik_launch
    path_s = time.perf_counter() - t0
    # The order-9 sum's posterior is of order 36: above the card's 32.
    post36 = sum9_gp(X, SUM9_PARAMS).condition(y)[1]
    order36_raises = raises_n10(lambda: post36.log_probability(y))

    finite = {k: all(bool(torch.isfinite(x).all()) for x in v) for k, v in out.items()}
    finite.update({f"{k} posterior diag=1e-3": all(bool(torch.isfinite(x).all()) for x in v)
                   for k, v in noisy.items()})
    shapes = (
        [tuple(x.shape) for x in out["matern52"]] == [(), (n,), (n,), (1000,), (1000,), (16, n)]
        and all([tuple(x.shape) for x in out[k]] == [(), (n,), (n,)]
                for k in ("celerite2", "sum5_condition", "sum9_condition"))
        and all([tuple(x.shape) for x in v] == [(), (16, n)] for v in jittered.values())
    )
    # Each launch of the sums' condition(y) is one of B3's one-launch
    # kernels, and they are the launches SUM_CONDITION_LAUNCHES lists.
    one_launch = all(cuda_scan.b3_schedule(mo, m, 1, torch.float32, m2=m2) is not None
                     for seen in condition_launches.values() for mo, m, m2, _ in seen)
    condition_ok = condition_launches == SUM_CONDITION_LAUNCHES and one_launch
    losses = [float(x) for x in out["sum5_fit"][0]]
    losses20 = [float(x) for x in out["sum20_fit"][0]]
    # Order 20: one B1 (the value), and one B1r and one B2 a gradient (the
    # gradient call and the 5 fit_map steps).
    calls20 = {prefix: loglik_calls.get((prefix, 20), 0)
               for prefix in ("qsl_loglik", "qsl_loglik_res", "qsl_loglik_bwd")}
    moved = (
        all(scan_counts[k] > 0 for k in ("aff", "ric", "cpl"))
        and loglik_counts["b1"] == 4 and loglik_counts["b1r"] >= 28 and loglik_counts["b2"] >= 28
        and grad_launches[9] == {"b1r": 1, "b2": 1} and grad_launches[20] == {"b1r": 1, "b2": 1}
        and loglik_calls.get(("qsl_loglik_bwd", 9)) == 1
        and calls20 == {"qsl_loglik": 1, "qsl_loglik_res": 6, "qsl_loglik_bwd": 6}
    )
    path_ok = (all(finite.values()) and shapes and moved and condition_ok and order36_raises
               and float(out["sum5_fit"][1]) < losses[0]
               and float(out["sum20_fit"][1]) < losses20[0])
    jitter_report = {
        k: f"log prob {v[0].item()!r}, draws finite {bool(torch.isfinite(v[1]).all())}"
        for k, v in jittered.items()
    }
    log(
        f"orders-path N={n} float32 ({path_s:.1f} s for the whole path): matern52 condition "
        f"log prob {out['matern52'][0].item()!r}, min variance {float(out['matern52'][2].min())!r}, "
        f"predict variance in [{float(out['matern52'][4].min())!r}, "
        f"{float(out['matern52'][4].max())!r}]; celerite2 condition log prob "
        f"{out['celerite2'][0].item()!r}; sum5 (m = 5) value {out['sum5'][0].item()!r}, "
        f"gradient {[float(g) for g in out['sum5'][1:]]}, fit_map losses {losses[0]!r} -> "
        f"{losses[-1]!r}, value at N=1e6 {out['sum5_n1e6'][0].item()!r}; sum9 (m = 9) value "
        f"{out['sum9'][0].item()!r}, gradient {[float(g) for g in out['sum9'][1:]]} "
        f"(generic launches of the gradient call {grad_launches[9]}); sum20 (m = 20) value "
        f"{out['sum20'][0].item()!r}, gradient {[float(g) for g in out['sum20'][1:]]} (generic "
        f"launches of the gradient call {grad_launches[20]}), fit_map losses {losses20[0]!r} -> "
        f"{losses20[-1]!r}, B1/B1r/B2 calls at m = 20 {calls20}; condition(y) of sum5 and "
        f"sum9: log prob {out['sum5_condition'][0].item()!r} / "
        f"{out['sum9_condition'][0].item()!r}, min variance "
        f"{float(out['sum5_condition'][2].min())!r} / {float(out['sum9_condition'][2].min())!r}, "
        f"B3 launches (monoid, m, m2, reverse) {condition_launches} (expected "
        f"{SUM_CONDITION_LAUNCHES}), each a one-launch kernel {one_launch}; sum9's posterior "
        f"(order 36) log_probability raises NotImplementedError naming N10 {order36_raises}; "
        f"posteriors given "
        f"diag=1e-3 at N={Xs.shape[0]} float64 log prob "
        f"{ {k: v[0].item() for k, v in noisy.items()} }; finite {finite}, shapes {shapes}; "
        f"generic launches B3 {scan_counts}, B1/B1r/B2 {loglik_counts}, by order "
        f"{ {f'{k[0]} m={k[1]}': v for k, v in sorted(loglik_calls.items())} }; all launches "
        f"B1/B1r/B2 {b123} {'ok' if path_ok else 'FAIL'}"
    )
    log(
        f"orders-path posteriors at N={n} float64 with the default jitter (the reference "
        f"algorithm's O(N) factor does not hold here; recorded, not checked): {jitter_report}"
    )

    # The float64 entry points on the card against the CPU's plain float64
    # path: the m = 5 and m = 9 sums' values and gradients at N = 5000
    # (every 20th point) and Matern52's posterior mean
    # and variance at N = 1e5 (the variance within 1e-8 of the largest
    # prior variance, as the conditioning phase holds Matern32's).
    t1 = time.perf_counter()
    Xc, yc = X64.cpu(), y64.cpu()
    errs = {}
    for tag, value_and_grad in (("sum5", sum5_value_and_grad), ("sum9", sum9_value_and_grad)):
        card_v, card_g = value_and_grad(Xs, ys)
        cpu_v, cpu_g = value_and_grad(Xs.cpu(), ys.cpu())
        errs[f"{tag} value"] = rel_err(card_v.item(), cpu_v.item())
        errs.update({f"{tag} grad {i}": rel_err(float(a), float(b))
                     for i, (a, b) in enumerate(zip(card_g, cpu_g))})
    from tinygp_tpu_torch import GaussianProcess

    def m52(X):
        return GaussianProcess(matern52_kernel(), X, diag=0.1, assume_sorted=True,
                               device=X.device.type)

    # The order-20 model in float64 at N = 5000 (every 20th point): value
    # within 1e-9, gradient within 1e-6 of its largest entry.
    card_v, card_g = sum20_value_and_grad(Xs, ys)
    cpu_v, cpu_g = sum20_value_and_grad(Xs.cpu(), ys.cpu())
    card_g, cpu_g = (torch.stack([g.double().cpu() for g in gs]) for gs in (card_g, cpu_g))
    sum20_errs = (rel_err(card_v.item(), cpu_v.item()),
                  float((card_g - cpu_g).abs().max() / cpu_g.abs().max()))
    sum20_ok = sum20_errs[0] <= 1e-9 and sum20_errs[1] <= 1e-6
    card_post = m52(X64).condition(y64)[1]
    cpu_post = m52(Xc).condition(yc)[1]
    scale = float(m52(Xc).variance.abs().max())
    errs["matern52 loc"] = rel_max(card_post.loc.cpu(), cpu_post.loc)
    errs["matern52 variance"] = float(
        (card_post.variance.cpu() - cpu_post.variance).abs().max()) / scale
    f64_ok = max(errs.values()) <= 1e-8 and sum20_ok
    log(
        f"orders-path float64, card against the CPU's plain version "
        f"({time.perf_counter() - t1:.1f} s): "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (limit 1e-8); sum20 (m = 20) at "
        f"N={Xs.shape[0]}: value {sum20_errs[0]:.2e} (limit 1e-9), gradient {sum20_errs[1]:.2e} "
        f"of its largest entry (limit 1e-6) {'ok' if f64_ok else 'FAIL'}"
    )

    # The posteriors given diag=1e-3 (N = 5000) against a dense Cholesky of
    # the same posterior matrix on the card. Their order-4m realization
    # makes every parallel composition of the Riccati and affine maps lose
    # digits, the plain blocked scans' too (6e-7 from dense in the log
    # probability at kappa = 101 on the CPU): the card is held no further
    # from dense than ten times the plain CPU path, and never looser than
    # 1e-8.
    t1 = time.perf_counter()
    noisy_cpu = posterior_path(Xs.cpu(), ys.cpu(), 1e-3, noise=noise.cpu())
    dense_errs = {}
    for name, kernel in POSTERIOR_MODELS.items():
        gp = GaussianProcess(kernel(), Xs, diag=0.1, assume_sorted=True, device=Xs.device.type)
        post = gp.condition(ys, diag=1e-3)[1]
        L = torch.linalg.cholesky(post.solver.matrix.to_dense())
        z = torch.linalg.solve_triangular(L, (ys - post.loc)[:, None], upper=False)[:, 0]
        lp = (-0.5 * torch.sum(z * z) - torch.sum(torch.log(torch.diagonal(L)))
              - 0.5 * Xs.shape[0] * math.log(2 * math.pi)).item()
        draws = (L @ noise).cpu()
        card = (rel_err(noisy[name][0].item(), lp), rel_max(noisy[name][1].cpu(), draws))
        plain = (rel_err(noisy_cpu[name][0].item(), lp), rel_max(noisy_cpu[name][1], draws))
        limits = [max(1e-8, 10 * e) for e in plain]
        dense_errs[name] = (card, plain, all(c <= lim for c, lim in zip(card, limits)))
    dense_ok = all(v[2] for v in dense_errs.values())
    log(
        f"orders-path posteriors given diag=1e-3 at N={Xs.shape[0]} float64 against a dense "
        f"Cholesky of the same matrix ({time.perf_counter() - t1:.1f} s): (log prob, factor "
        f"times noise) card / plain CPU "
        f"{ {k: ([f'{e:.2e}' for e in v[0]], [f'{e:.2e}' for e in v[1]]) for k, v in dense_errs.items()} } "
        f"(limit: ten times the plain's, at least 1e-8) {'ok' if dense_ok else 'FAIL'}"
    )
    f64_ok = f64_ok and dense_ok

    # The sums' condition(y) in float64 at N = 5000 against a dense
    # posterior (the log probability within 1e-9, mean and variance within
    # 1e-8 of the largest magnitude).
    t1 = time.perf_counter()
    cond_errs = {}
    for name, gp_of, params in (("sum5", sum5_gp, SUM5_PARAMS), ("sum9", sum9_gp, SUM9_PARAMS)):
        gp = gp_of(Xs, params)
        lp, post = gp.condition(ys)
        want = dense_condition(gp.kernel, Xs, ys, 0.1)
        cond_errs[name] = (rel_err(lp.item(), want[0]), rel_max(post.loc.cpu(), want[1]),
                           rel_max(post.variance.cpu(), want[2]))
    cond_ok = all(e[0] <= 1e-9 and max(e[1:]) <= 1e-8 for e in cond_errs.values())
    log(
        f"orders-path condition(y) of sum5 and sum9 at N={Xs.shape[0]} float64 against a dense "
        f"posterior ({time.perf_counter() - t1:.1f} s): (log prob, mean, variance) "
        f"{ {k: [f'{e:.2e}' for e in v] for k, v in cond_errs.items()} } (limits 1e-9, 1e-8, "
        f"1e-8) {'ok' if cond_ok else 'FAIL'}"
    )
    f64_ok = f64_ok and cond_ok

    # Each generic B3 instantiation of the path, at the shape and type the
    # path gives it, against its plain version on random well-conditioned
    # operands (as phase 7; the path's own posterior operands are
    # ill-conditioned for any parallel composition, see above), and timed
    # beside its bound and its plain version on the path's largest operands.
    records = []
    kernels_ok = True
    for (monoid, m, m2, r), group in sorted(calls.items()):
        reverse, inclusive, operands = max(group, key=lambda c: c[2][0].shape[-1])
        n_op, dtype = operands[0].shape[-1], operands[0].dtype
        rtol = 1e-8 if dtype == torch.float64 else 5e-4
        checks = scan_operands(monoid, m, n_op, r, dtype, seed=m + m2 + r, m2=m2)
        got = scan_kernel(monoid, m, r, reverse, inclusive, checks, m2=m2)
        want64 = scan_plain(monoid, m, r, reverse, inclusive, [x.double() for x in checks], m2=m2)
        (rel, abs_err), = stream_errors([got], [want64])
        run = lambda: scan_kernel(monoid, m, r, reverse, inclusive, operands, m2=m2)
        ms = cuda_ms(run, reps=10, warmup=2)
        plain_ms = cuda_ms(lambda: scan_plain(monoid, m, r, reverse, inclusive, operands, m2=m2),
                           reps=1, warmup=1)
        bound, by = scan_bound_ms(monoid, m, r, n_op, operands[0].element_size(), m2=m2)
        ok = rel <= rtol and bool(torch.isfinite(got).all())
        kernels_ok = kernels_ok and ok
        shape = f"m={m}" + (f"x{m2}" if monoid == "cpl" else "") + (f" r={r}" if r > 1 else "")
        log(
            f"orders-path B3 generic {monoid} {shape} N={n_op} {str(dtype)[6:]} ({len(group)} "
            f"launches on the path; {'reverse' if reverse else 'forward'} "
            f"{'inclusive' if inclusive else 'exclusive'}): {ms:.4f} ms, bound {bound:.4f} ms "
            f"({by}), plain {plain_ms:.4f} ms (one call); on random operands of this shape "
            f"against the plain version in float64 rel {rel:.2e} (limit {rtol:g}), abs "
            f"{abs_err:.3e} {'ok' if ok else 'FAIL'}"
        )
        records.append({
            "name": b3_name(monoid, m, m2, r),
            "route": "cuda",
            "source": b3_source(m, m2),
            "replaces": "tinygp_tpu/solvers/quasisep/pallas_scan.py:331",
            "launches": len(group),
            "max_abs_err": abs_err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,
        })

    # B1, B1r and B2 on the path's operands: the m = 5 sum's (B1 at 1e6,
    # B1r and B2 at 1e5), the m = 9 sum's and the m = 20 model's (all at
    # 1e5), each with its launches on the path.
    qbar, lbar = (torch.tensor(v, device="cuda") for v in (-0.5, -1.0))
    for m, gp_of, (X1, y1) in ((5, lambda X_: sum5_gp(X_, SUM5_PARAMS), (X_1e6, y_1e6)),
                               (9, lambda X_: sum9_gp(X_, SUM9_PARAMS), (X, y)),
                               (20, lambda X_: sum20_gp(X_, SUM20_PARAMS), (X, y))):
        with torch.no_grad():
            gp1 = gp_of(X1)
            ops1 = (*gp1.solver.ssm, (y1 - gp1.loc).contiguous())
            gp5 = gp_of(X)
            ops5 = (*gp5.solver.ssm, (y - gp5.loc).contiguous())
            got = cuda_loglik.fused_loglik_terms(*ops1)
            b1_err = stream_errors(got, cuda_loglik.plain_loglik_terms(*(x.double() for x in ops1)))
            res = cuda_loglik.fused_loglik_res(*ops5)
            res_err = stream_errors(res, cuda_loglik.plain_loglik_terms_res(
                *(x.double() for x in ops5)))
            bwd_args = (*ops5[1:], *res[2:], qbar, lbar)
            bars = cuda_loglik.fused_loglik_bwd(*bwd_args)
            bwd_err = stream_errors(bars, cuda_loglik.plain_loglik_bwd(
                *(x.double() for x in bwd_args)))
            b2_same, (b2_one, b2_report) = b2_launch_checks(bwd_args, bars)
            timings = {
                "b1": (cuda_ms(lambda: cuda_loglik.fused_loglik_terms(*ops1), reps=10, warmup=2),
                       cuda_ms(lambda: cuda_loglik.plain_loglik_terms(*ops1), reps=1, warmup=1)),
                "b1r": (cuda_ms(lambda: cuda_loglik.fused_loglik_res(*ops5), reps=10, warmup=2),
                        cuda_ms(lambda: cuda_loglik.plain_loglik_terms_res(*ops5), reps=1,
                                warmup=1)),
                "b2": (cuda_ms(lambda: cuda_loglik.fused_loglik_bwd(*bwd_args), reps=10, warmup=2),
                       cuda_ms(lambda: cuda_loglik.plain_loglik_bwd(*bwd_args), reps=1,
                               warmup=1)),
            }
        assert ops5[1].shape[0] == m
        bounds = {
            "b1": loglik_bound_ms(m, X1.shape[0], 4),
            "b1r": loglik_bound_ms(m, n, 4, residuals=True),
            "b2": bwd_bound_ms(m, n, 4),
        }
        errs = {"b1": b1_err, "b1r": res_err, "b2": bwd_err}
        src = "wide" if m > 16 else "generic"
        for key, prefix, name, replaces in (
            ("b1", "qsl_loglik", f"quasisep_loglik_{src}_m{m}", "pallas_loglik.py:86"),
            ("b1r", "qsl_loglik_res", f"quasisep_loglik_res_{src}_m{m}",
             "pallas_loglik.py:86 residuals=True"),
            ("b2", "qsl_loglik_bwd",
             f"quasisep_loglik_bwd_{'wide' if m > 16 else 'tc' if m > 8 else 'generic'}_m{m}",
             "pallas_loglik.py:414"),
        ):
            launches = loglik_calls.get((prefix, m), 0)
            rel = max(e for e, _ in errs[key])
            ok = rel <= 5e-4 and launches > 0 and (key != "b2" or (b2_same and b2_one))
            kernels_ok = kernels_ok and ok
            (ms, plain_ms), (bound, by) = timings[key], bounds[key]
            n_op = X1.shape[0] if key == "b1" else n
            extra = (f"; a second launch equal bit for bit {b2_same}, {b2_report}"
                     if key == "b2" else "")
            log(
                f"orders-path {key.upper()} {name} m={m} N={n_op} float32 ({launches} launches "
                f"on the path): {ms:.4f} ms, bound {bound:.4f} ms ({by}), plain "
                f"{plain_ms:.4f} ms (one call); against the plain version in float64 rel per "
                f"stream {[f'{e:.2e}' for e, _ in errs[key]]} (limit 5e-4){extra} "
                f"{'ok' if ok else 'FAIL'}"
            )
            records.append({
                "name": name,
                "route": "cuda",
                "source": f"tinygp_tpu_torch/csrc/quasisep_loglik_{src}.cu",
                "replaces": f"tinygp_tpu/solvers/quasisep/{replaces}",
                "launches": launches,
                "max_abs_err": max(a for _, a in errs[key]),
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": by,
                "library_ms": None,
            })
        del gp1, ops1, gp5, ops5, res, bwd_args, bars
    # B1, B1r and B2 at m = 8, 9, 12, 16 and 32, on random operands at
    # N = 1e5 in float32, beside their bounds.
    for m_hi in (8, 9, 12, 16, 32):
        args = random_operands(m_hi, n, torch.float32, seed=m_hi)
        res = cuda_loglik.fused_loglik_res(*args)
        qbar, lbar = (torch.tensor(v, device="cuda") for v in (-0.5, -1.0))
        bwd_args = (*args[1:], *res[2:], qbar, lbar)
        errs_hi = [
            max(e for e, _ in stream_errors(cuda_loglik.fused_loglik_terms(*args),
                                            cuda_loglik.plain_loglik_terms(*(x.double() for x in args)))),
            max(e for e, _ in stream_errors(res, cuda_loglik.plain_loglik_terms_res(
                *(x.double() for x in args)))),
            max(e for e, _ in stream_errors(cuda_loglik.fused_loglik_bwd(*bwd_args),
                                            cuda_loglik.plain_loglik_bwd(*(x.double() for x in bwd_args)))),
        ]
        times = [cuda_ms(lambda: cuda_loglik.fused_loglik_terms(*args), reps=10, warmup=2),
                 cuda_ms(lambda: cuda_loglik.fused_loglik_res(*args), reps=10, warmup=2),
                 cuda_ms(lambda: cuda_loglik.fused_loglik_bwd(*bwd_args), reps=10, warmup=2)]
        bounds_hi = [loglik_bound_ms(m_hi, n, 4), loglik_bound_ms(m_hi, n, 4, residuals=True),
                     bwd_bound_ms(m_hi, n, 4)]
        ok = max(errs_hi) <= 5e-4
        kernels_ok = kernels_ok and ok
        log(
            f"orders-path B1/B1r/B2 generic m={m_hi} N={n} float32 on random operands: "
            f"{[f'{t:.4f}' for t in times]} ms, bounds {[f'{b:.4f} ({w})' for b, w in bounds_hi]} "
            f"ms; against the plain version in float64 rel {[f'{e:.2e}' for e in errs_hi]} "
            f"(limit 5e-4) {'ok' if ok else 'FAIL'}"
        )

    # Each entry point alone: CUDA-event time, constructor included (median
    # of 5 after 1), and a fit_map step on the host clock.
    from tinygp_tpu_torch import fit_map

    gen = torch.Generator(device="cuda")
    entries = {
        "matern52 condition": lambda: (lambda r: (r[0], r[1].loc, r[1].variance))(
            m52(X).condition(y)),
        "matern52 predict(return_var) 1000 points": lambda: m52(X).predict(
            y, X_test, return_var=True),
        "matern52 sample 16": lambda: m52(X).sample(gen.manual_seed(0), (16,)),
        "celerite2 condition": lambda: (lambda r: (r[0], r[1].loc, r[1].variance))(
            GaussianProcess(celerite2(), X, diag=0.1, assume_sorted=True).condition(y)),
        "sum5 value": lambda: sum5_gp(X, SUM5_PARAMS).log_probability(y),
        "sum5 value N=1e6": lambda: sum5_gp(X_1e6, SUM5_PARAMS).log_probability(y_1e6),
        "sum5 gradient": lambda: sum5_value_and_grad(X, y),
        "sum9 value": lambda: sum9_gp(X, SUM9_PARAMS).log_probability(y),
        "sum5 condition": lambda: (lambda r: (r[0], r[1].loc, r[1].variance))(
            sum5_gp(X, SUM5_PARAMS).condition(y)),
        "sum9 condition": lambda: (lambda r: (r[0], r[1].loc, r[1].variance))(
            sum9_gp(X, SUM9_PARAMS).condition(y)),
        "sum9 gradient": lambda: sum9_value_and_grad(X, y),
        "sum20 value": lambda: sum20_gp(X, SUM20_PARAMS).log_probability(y),
        "sum20 gradient": lambda: sum20_value_and_grad(X, y),
        "celerite2 posterior (order 16, diag=1e-3, N=5000) log_probability": lambda: (
            GaussianProcess(celerite2(), Xs, diag=0.1, assume_sorted=True)
            .condition(ys, diag=1e-3)[1].log_probability(ys)),
        "sum5 posterior (order 20, diag=1e-3, N=5000) log_probability": lambda: (
            sum5_gp(Xs, SUM5_PARAMS).condition(ys, diag=1e-3)[1].log_probability(ys)),
        "matern32 posterior (order 8, N=1e5) sample 16": lambda: (
            GaussianProcess(matern32_kernel(), X64, diag=0.1, assume_sorted=True)
            .condition(y64)[1].sample(gen.manual_seed(0), (16,))),
    }
    entry_ms = {k: cuda_ms(fn, reps=5, warmup=1) for k, fn in entries.items()}

    def loss_fn(params):
        return -sum5_gp(X, [torch.exp(params[k]) for k in ("amp1", "omega", "amp2", "scale")]
                        ).log_probability(y)

    init = {k: math.log(v) for k, v in zip(("amp1", "omega", "amp2", "scale"), SUM5_PARAMS)}
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    fit_map(loss_fn, init, num_steps=10, learning_rate=0.05, dtype=torch.float32)
    torch.cuda.synchronize()
    entry_ms["sum5 fit_map step (host clock)"] = (time.perf_counter() - t2) / 10 * 1e3
    log(f"orders-path entry points (N={n}, float32 unless noted), ms: "
        f"{ {k: round(v, 4) for k, v in entry_ms.items()} }")
    log(f"orders-path: {time.perf_counter() - t0:.1f} s in all")
    if not (path_ok and f64_ok and kernels_ok):
        raise AssertionError("orders path failed")
    return records


# ---------------------------------------------------------------------------
# The dense path: kernels B4, B5 and B6 under the blocked Cholesky.
# ---------------------------------------------------------------------------

# The 3-term bf16 split product takes six bf16 products per float32 one, so
# float32-grade work on the H100's tensor cores (989 TFLOP/s bf16) runs at
# most at a sixth of that: the least time the card could take for products
# of this accuracy. The float32 FMA rate (PEAK_F32_FLOPS) is printed beside.
PEAK_SPLIT3_FLOPS = 989e12 / 6
# B5's 3-term order sums float32 products in float64: the least time for
# that work is at the float64 tensor-core rate (data sheet), with the
# float64 FMA units' rate, which its body uses, printed beside.
PEAK_F64_FLOPS = 67e12
PEAK_F64_FMA_FLOPS = 34e12
DENSE_N = 10_000
DENSE_BLOCK = 512
DENSE_M = 10_240  # DENSE_N padded to a block multiple: 20 panels
DENSE_TILE = 256  # the tile the factorization passes to the kernels at block 512
DENSE_COUNTS = ("panel", "syrk_inplace", "syrk_inplace_extras", "syrk")
# Besides: the split pass's launches (B4, B5 at 2 terms, B6) and B5's
# float64-sum launches (3 terms), which also count under "panel".
DENSE_EXTRA_COUNTS = ("split", "panel_f64")
# B6's calls in benchmarks/dense_micro.py:58-66: (m, b, lower_only).
MICRO_SYRK = ((9728, 512, False), (5120, 512, False), (9216, 1024, False))
CARD = "card not read yet"


def dense_bound_ms(nbytes, flops, rate=PEAK_SPLIT3_FLOPS, fma_rate=PEAK_F32_FLOPS):
    """(least time at ``rate`` (the 3-term tensor-core rate) or the HBM
    rate, which of the two bounds it, the same operations at ``fma_rate``
    (the float32 FMA rate))."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / rate * 1e3
    by = "bytes" if by_bytes >= by_ops else "operations"
    return max(by_bytes, by_ops), by, flops / fma_rate * 1e3


def syrk_inplace_work(t, b, extras):
    """Bytes and operations of B4 on a trailing size t: the lower triangle
    of T read and written, L read, two flops per term; with the row side
    products also ak read, rowsq and rsu written and 4 t b flops."""
    nbytes, flops = 4 * (t * (t + 1) + t * b), b * t * (t + 1)
    if extras:
        nbytes, flops = nbytes + 4 * (b + 2 * t), flops + 4 * t * b
    return nbytes, flops


def panel_work(rows, b):
    """B5: the (rows, b) panel and W read, the output written."""
    return 4 * (2 * rows * b + b * b), 2 * rows * b * b


def syrk_work(m, b, tile, lower_only):
    """B6: T read (with ``lower_only`` only its tiles at or below the
    diagonal), L read, the whole output written; the m (m + 1) / 2 distinct
    dot products of the symmetric L L^T, 2 b flops each (the zero tiles
    need none, and the tiles left hold them all)."""
    nt = m // tile
    t_read = nt * (nt + 1) // 2 * tile * tile if lower_only else m * m
    return 4 * (t_read + m * b + m * m), m * (m + 1) * b


def reset_dense_counts():
    from tinygp_tpu_torch.ops import cuda_dense, dense

    for k in cuda_dense.LAUNCHES:
        cuda_dense.LAUNCHES[k] = 0
    cuda_dense.LAUNCHES_SPLIT = cuda_dense.LAUNCHES_F64 = 0
    dense.NATIVE_REFACTORS = 0


def read_dense_counts():
    """The dense kernels' launches by name (and ``split``, ``panel_f64``)
    and the guards' re-factorizations since the last reset."""
    from tinygp_tpu_torch.ops import cuda_dense, dense

    counts = dict(cuda_dense.LAUNCHES)
    counts.update(split=cuda_dense.LAUNCHES_SPLIT, panel_f64=cuda_dense.LAUNCHES_F64)
    return counts, dense.NATIVE_REFACTORS


def dense_path_counts(panel, inplace, extras, f64=0):
    """The launch counts a dense path must read: B5 ``panel`` times (``f64``
    of them at 3 terms), B4 without and with side products, no B6, and a
    split pass for every B4 and every 2-term B5."""
    return {"panel": panel, "syrk_inplace": inplace, "syrk_inplace_extras": extras, "syrk": 0,
            "split": inplace + extras + panel - f64, "panel_f64": f64}


def dense_data():
    """``bench.py``'s dense draws (bench.py:357-358): X, y at N = 1e4, after
    its draws at 1e5 and 1e6 from the same generator."""
    rng = np.random.default_rng(42)
    for n in (100_000, 1_000_000):
        rng.uniform(0, 10, n)
        rng.normal(size=n)
    return np.sort(rng.uniform(0, 10, DENSE_N)), rng.normal(size=DENSE_N)


def matern32_f64(X1, X2, amp, scale):
    """``amp * Matern32(scale)`` by its closed form, in the operands' dtype."""
    import torch

    f = math.sqrt(3.0) / scale
    r = torch.abs(X1[:, None] - X2[None, :])
    return amp * (1 + f * r) * torch.exp(-f * r)


def dense_gp(X, amp=1.5, scale=2.5, **kwargs):
    """``bench.py``'s dense model: ``amp * Matern32(scale)``, ``diag=0.1``."""
    from tinygp_tpu_torch import GaussianProcess, kernels

    return GaussianProcess(amp * kernels.Matern32(scale=scale), X, diag=0.1, **kwargs)


def phase_dense_kernels():
    """B5 (both orders), B4 (both modes) and B6 against their plain
    versions in float64 on the same values, at the main path's shapes
    (m = 10240, b = 512, trailing sizes 512 j, B4 at every one), B5 also at
    an offset with a ragged row count, B6 at ``benchmarks/dense_micro.py``'s
    shapes, its only caller; each timed beside its bound, its plain version
    and the library call. Returns the kernels' measurements (B5's 3-term
    order under ``panel_f64``), B6's with its launches there."""
    import torch

    from tinygp_tpu_torch.ops import cuda_dense as cd

    m, b, tile = DENSE_M, DENSE_BLOCK, DENSE_TILE
    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    out = {
        k: {"rel": 0.0, "abs": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "bound_ms": 0.0, "f32_ms": 0.0, "by": set()}
        for k in (*DENSE_COUNTS, "panel_f64")
    }
    failures = []
    micro_launches = 0

    def check(name, label, got, want):
        (rel, abs_err), = stream_errors([got], [want])
        ok = rel <= 1e-5 and bool(torch.isfinite(got).all())
        out[name]["rel"] = max(out[name]["rel"], rel)
        out[name]["abs"] = max(out[name]["abs"], abs_err)
        log(f"dense-kernel {name} {label}: against the float64 plain version rel "
            f"{rel:.3e} (limit 1e-5), abs {abs_err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append((name, label))

    def check_pieces(label, x):
        """The split pass on the card against ``split_pieces`` (plain
        PyTorch on the same tensor), bit for bit, padding zeros included:
        its three pieces, whose first two are the 2-term split."""
        got = cd.split_pass(x)
        rows, k = x.shape
        same = not got[:, rows:].any() and not got[:, :, k:].any()
        for terms in (2, 3):
            for p, piece in enumerate(cd.split_pieces(x, terms)):
                same = same and torch.equal(got[p, :rows, :k].view(torch.int16),
                                            piece.view(torch.int16))
        log(f"dense-kernel split pass {label}: equal to split_pieces (2 and 3 terms) bit for "
            f"bit {same}")
        if not same:
            failures.append(("split", label))

    def check_split_dots(name, label, got, want):
        """A kernel against ``plain_split_dots`` (float64 sums of the exact
        piece products): only the accumulation may round. The signed mean
        error toward ``want``'s sign, over its mean magnitude, shows a
        rounding bias (the tensor cores round toward zero)."""
        (rel, _), = stream_errors([got], [want])
        ok = rel <= 1e-6
        diff = got.double() - want
        bias = float((diff * torch.sign(want)).mean() / want.abs().mean())
        log(f"dense-kernel {name} {label}: against plain_split_dots in float64 on the same "
            f"pieces rel {rel:.3e} (limit 1e-6), signed mean error {bias:.3e} of the mean "
            f"magnitude {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append((name, label + " split dots"))

    def timed(name, label, work, kernel, plain, library, reps):
        nbytes, flops = work
        f64 = name == "panel_f64"
        bound, by, f32 = dense_bound_ms(
            nbytes, flops, *((PEAK_F64_FLOPS, PEAK_F64_FMA_FLOPS) if f64 else ()))
        k_ms = cuda_ms(kernel, reps=reps, warmup=1)
        p_ms = cuda_ms(plain, reps=reps, warmup=1)
        l_ms = cuda_ms(library, reps=reps, warmup=1)
        rec = out[name]
        rec["ms"] += k_ms
        rec["plain_ms"] += p_ms
        rec["library_ms"] += l_ms
        rec["bound_ms"] += bound
        rec["f32_ms"] += f32
        rec["by"].add(by)
        log(f"dense-kernel {name} {label} [{CARD}]: {k_ms:.4f} ms, bound {bound:.4f} ms "
            f"({by}; {f32:.4f} ms at the {'float64' if f64 else 'float32'} FMA rate), plain "
            f"{p_ms:.4f} ms, library {l_ms:.4f} ms")

    check_j = (1, 10, 19)
    A, W, ak = randn(m, m), randn(b, b, scale=b**-0.5), randn(b)
    S = randn(m, m)
    T = (S + S.T) * 2**-0.5
    del S
    W64 = W.double()
    # B5: the panel of step k reads rows hi: of block column lo:hi. The
    # main path's well-conditioned matrices take 2 terms (float32 sums of
    # the 3-term products); the ill-conditioned route takes 3 (float64
    # sums, "panel_f64"), checked and timed beside them, its yardstick the
    # float64 product of the float64-cast panel and W.
    for j in range(1, m // b):
        t = j * b
        hi = m - t
        lo = hi - b
        for terms in (2, 3) if j in check_j else ():
            got = cd.split_panel_matmul(A, W, tile=tile, terms=terms, at=(hi, lo), rows=t)
            want = cd.plain_panel_matmul(A[:, lo:hi].double(), W64, hi, 0, t)
            check("panel" if terms == 2 else "panel_f64", f"terms={terms} rows={t} at=({hi}, {lo})",
                  got, want)
            panel = A[hi:hi + t, lo:hi]
            if terms == 2:  # the tensor cores; 3 terms sums float32 products in float64
                check_pieces(f"panel rows={t}", panel)
                check_split_dots("panel", f"terms={terms} rows={t}", got,
                                 cd.plain_split_dots(panel, W, 3))
            del got, want, panel
        timed(
            "panel", f"terms=2 rows={t}", panel_work(t, b),
            lambda: cd.split_panel_matmul(A, W, tile=tile, terms=2, at=(hi, lo), rows=t),
            lambda: cd.plain_panel_matmul(A, W, hi, lo, t),
            lambda: torch.matmul(A[hi:hi + t, lo:hi], W),
            reps=10,
        )
        timed(
            "panel_f64", f"terms=3 rows={t}", panel_work(t, b),
            lambda: cd.split_panel_matmul(A, W, tile=tile, terms=3, at=(hi, lo), rows=t),
            lambda: cd.plain_panel_matmul(A, W, hi, lo, t),
            lambda: torch.matmul(A[hi:hi + t, lo:hi].double(), W64),
            reps=10,
        )
    check_pieces("W^T (W read through its strides)", W.T)
    # A ragged row count against the kernel's 128-row tiles, at tile 32.
    for terms in (2, 3):
        got = cd.split_panel_matmul(A, W, tile=32, terms=terms, at=(1024, 512),
                                    rows=m - 1024 - 96)
        check("panel" if terms == 2 else "panel_f64",
              f"terms={terms} ragged rows=9120 at=(1024, 512) tile 32", got,
              cd.plain_panel_matmul(A[:, 512:1024].double(), W64, 1024, 0, m - 1024 - 96))
    del A

    # B4, in place, with and without the row side products, at every
    # trailing size: the lower triangle against the float64 plain version,
    # T outside the trailing lower 128 x 128 tiles unchanged bit for bit,
    # the row side products equal to plain_row_sums (the split pass's
    # order) bit for bit, and at three sizes the signed mean error against
    # plain_split_dots.
    for j in range(1, m // b):
        t = j * b
        off = m - t
        L = randn(t, b, scale=b**-0.5)
        lower = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
        blocks = torch.arange(t, device="cuda") // cd.KERNEL_TILE
        upper = blocks[None, :] > blocks[:, None]
        L64 = L.double()
        want = cd.plain_syrk_sub_inplace(T[off:, off:].double(), L64, 0)[lower]
        for name, ak_ in (("syrk_inplace", None), ("syrk_inplace_extras", ak)):
            Tc = T.clone()
            res = cd.syrk_sub_inplace(Tc, L, offset=off, tile=tile, ak=ak_)
            sums = ""
            if ak_ is not None:
                _, rowsq, rsu = res
                check(name, f"t={t} rowsq", rowsq, (L64 * L64).sum(1))
                check(name, f"t={t} rsu", rsu, L64 @ ak.double())
                same = all(torch.equal(g, w) for g, w in zip((rowsq, rsu), cd.plain_row_sums(L, ak)))
                sums = f", row sums equal to plain_row_sums bit for bit {same}"
                if not same:
                    failures.append((name, f"t={t} row sums differ from plain_row_sums"))
            untouched = (torch.equal(Tc[:off], T[:off]) and torch.equal(Tc[:, :off], T[:, :off])
                         and torch.equal(Tc[off:, off:][upper], T[off:, off:][upper]))
            if not untouched:
                failures.append((name, f"t={t} T changed outside the lower tiles"))
            check(name, f"t={t} offset={off} lower triangle (T outside the lower tiles "
                  f"untouched {untouched}{sums})", Tc[off:, off:][lower], want)
            if j in check_j and ak_ is None:
                dots = T[off:, off:].double() - cd.plain_split_dots(L, L, 3, nt=True)
                check_split_dots(name, f"t={t}", Tc[off:, off:][lower], dots[lower])
                del dots
            del Tc
        del lower, upper, L64, want
        Tw = T.clone()
        for name, ak_ in (("syrk_inplace", None), ("syrk_inplace_extras", ak)):
            timed(
                name, f"t={t}", syrk_inplace_work(t, b, ak_ is not None),
                lambda: cd.syrk_sub_inplace(Tw, L, offset=off, tile=tile, ak=ak_),
                lambda: cd.plain_syrk_sub_inplace(Tw, L, off, ak_),
                lambda: Tw[off:, off:].addmm_(L, L.T, alpha=-1.0),
                reps=5,
            )
        del Tw, L
    del T

    # B6 lies on no entry point's path: its one caller in the JAX package is
    # benchmarks/dense_micro.py:58-66, T - L L^T at three shapes. Driven
    # there once each with the counts at 0, each output then held to the
    # float64 plain version; lower_only (no caller) is checked beside them.
    for mm, bb, lower_only in MICRO_SYRK + ((9728, 512, True), (5120, 512, True)):
        S = randn(mm, mm)
        Tm = S + S.T
        del S
        Lm = randn(mm, bb, scale=bb**-0.5)
        label = f"m={mm} b={bb} lower_only={lower_only}"
        if not lower_only:
            reset_dense_counts()
        got = cd.syrk_sub(Tm, Lm, tile=DENSE_TILE, lower_only=lower_only)
        if not lower_only:
            torch.cuda.synchronize()
            micro_launches += read_dense_counts()[0]["syrk"]
        want = cd.plain_syrk_sub(Tm.double(), Lm.double(), DENSE_TILE, lower_only)
        # The plain version's zeros (lower_only's tiles) are zeros, and any
        # other zero is a float32 rounding of an element within the limit
        # below of zero (T - L L^T can round to exactly 0 at random).
        zeros_ok = bool((got[want == 0] == 0).all()) and bool(
            (want[got == 0].abs() <= 1e-5 * want.abs().max()).all())
        check("syrk", label + f" (zero pattern {zeros_ok})", got, want)
        if not zeros_ok:
            failures.append(("syrk", label + " zero pattern"))
        del want
        if not lower_only:
            check_pieces(f"L m={mm} b={bb}", Lm)
            check_split_dots("syrk", label, got,
                             Tm.double() - cd.plain_split_dots(Lm, Lm, 3, nt=True))
        del got
        work = syrk_work(mm, bb, DENSE_TILE, lower_only)
        kernel = lambda: cd.syrk_sub(Tm, Lm, tile=DENSE_TILE, lower_only=lower_only)  # noqa: E731
        plain = lambda: cd.plain_syrk_sub(Tm, Lm, DENSE_TILE, lower_only)  # noqa: E731
        library = lambda: torch.addmm(Tm, Lm, Lm.T, alpha=-1.0)  # noqa: E731
        if not lower_only:
            timed("syrk", label + " (benchmarks/dense_micro.py)", work, kernel, plain, library,
                  reps=5)
        else:
            bound, by, f32 = dense_bound_ms(*work)
            log(f"dense-kernel syrk {label} [{CARD}]: {cuda_ms(kernel, reps=5, warmup=1):.4f} ms, "
                f"bound {bound:.4f} ms ({by}; {f32:.4f} at the float32 FMA rate), plain "
                f"{cuda_ms(plain, reps=5, warmup=1):.4f} ms, library "
                f"{cuda_ms(library, reps=5, warmup=1):.4f} ms")
        del Tm, Lm
    out["syrk"]["launches"] = micro_launches
    log(f"dense-micro B6 launches at benchmarks/dense_micro.py's {len(MICRO_SYRK)} shapes: "
        f"{micro_launches}")
    if micro_launches != len(MICRO_SYRK):
        failures.append(("syrk", f"{micro_launches} launches at dense_micro.py's shapes"))
    for name, rec in out.items():
        where = "dense_micro.py's" if name == "syrk" else "the main path's"
        library = {"panel": "torch.matmul", "panel_f64": "torch.matmul in float64"}.get(
            name, "addmm (twice B4's and B6's least terms)")
        rates = ("float64 tensor-core rate", "float64 FMA rate") if name == "panel_f64" else (
            "3-term tensor-core rate", "float32 FMA rate")
        log(f"dense-kernel {name} summed over {where} shapes [{CARD}]: "
            f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rates[0]}; "
            f"{rec['f32_ms']:.4f} ms at the {rates[1]}), plain {rec['plain_ms']:.4f} ms, "
            f"library {rec['library_ms']:.4f} ms ({library}); kernel / library in this run "
            f"{rec['ms'] / rec['library_ms']:.4f}")
    if failures:
        raise AssertionError(f"dense kernels disagree with their plain versions: {failures}")
    return out


class DenseTimers:
    """CUDA events around every B4/B5/B6 launch and at the entry of the
    fused loop (after the strip build), while active."""

    def __init__(self):
        self.launches = []
        self.marks = []

    def __enter__(self):
        import torch

        from tinygp_tpu_torch.ops import cuda_dense, dense

        self._run, self._dispatch = cuda_dense._run, dense._scaled_terms_dispatch

        def run(name, fn, *args):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            self._run(name, fn, *args)
            end.record()
            self.launches.append((name, start, end))

        def dispatch(*args, **kwargs):
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
            self.marks.append(mark)
            return self._dispatch(*args, **kwargs)

        cuda_dense._run, dense._scaled_terms_dispatch = run, dispatch
        return self

    def __exit__(self, *exc):
        from tinygp_tpu_torch.ops import cuda_dense, dense

        cuda_dense._run, dense._scaled_terms_dispatch = self._run, self._dispatch

    def summed(self):
        """Milliseconds by kernel name (after a synchronize)."""
        sums = {}
        for name, start, end in self.launches:
            sums[name] = sums.get(name, 0.0) + start.elapsed_time(end)
        return sums


def f64_loglik(K, y):
    """The log density by a float64 dense Cholesky (torch.linalg)."""
    import torch

    L = torch.linalg.cholesky(K)
    alpha = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    n = y.shape[0]
    return -0.5 * (alpha @ alpha) - torch.log(torch.diagonal(L)).sum() - 0.5 * n * math.log(2 * math.pi)


def phase_dense_loglik():
    """The dense ``log_probability`` at N = 1e4 in float32; returns its
    launch counts."""
    import torch

    from tinygp_tpu_torch.ops import dense

    Xn, yn = dense_data()
    X, y = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (Xn, yn))
    reset_dense_counts()
    value = dense_gp(X).log_probability(y)
    torch.cuda.synchronize()
    counts, refactors = read_dense_counts()

    X64, y64 = X.double(), y.double()
    K64 = matern32_f64(X64, X64, 1.5, 2.5) + 0.1 * torch.eye(DENSE_N, dtype=torch.float64, device="cuda")
    want = float(f64_loglik(K64, y64))
    del K64
    got = value.item()
    err = rel_err(got, want)

    whole_ms = cuda_ms(lambda: dense_gp(X).log_probability(y), reps=10, warmup=2)
    gp = dense_gp(X)
    torch.cuda.synchronize()
    with DenseTimers() as timers:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        gp.log_probability(y)
        torch.cuda.synchronize()
    strip_ms = start.elapsed_time(timers.marks[0])
    sums = timers.summed()

    def native():
        K = matern32_f64(X, X, 1.5, 2.5) + 0.1 * torch.eye(DENSE_N, device="cuda")
        L = torch.linalg.cholesky(K)
        a = torch.linalg.solve_triangular(L, y[:, None], upper=False)
        return (a * a).sum(), torch.log(torch.diagonal(L)).sum()

    native_ms = cuda_ms(native, reps=10, warmup=2)
    ok = (
        math.isfinite(got) and err <= 5e-4 and refactors == 0
        and counts == dense_path_counts(19, 0, 19)
    )
    log(
        f"dense-loglik matern32 N={DENSE_N} float32: log_probability {got!r} vs float64 dense "
        f"Cholesky {want!r}, rel err {err:.3e} (limit 5e-4); launches {counts}, native "
        f"re-factorizations {refactors} {'ok' if ok else 'FAIL'}"
    )
    log(
        f"dense-loglik timings [{CARD}]: whole call {whole_ms:.4f} ms (constructor included), "
        f"strip build {strip_ms:.4f} ms, B5 summed {sums.get('panel', 0.0):.4f} ms, B4 with "
        f"side products summed {sums.get('syrk_inplace_extras', 0.0):.4f} ms; yardstick "
        f"torch.linalg.cholesky + solve_triangular in float32 on the same matrix (built "
        f"included) {native_ms:.4f} ms"
    )
    if not ok:
        raise AssertionError("dense log_probability failed")
    return counts


def dense_grad32(X, y, **kwargs):
    """The dense model's gradient in (amp, scale) at (1.5, 2.5)."""
    import torch

    amp, scale = (torch.tensor(v, device="cuda", requires_grad=True) for v in (1.5, 2.5))
    lp = dense_gp(X, amp, scale, **kwargs).log_probability(y)
    return torch.autograd.grad(lp, [amp, scale])


def phase_dense_path_gradient():
    """The gradient in (amp, scale) at N = 1e4 in float32 and a 10-step
    ``fit_map``; returns their launch counts."""
    import torch

    from tinygp_tpu_torch import fit_map

    Xn, yn = dense_data()
    X, y = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (Xn, yn))

    def grad32():
        return dense_grad32(X, y)

    reset_dense_counts()
    g32 = [float(g) for g in grad32()]
    torch.cuda.synchronize()
    counts, refactors = read_dense_counts()

    X64, y64 = X.double(), y.double()
    amp, scale = (torch.tensor(v, dtype=torch.float64, device="cuda", requires_grad=True)
                  for v in (1.5, 2.5))
    K64 = matern32_f64(X64, X64, amp, scale) + 0.1 * torch.eye(DENSE_N, dtype=torch.float64, device="cuda")
    g64 = [float(g) for g in torch.autograd.grad(f64_loglik(K64, y64), [amp, scale])]
    del K64
    grad_ok = all(abs(a - w) <= 2e-3 * abs(w) + 1e-3 for a, w in zip(g32, g64))
    whole_ms = cuda_ms(grad32, reps=5, warmup=1)
    ok = grad_ok and refactors == 0 and counts == dense_path_counts(19, 0, 19)
    # Beside it, not a limit: the native float32 route (blocked=False:
    # torch.linalg's float32 Cholesky and its autograd, all in float32).
    native = [float(g) for g in dense_grad32(X, y, blocked=False)]
    log(
        f"dense-gradient matern32 N={DENSE_N} float32: d/d(amp, scale) {g32} vs float64 "
        f"autograd through torch.linalg.cholesky {g64} (limit 2e-3 relative + 1e-3): errors "
        f"{[abs(a - w) for a, w in zip(g32, g64)]}, native float32 route's "
        f"{[abs(a - w) for a, w in zip(native, g64)]}; launches {counts}, native "
        f"re-factorizations {refactors}; whole forward and backward {whole_ms:.4f} ms "
        f"[{CARD}] {'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise AssertionError("dense gradient failed")

    steps = 10

    def loss_fn(p):
        return -dense_gp(X, torch.exp(p["log_amp"]), torch.exp(p["log_scale"])).log_probability(y)

    init = {"log_amp": math.log(1.5), "log_scale": math.log(2.5)}
    reset_dense_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_map(loss_fn, init, num_steps=steps, learning_rate=0.05, dtype=torch.float32)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    fit_counts, fit_refactors = read_dense_counts()
    losses = [float(v) for v in res.losses]
    ok = (
        all(math.isfinite(v) for v in losses) and float(res.loss) < losses[0]
        and fit_refactors == 0 and fit_counts == dense_path_counts(19 * steps, 0, 19 * steps)
    )
    log(
        f"dense-trainer fit_map matern32 N={DENSE_N} float32, {steps} Adam steps at lr 0.05: "
        f"losses {losses[0]!r} -> {losses[-1]!r}, best {float(res.loss)!r}; {step_ms:.4f} ms "
        f"per step (host clock) [{CARD}]; launches {fit_counts}, native re-factorizations "
        f"{fit_refactors} {'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise AssertionError("dense fit_map failed")
    return {k: counts[k] + fit_counts[k] for k in counts}


def posterior_f64(X, y, Xt, jitter, dtype):
    """Dense posterior by torch.linalg in ``dtype`` with the native
    Cholesky: the mean and variance at the data and at ``Xt``, each
    variance by column sums of squares of the whitened cross-covariance."""
    import torch

    X, y, Xt = (a.to(dtype) for a in (X, y, Xt))
    n = X.shape[0]
    Kf = matern32_f64(X, X, 1.5, 2.5)
    L = torch.linalg.cholesky(Kf + 0.1 * torch.eye(n, dtype=dtype, device="cuda"))
    alpha = torch.linalg.solve_triangular(
        L.T, torch.linalg.solve_triangular(L, y[:, None], upper=False), upper=True
    )[:, 0]
    loc = y - 0.1 * alpha
    A = torch.linalg.solve_triangular(L, Kf, upper=False)
    var = torch.diagonal(Kf) + jitter - (A * A).sum(0)
    del A, Kf
    Ks = matern32_f64(X, Xt, 1.5, 2.5)
    mu = Ks.T @ alpha
    A = torch.linalg.solve_triangular(L, Ks, upper=False)
    var_t = 1.5 + jitter - (A * A).sum(0)
    return [x.double() for x in (loc, var, mu, var_t)]


def phase_dense_condition():
    """``condition``, ``predict(return_var=True)`` at 1000 new points and
    ``sample`` at N = 1e4 in float32; returns their launch counts."""
    import torch

    Xn, yn = dense_data()
    X, y = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (Xn, yn))
    X_test = torch.linspace(0, 10, 1000, device="cuda")
    reset_dense_counts()
    gp = dense_gp(X)
    _, post = gp.condition(y)
    mu, var_t = gp.predict(y, X_test, return_var=True)
    draws = gp.sample(torch.Generator(device="cuda").manual_seed(0), (16,))
    got = [post.loc, post.variance, mu, var_t]
    torch.cuda.synchronize()
    counts, refactors = read_dense_counts()

    jitter = math.sqrt(torch.finfo(torch.float32).eps)
    want = posterior_f64(X, y, X_test, jitter, torch.float64)
    # The yardstick is the native float32 route: the same entry points with
    # blocked=False, so torch.linalg's float32 Cholesky where B5 and B4
    # factor, and everything after it the same (the downdate Kss - A^T A is
    # one float32 product on both). The torch.linalg route with pairwise
    # column sums for the variance is printed beside it.
    with float32_defaults():
        nat_gp = dense_gp(X, blocked=False)
        _, nat_post = nat_gp.condition(y)
        native = [nat_post.loc, nat_post.variance, *nat_gp.predict(y, X_test, return_var=True)]
        colsum = posterior_f64(X, y, X_test, jitter, torch.float32)
    floor = 1e-6 * 1.6  # of the largest prior variance
    parts, ok = [], True
    for label, g, w, nat, cs in zip(("loc", "variance", "predict mean", "predict variance"),
                                    got, want, native, colsum):
        err = float((g.double() - w).abs().max())
        nerr = float((nat.double() - w).abs().max())
        fine = bool(torch.isfinite(g).all()) and err <= 2 * nerr + floor
        ok = ok and fine
        parts.append(f"{label} {err:.3e} (native float32 {nerr:.3e}; column sums "
                     f"{float((cs - w).abs().max()):.3e})")
    shapes = draws.shape == (16, DENSE_N) and bool(torch.isfinite(draws).all())
    ok = ok and shapes and refactors == 0 and counts == dense_path_counts(19, 19, 0)
    log(
        f"dense-condition matern32 N={DENSE_N} float32: largest error against the float64 "
        f"posterior: {', '.join(parts)} (limit: twice the native float32 route's plus "
        f"{floor:.1e}); min variance {float(post.variance.min())!r}, at new points "
        f"{float(var_t.min())!r}; sample {tuple(draws.shape)} finite {shapes}; launches "
        f"{counts}, native re-factorizations {refactors} {'ok' if ok else 'FAIL'}"
    )
    times = {
        "condition": lambda: (lambda r: (r[1].loc, r[1].variance))(dense_gp(X).condition(y)),
        "predict": lambda: dense_gp(X).predict(y, X_test, return_var=True),
        "sample": lambda: dense_gp(X).sample(torch.Generator(device="cuda").manual_seed(1), (16,)),
    }
    log(f"dense-condition entry points, constructor included [{CARD}]: " + ", ".join(
        f"{name} {cuda_ms(fn, reps=3, warmup=1):.4f} ms" for name, fn in times.items()))
    if not ok:
        raise AssertionError("dense conditioning failed")
    return counts


def phase_dense_ill_conditioned():
    """``ExpSquared(scale=1.0)`` with the float32 default jitter: the
    3-term order and the guards, on 4096 sorted points of [0, 10] and on
    ``bench.py``'s dense data at N = 1e4, where the 3-term panels are the
    main path's 19, timed whole; returns its launch counts."""
    import torch

    from tinygp_tpu_torch import GaussianProcess, kernels

    rng = np.random.default_rng(7)
    cases = ((np.sort(rng.uniform(0, 10, 4096)), rng.normal(size=4096)), dense_data())
    total = None
    for Xn, yn in cases:
        n = len(Xn)
        reset_dense_counts()
        gp, X, y, got, want, native = ill_conditioned_dense(Xn, yn)
        torch.cuda.synchronize()
        counts, refactors = read_dense_counts()
        terms = 2 if float(gp.solver.rel_floor) > 1e-2 else 3
        err, nerr, slack, ok = ill_conditioned_errors(got, want, native)
        steps = -(-n // DENSE_BLOCK) - 1
        ok = ok and counts == dense_path_counts(steps, 0, steps, f64=steps if terms == 3 else 0)
        ms = ""
        if n == DENSE_N:
            ms = cuda_ms(
                lambda: GaussianProcess(kernels.ExpSquared(scale=1.0), X).log_probability(y),
                reps=5, warmup=1)
            ms = f"; whole call {ms:.4f} ms [{CARD}] (constructor included)"
        log(
            f"dense-ill-conditioned expsquared N={n} float32, jitter "
            f"{math.sqrt(torch.finfo(torch.float32).eps):.3e}: rel_floor "
            f"{float(gp.solver.rel_floor):.3e} -> {terms}-term order; guard fired "
            f"{refactors} times; log_probability {got!r}, float64 {want!r}, native float32 "
            f"{native!r}: errors {err:.4g} vs native {nerr:.4g} (limit: the native's plus "
            f"{slack:.3g}); launches {counts}{ms} {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            raise AssertionError("the ill-conditioned dense route failed")
        total = counts if total is None else {k: total[k] + v for k, v in counts.items()}
    return total


def dense_records(measured, launches):
    """The JSON records of B4 (both modes), B5 (both orders: both count
    under ``panel``, the 3-term one also under ``panel_f64``) and B6 (B6's
    launches are those at ``benchmarks/dense_micro.py``'s shapes)."""
    launches = dict(launches, panel=launches["panel"] - launches["panel_f64"])
    meta = {
        "panel": ("dense_panel", "tinygp_tpu/ops/pallas_dense.py:315"),
        "panel_f64": ("dense_panel_f64", "tinygp_tpu/ops/pallas_dense.py:315 terms=3"),
        "syrk_inplace": ("dense_syrk_inplace", "tinygp_tpu/ops/pallas_dense.py:158"),
        "syrk_inplace_extras": (
            "dense_syrk_inplace_extras", "tinygp_tpu/ops/pallas_dense.py:158 ak="
        ),
        "syrk": ("dense_syrk", "tinygp_tpu/ops/pallas_dense.py:93"),
    }
    records = []
    for key, (name, replaces) in meta.items():
        rec = measured[key]
        records.append({
            "name": name,
            "route": "cuda",
            "source": "tinygp_tpu_torch/csrc/"
            + ("dense_syrk.cu" if key == "panel_f64" else "dense_tc.cu"),
            "replaces": replaces,
            "launches": rec["launches"] if key == "syrk" else launches[key],
            "max_abs_err": rec["abs"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": "bytes" if rec["by"] == {"bytes"} else "operations",
            "library_ms": rec["library_ms"],
        })
    return records


def dense_times():
    """``--dense-times``: B4 at each trailing size of N = 1e4 at block 512,
    with and without its side products, beside ``addmm``, then the dense
    ``log_probability`` and its gradient at N = 1e4, through entry points
    that older trees share, so that one chip call can time this tree and
    its parent in turns (this script copied into the parent's checkout)."""
    import torch

    from tinygp_tpu_torch.ops import cuda_dense as cd

    m, b, tile = DENSE_M, DENSE_BLOCK, DENSE_TILE
    gen = torch.Generator(device="cuda").manual_seed(4)
    S = torch.randn(m, m, generator=gen, device="cuda")
    T = (S + S.T) * 2**-0.5
    del S
    ak = torch.randn(b, generator=gen, device="cuda")
    sums = [0.0, 0.0, 0.0]
    for j in range(1, m // b):
        t = j * b
        off = m - t
        L = torch.randn(t, b, generator=gen, device="cuda") * b**-0.5
        times = [
            cuda_ms(lambda: cd.syrk_sub_inplace(T, L, offset=off, tile=tile, ak=ak), 5, 1),
            cuda_ms(lambda: cd.syrk_sub_inplace(T, L, offset=off, tile=tile), 5, 1),
            cuda_ms(lambda: T[off:, off:].addmm_(L, L.T, alpha=-1.0), 5, 1),
        ]
        sums = [a + x for a, x in zip(sums, times)]
        log(f"dense-times B4 t={t} [{CARD}]: with side products {times[0]:.4f} ms, without "
            f"{times[1]:.4f} ms, addmm {times[2]:.4f} ms")
    log(f"dense-times B4 summed over the 19 trailing sizes [{CARD}]: with side products "
        f"{sums[0]:.4f} ms, without {sums[1]:.4f} ms, addmm {sums[2]:.4f} ms")
    Xn, yn = dense_data()
    X, y = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (Xn, yn))
    value_ms = cuda_ms(lambda: dense_gp(X).log_probability(y), reps=10, warmup=2)
    grad_ms = cuda_ms(lambda: dense_grad32(X, y), reps=5, warmup=1)
    log(f"dense-times N={DENSE_N} [{CARD}]: log_probability {value_ms:.4f} ms, gradient "
        f"{grad_ms:.4f} ms (constructor included)")


def panel_f64_times():
    """B5's 3-term order at each of the 19 panel shapes of N = 1e4 at block
    512, beside a float64 ``torch.matmul`` of the cast panel and the bound
    at the float64 tensor-core rate, each held to float64 (1e-5); returns
    the sums (view, contiguous, matmul, bound): W as the transposed view
    the factorization passes (``inv(L11)^T``) and contiguous, as the
    ``panel_f64`` record passes it."""
    import torch

    from tinygp_tpu_torch.ops import cuda_dense as cd

    m, b, tile = DENSE_M, DENSE_BLOCK, DENSE_TILE
    gen = torch.Generator(device="cuda").manual_seed(4)
    A = torch.randn(m, m, generator=gen, device="cuda")
    W = torch.randn(b, b, generator=gen, device="cuda") * b**-0.5
    Ws = (W.T, W.T.contiguous())  # the same values: a view (strides (1, b)) and contiguous
    W64 = Ws[0].double()
    sums = [0.0] * 4
    worst = 0.0
    log(f"panel-f64 rows | kernel ms, W a view | kernel ms, W contiguous | float64 matmul ms | "
        f"bound ms (67 TFLOP/s) [{CARD}]")
    for j in range(1, m // b):
        t = j * b
        hi = m - t
        lo = hi - b
        want = A[hi:hi + t, lo:hi].double() @ W64
        for Wx in Ws:
            got = cd.split_panel_matmul(A, Wx, tile=tile, terms=3, at=(hi, lo), rows=t)
            (rel, _), = stream_errors([got], [want])
            worst = max(worst, rel)
            del got
        del want
        times = [
            *(cuda_ms(lambda: cd.split_panel_matmul(A, Wx, tile=tile, terms=3, at=(hi, lo),
                                                    rows=t), 10, 2) for Wx in Ws),
            cuda_ms(lambda: torch.matmul(A[hi:hi + t, lo:hi].double(), W64), 10, 2),
            dense_bound_ms(*panel_work(t, b), PEAK_F64_FLOPS, PEAK_F64_FMA_FLOPS)[0],
        ]
        sums = [s + x for s, x in zip(sums, times)]
        log(f"panel-f64 {t} | " + " | ".join(f"{x:.4f}" for x in times))
    log(f"panel-f64 sum of all 19 [{CARD}] | " + " | ".join(f"{x:.4f}" for x in sums)
        + f"; kernel / matmul {sums[0] / sums[2]:.4f} (view), {sums[1] / sums[2]:.4f} "
        f"(contiguous); largest error against float64 {worst:.3e} (limit 1e-5) "
        f"{'ok' if worst <= 1e-5 else 'FAIL'}")
    if worst > 1e-5:
        raise AssertionError("B5's 3-term order disagrees with float64")
    return sums


# The generic-order B1/B1r sequence's passes, in launch order. A kernel
# belongs to the Riccati flow until its finish pass (or, in older trees,
# the separate emission pass) has run in the call, and to the whitening
# affine scan after it.
def generic_loglik_times():
    """``--b1-times generic``: kernels B1, B1r and B2 above m = 4 alone,
    float32 at N = 1e5: on the path's operands (the m = 5 sum's, B1 and
    B1r also at 1e6; the m = 9 sum's; the order-20 model's) and on random
    operands at m = 8, 16 and 32. CUDA-event times first, then each call's
    kernels and device time from a ``torch.profiler`` trace; two launches
    compared bit for bit and each result held to its float64 plain version
    (5e-4). Through entry points that older trees share, so that one chip
    call can time this tree and its parent in turns. Returns {label: ms}."""
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    from tinygp_tpu_torch import cuda_build

    for stem in ("quasisep_loglik_generic", "quasisep_loglik_wide"):
        if stem in cuda_build.build_all():  # a parent tree may lack one
            log_ptxas(stem, only=r"^b[12]_")
    (X5, y5), (X6, y6) = bench_data()
    data = {label: tuple(torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in xy)
            for label, xy in (("1e5", (X5, y5)), ("1e6", (X6, y6)))}
    cases = []
    for label, gp_of, size, bwd in (
            ("sum5", lambda X: sum5_gp(X, SUM5_PARAMS), "1e5", True),
            ("sum5", lambda X: sum5_gp(X, SUM5_PARAMS), "1e6", False),
            ("sum9", lambda X: sum9_gp(X, SUM9_PARAMS), "1e5", True),
            ("sum20", lambda X: sum20_gp(X, SUM20_PARAMS), "1e5", True)):
        X, y = data[size]
        with torch.no_grad():
            gp = gp_of(X)
            ops = tuple(x.contiguous() for x in (*gp.solver.ssm, y - gp.loc))
        cases.append((f"{label} m={ops[1].shape[0]} N={size}", ops, bwd))
    for m in (8, 16, 32):
        cases.append((f"random m={m} N=1e5", tuple(random_operands(m, 100_000, torch.float32,
                                                                   seed=m)), True))
    out = {}
    for label, ops, bwd in cases:
        m, n = ops[1].shape
        with torch.no_grad():
            res = cuda_loglik.fused_loglik_res(*ops)
            qbar, lbar = (torch.tensor(v, device="cuda") for v in (-0.5, -1.0))
            bwd_args = (*ops[1:], *res[2:], qbar, lbar)
            calls = {"B1": lambda: cuda_loglik.fused_loglik_terms(*ops),
                     "B1r": lambda: cuda_loglik.fused_loglik_res(*ops)}
            if bwd:
                calls["B2"] = lambda: cuda_loglik.fused_loglik_bwd(*bwd_args)
            event_ms = {key: cuda_ms(fn, reps=10, warmup=2) for key, fn in calls.items()}
            for key, fn in calls.items():
                got, again = fn(), fn()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                want = (cuda_loglik.plain_loglik_bwd(*(x.double() for x in bwd_args)) if key == "B2"
                        else cuda_loglik.plain_loglik_terms_res(*(x.double() for x in ops)))
                worst = max(e for e, _ in stream_errors(got, want))
                if not (worst <= 5e-4 and same):
                    raise AssertionError(f"{key} at {label}: {worst:.3e} against float64, "
                                         f"bit for bit {same}")
                del got, again, want
                split, per_call = kernel_split(fn)
                device = ("not measured (no device time in the trace)" if split is None else
                          f"{sum(ms * per for ms, per in split.values()):.4f} ms")
                shown = ("" if split is None else
                         ", ".join(f"{k} {ms:.4f} x {per:g}" for k, (ms, per) in split.items()))
                bound = (bwd_bound_ms(m, n, 4) if key == "B2"
                         else loglik_bound_ms(m, n, 4, residuals=key == "B1r"))[0]
                out[f"{key} {label}"] = event_ms[key]
                log(f"generic-times {key} {label} float32 [{CARD}]: events {event_ms[key]:.4f} ms, "
                    f"device {device} (bound {bound:.4f} ms); {per_call:g} device operations per "
                    f"call ({shown}); two launches equal bit for bit; against float64 plain "
                    f"{worst:.2e} (limit 5e-4) ok")
        del res, bwd_args
        torch.cuda.empty_cache()
    return out


def ill_conditioned_dense(Xn, yn):
    """``ExpSquared(scale=1.0)`` with the float32 default jitter on the
    points ``Xn``: the float32 ``log_probability`` on the card, the float64
    dense Cholesky of the same float32 inputs and the native float32
    Cholesky's; returns (gp, X, y, got, want, native)."""
    import torch

    from tinygp_tpu_torch import GaussianProcess, kernels

    n = len(Xn)
    X, y = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (Xn, yn))
    jitter = math.sqrt(torch.finfo(torch.float32).eps)
    gp = GaussianProcess(kernels.ExpSquared(scale=1.0), X)
    got = gp.log_probability(y).item()

    def K(dtype):
        Xd = X.to(dtype)
        return torch.exp(-0.5 * (Xd[:, None] - Xd[None, :]) ** 2) + jitter * torch.eye(
            n, dtype=dtype, device="cuda")

    want = float(f64_loglik(K(torch.float64), y.double()))
    with float32_defaults():
        L32, info = torch.linalg.cholesky_ex(K(torch.float32))
        if int(info) == 0:
            a = torch.linalg.solve_triangular(L32, y[:, None], upper=False)
            native = float(-0.5 * (a * a).sum() - torch.log(torch.diagonal(L32)).sum()
                           - 0.5 * n * math.log(2 * math.pi))
        else:
            native = -math.inf
    return gp, X, y, got, want, native


def ill_conditioned_errors(got, want, native):
    """(error, native error, slack, within the limit): the route no
    further from float64 than the native float32 Cholesky, plus 4 eps of
    the value."""
    import torch

    err = abs(got - want) if math.isfinite(got) else math.inf
    nerr = abs(native - want) if math.isfinite(native) else math.inf
    slack = 4 * float(torch.finfo(torch.float32).eps) * abs(want)
    ok = err <= nerr + slack if (math.isfinite(nerr) or math.isfinite(err)) else got == -math.inf
    return err, nerr, slack, ok


def riccati_panel_times():
    """``--riccati-panel-times``: B5's 3-term order per panel shape beside
    float64 ``matmul``; the generic-order B1, B1r and B2
    (:func:`generic_loglik_times`); the ill-conditioned dense
    ``log_probability`` at N = 1e4 (``ExpSquared`` with the default
    jitter on ``bench.py``'s dense data, the 3-term order). Through entry
    points that older trees share, so that one chip call can time this
    tree and its parent in turns."""
    import torch

    panel_f64_times()
    generic_loglik_times()
    Xn, yn = dense_data()
    gp, X, y, got, want, native = ill_conditioned_dense(Xn, yn)
    err, nerr, slack, ok = ill_conditioned_errors(got, want, native)
    from tinygp_tpu_torch import GaussianProcess, kernels

    ms = cuda_ms(lambda: GaussianProcess(kernels.ExpSquared(scale=1.0), X).log_probability(y),
                 reps=5, warmup=1)
    log(f"ill-conditioned-times expsquared N={DENSE_N} float32 [{CARD}]: log_probability "
        f"{ms:.4f} ms (constructor included); error against float64 {err:.4g}, native float32 "
        f"{nerr:.4g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the ill-conditioned dense route at N = 1e4 failed")


def kernel_split(fn, calls=5):
    """For each kernel and memset that ``fn`` enqueues, by name (template
    arguments kept, parameters dropped), in order of first launch: device
    milliseconds per launch and launches per call; and the device
    operations per call; from a ``torch.profiler`` trace of ``calls``
    calls, counting what starts after the spin kernels that open it.
    (None, 0) where the trace holds no device time."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # A trace can lose the first launches it should hold (seen on an
        # H100 with several GB of operands allocated: the first scan of a
        # set missing from one call in five; and late in a long process),
        # so a call that is not counted and then three spin kernels open
        # the window, and only what starts after the last of them counts.
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    opened = max((e.time_range.end for e in events if "spin_kernel" in e.name), default=None)
    events = sorted((e for e in events if "spin_kernel" not in e.name
                     and (opened is None or e.time_range.start >= opened)),
                    key=lambda e: e.time_range.start)
    split = {}
    for e in events:
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e.name)
        name = re.sub(r"\(.*", "", name).strip()
        ms, count = split.get(name, (0.0, 0))
        split[name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    if not sum(ms for ms, _ in split.values()) > 0:
        return None, 0
    return {k: (ms / count, count / calls) for k, (ms, count) in split.items()}, len(events) / calls


def b2_times():
    """``--b2-times``: kernel B2 (the log-likelihood's backward) alone, on
    the Matern32 gradient path's operands at N = 1e5 and 1e6 (m = 2), the
    m = 5 sum's at 1e5 and random operands at m = 8 and 1e5, all float32:
    CUDA-event time, each pass from a ``torch.profiler`` trace with the
    device operations per call, two launches compared bit for bit and the
    result held to the float64 plain version (5e-4); B1 and B1r on the
    same operands; the whole gradient calls (``matern32_grad``,
    ``sum5_value_and_grad``). Through entry points that older trees share,
    so that one chip call can time this tree and its parent in turns."""
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    log_ptxas("quasisep_loglik_bwd")
    log_ptxas("quasisep_loglik_generic", only=r"^(b2_|bwd_)")
    (X5, y5), (X6, y6) = bench_data()
    cases = []
    for label, (Xn, yn), gp_of, whole in (
        ("matern32 m=2 N=1e5", (X5, y5), lambda X: matern32_gp(X, 1.5, 2.5), matern32_grad),
        ("matern32 m=2 N=1e6", (X6, y6), lambda X: matern32_gp(X, 1.5, 2.5), matern32_grad),
        ("sum5 m=5 N=1e5", (X5, y5), lambda X: sum5_gp(X, SUM5_PARAMS), sum5_value_and_grad),
    ):
        X, y = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (Xn, yn))
        with torch.no_grad():
            gp = gp_of(X)
            ops = (*gp.solver.ssm, (y - gp.loc).contiguous())
        cases.append((label, [x.contiguous() for x in ops], lambda X=X, y=y, f=whole: f(X, y)))
    cases.append(("random m=8 N=1e5", random_operands(8, 100_000, torch.float32, seed=8), None))
    for label, ops, whole in cases:
        m, n = ops[1].shape
        with torch.no_grad():
            res = cuda_loglik.fused_loglik_res(*ops)
            qbar, lbar = (torch.tensor(v, device="cuda") for v in (-0.5, -1.0))
            bwd_args = (*ops[1:], *res[2:], qbar, lbar)

            def bwd():
                return cuda_loglik.fused_loglik_bwd(*bwd_args)

            bars, again = bwd(), bwd()
            same = all(torch.equal(a, b) for a, b in zip(bars, again))
            errs = stream_errors(bars, cuda_loglik.plain_loglik_bwd(
                *(x.double() for x in bwd_args)))
            worst = max(e for e, _ in errs)
            if not (worst <= 5e-4 and all(bool(torch.isfinite(x).all()) for x in bars)):
                raise AssertionError(f"B2 at {label} disagrees with float64: {worst:.3e}")
            del again
            ms = cuda_ms(bwd, reps=20, warmup=3)
            split, per_call = kernel_split(bwd)
            b1r_ms = cuda_ms(lambda: cuda_loglik.fused_loglik_res(*ops), reps=20, warmup=3)
            b1_ms = cuda_ms(lambda: cuda_loglik.fused_loglik_terms(*ops), reps=20, warmup=3)
        whole_ms = cuda_ms(whole, reps=10, warmup=2) if whole else None
        shown = ("not measured (no device time in the trace)" if split is None else
                 ", ".join(f"{k} {ms:.4f} x {per:g}" for k, (ms, per) in split.items()))
        log(f"b2-times {label} float32 [{CARD}]: B2 {ms:.4f} ms (bound "
            f"{bwd_bound_ms(m, n, 4)[0]:.4f} ms), two launches equal bit for bit {same}, "
            f"against float64 plain rel per stream {[f'{e:.2e}' for e, _ in errs]} (limit 5e-4) "
            f"ok; B1r {b1r_ms:.4f} ms, B1 {b1_ms:.4f} ms; whole gradient call "
            + (f"{whole_ms:.4f} ms" if whole else "none (random operands)"))
        log(f"b2-times {label} trace: {per_call:g} device operations per B2 call; ms per launch "
            f"x launches per call: {shown}")
        del res, bwd_args, bars


def b1_times():
    """``--b1-times``: kernels B1 and B1r alone at the main path's shapes,
    float32: B1 on the Matern32 operands at N = 1e5 and 1e6 and on the
    SHO's and the 2-term celerite's (m = 4) at 1e5, B1r on the Matern32
    operands at 1e5 and 1e6; and the whole Matern32 value and gradient
    calls at 1e5 and 1e6. Every CUDA-event time is taken first, before any
    ``torch.profiler`` trace; then each kernel's device time and device
    operations per call from a trace, two launches compared bit for bit
    and the result held to the float64 plain version (5e-4). Also the
    registers and spills of ``quasisep_loglik.cu``'s kernels. Through entry
    points that older trees share, so that one chip call can time this
    tree and its parent in turns."""
    import torch

    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    log_ptxas("quasisep_loglik")
    (X5, y5), (X6, y6) = bench_data()
    data = {}
    for label, (Xn, yn) in (("1e5", (X5, y5)), ("1e6", (X6, y6))):
        data[label] = tuple(torch.as_tensor(a, dtype=torch.float32, device="cuda")
                            for a in (Xn, yn))
    models = {"matern32": lambda: 1.5 * quasisep.Matern32(scale=2.5),
              "sho": lambda: 1.2 * quasisep.SHO(omega=1.5, quality=3.0),
              "celerite2": celerite2}
    cases = []
    for key, model, label in (("B1", "matern32", "1e5"), ("B1", "matern32", "1e6"),
                              ("B1", "sho", "1e5"), ("B1", "celerite2", "1e5"),
                              ("B1r", "matern32", "1e5"), ("B1r", "matern32", "1e6")):
        X, y = data[label]
        with torch.no_grad():
            gp = GaussianProcess(models[model](), X, diag=0.1, assume_sorted=True)
            ops = tuple(x.contiguous() for x in (*gp.solver.ssm, y - gp.loc))
        fn = cuda_loglik.fused_loglik_terms if key == "B1" else cuda_loglik.fused_loglik_res
        cases.append((f"{key} {model} m={ops[1].shape[0]} N={label}", ops,
                      lambda fn=fn, ops=ops: fn(*ops)))
    whole = {f"{what} N={label}": (lambda X=X, y=y, what=what: (
        matern32_gp(X, 1.5, 2.5).log_probability(y) if what == "matern32 value"
        else matern32_grad(X, y))) for what in ("matern32 value", "matern32 gradient")
        for label, (X, y) in data.items()}

    # The clocks first: no trace has run in this process yet.
    event_ms = {label: cuda_ms(fn, reps=50, warmup=5) for label, _, fn in cases}
    whole_ms = {label: cuda_ms(fn, reps=20, warmup=3) for label, fn in whole.items()}
    for label, ops, fn in cases:
        m, n = ops[1].shape
        with torch.no_grad():
            got, again = fn(), fn()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            want = cuda_loglik.plain_loglik_terms_res(*(x.double() for x in ops))
            errs = stream_errors(got, want)
            worst = max(e for e, _ in errs)
            if not (worst <= 5e-4 and all(bool(torch.isfinite(x).all()) for x in got)):
                raise AssertionError(f"{label} disagrees with float64: {worst:.3e}")
            del got, again, want
            split, per_call = kernel_split(fn)
        device = ("not measured (no device time in the trace)" if split is None else
                  f"{sum(ms * per for ms, per in split.values()):.4f} ms")
        shown = ("" if split is None else
                 ", ".join(f"{k} {ms:.4f} x {per:g}" for k, (ms, per) in split.items()))
        bound = loglik_bound_ms(m, n, 4, residuals=label.startswith("B1r"))[0]
        log(f"b1-times {label} float32 [{CARD}]: events {event_ms[label]:.4f} ms, device "
            f"{device} (bound {bound:.4f} ms); two launches equal bit for bit {same}; against "
            f"float64 plain rel per stream {[f'{e:.2e}' for e, _ in errs]} (limit 5e-4) ok")
        log(f"b1-times {label} trace: {per_call:g} device operations per call; ms per launch "
            f"x launches per call: {shown}")
    for label, ms in whole_ms.items():
        log(f"b1-times whole {label} float32 [{CARD}]: {ms:.4f} ms (events, constructor "
            f"included)")


def generic_coupling(operands, m1, m2, reverse, inclusive):
    """The coupling through the generic-order source's C entry, whatever
    the orders (the wrapper sends two equal orders up to 4 to the templated
    source): to time one source against the other. Counts no launch."""
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    lib = cuda_scan._generic_library()
    n = operands[0].shape[-1]
    work = torch.empty(lib.qsg_workspace_elems(3, m1, m2, n, 1), dtype=torch.float64,
                       device=operands[0].device)
    out = operands[0].new_empty(m1 * m2, n)
    fn = lib.qsg_scan_f32 if operands[0].dtype == torch.float32 else lib.qsg_scan_f64
    err = fn(3, m1, m2, n, 1, int(reverse), int(inclusive), *[x.data_ptr() for x in operands],
             None, out.data_ptr(), work.data_ptr(), work.numel(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the generic coupling failed: cudaError {err}")
    return out


def b3_times():
    """``--b3-times``: kernel B3 alone at the main paths' shapes, float32:
    each monoid and shape that the Matern32 conditioning path (``condition``,
    ``predict`` at 1000 points, ``sample`` of 16) gives it at N = 1e5, the
    m = 2 scans of phase 7 at N = 1e6 (random operands: the affine scan
    with 1 and 16 columns, the congruence, the Riccati flow, the coupling),
    and the generic couplings of Matern52's (6, 6) and the 2-term
    celerite's (8, 8) ``condition`` at 1e5; and the whole Matern32,
    Matern52 and celerite ``condition`` calls at 1e5. Every CUDA-event time
    is taken first, before any ``torch.profiler`` trace; then each scan's
    device time and device operations per call from a trace, two launches
    compared bit for bit and the result held to the float64 plain version
    (5e-4). Also the registers and spills of B3's kernels. Through entry
    points that older trees share, so that one chip call can time this tree
    and its parent in turns."""
    import torch

    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    log_ptxas("quasisep_scan")
    log_ptxas("quasisep_generic", only=r"^cpl_")
    (X5, y5), _ = bench_data()
    X, y = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (X5, y5))
    X_test = torch.linspace(0, 10, 1000, dtype=torch.float32, device="cuda")

    def model(kernel):
        return GaussianProcess(kernel, X, diag=0.1, assume_sorted=True)

    # B3's calls on each path, the first of each monoid and shape with its
    # operands.
    calls = {}
    launch = cuda_scan._launch

    def recording(monoid, m, r, reverse, inclusive, operands, out_rows, m2=None):
        m2 = m if m2 is None else m2
        if keep(monoid, m, m2):
            calls.setdefault(f"{monoid} m={m}" + (f"x{m2}" if monoid == "cpl" else "")
                             + (f" r={r}" if r > 1 else "") + " N=1e5",
                             (monoid, m, m2, r, reverse, inclusive, operands))
        return launch(monoid, m, r, reverse, inclusive, operands, out_rows, m2=m2)

    cuda_scan._launch = recording
    try:
        with torch.no_grad():
            keep = lambda *_: True  # noqa: E731
            gp = model(matern32_kernel())
            gp.condition(y)
            gp.predict(y, X_test)
            gp.sample(torch.Generator(device="cuda").manual_seed(0), (16,))
            keep = lambda monoid, m, m2: monoid == "cpl" and max(m, m2) > 4  # noqa: E731
            model(matern52_kernel()).condition(y)
            model(celerite2()).condition(y)
    finally:
        cuda_scan._launch = launch
    n6 = 1_000_000
    for monoid, r, reverse, inclusive in (("aff", 1, False, False), ("aff", 16, True, True),
                                          ("cong", 1, False, False), ("ric", 1, False, False),
                                          ("cpl", 1, False, False)):
        calls[f"{monoid} m=2" + (f" r={r}" if r > 1 else "") + " N=1e6 (random)"] = (
            monoid, 2, 2, r, reverse, inclusive, scan_operands(monoid, 2, n6, r, torch.float32, 7))
    cases = {label: (c, lambda c=c: scan_kernel(c[0], c[1], c[3], c[4], c[5], c[6], m2=c[2]))
             for label, c in calls.items()}
    # The couplings (2, 2) and (4, 4) through either source, on the same
    # random operands.
    for m in (2, 4):
        c = ("cpl", m, m, 1, False, False, scan_operands("cpl", m, 100_000, 1, torch.float32, 3))
        cases[f"cpl m={m}x{m} N=1e5 (random) templated source"] = (
            c, lambda c=c: scan_kernel("cpl", c[1], 1, False, False, c[6]))
        cases[f"cpl m={m}x{m} N=1e5 (random) generic source"] = (
            c, lambda c=c: generic_coupling(c[6], c[1], c[1], False, False))
    whole = {f"{name} condition N=1e5": lambda k=kernel: (lambda res: (
        res[0], res[1].loc, res[1].variance))(model(k()).condition(y))
        for name, kernel in (("matern32", matern32_kernel), ("matern52", matern52_kernel),
                             ("celerite2", celerite2))}

    # The clocks first: no trace has run in this process yet.
    event_ms = {label: cuda_ms(fn, reps=50, warmup=5) for label, (_, fn) in cases.items()}
    whole_ms = {label: cuda_ms(fn, reps=20, warmup=3) for label, fn in whole.items()}
    for label, ((monoid, m, m2, r, reverse, inclusive, ops), fn) in cases.items():
        got, again = fn(), fn()
        same = torch.equal(got, again)
        want = scan_plain(monoid, m, r, reverse, inclusive, [x.double() for x in ops], m2=m2)
        (err, _), = stream_errors([got], [want])
        if not (err <= 5e-4 and bool(torch.isfinite(got).all())):
            raise AssertionError(f"B3 {label} disagrees with float64: {err:.3e}")
        del got, again, want
        split, per_call = kernel_split(fn)
        device = ("not measured (no device time in the trace)" if split is None else
                  f"{sum(ms * per for ms, per in split.values()):.4f} ms")
        shown = ("" if split is None else
                 ", ".join(f"{k} {ms:.4f} x {per:g}" for k, (ms, per) in split.items()))
        bound = scan_bound_ms(monoid, m, r, ops[0].shape[-1], 4, m2=m2)[0]
        way = f"{'reverse' if reverse else 'forward'} {'inclusive' if inclusive else 'exclusive'}"
        log(f"b3-times {label} ({way}) float32 [{CARD}]: events {event_ms[label]:.4f} ms, device "
            f"{device} (bound {bound:.4f} ms); two launches equal bit for bit {same}; against "
            f"float64 plain rel {err:.2e} (limit 5e-4) ok")
        log(f"b3-times {label} trace: {per_call:g} device operations per call; ms per launch x "
            f"launches per call: {shown}")
    for label, ms in whole_ms.items():
        log(f"b3-times whole {label} float32 [{CARD}]: {ms:.4f} ms (events, constructor "
            f"included)")
    b3_generic_times()


# The shapes whose engine times PERF.md keeps (the three-phase engine ran them before):
# every monoid at m = 24 and 32 at N_LONG, (monoid, reverse, inclusive, r).
ENGINE_ORDERS = (24, 32)
ENGINE_VARIANTS = [("aff", False, False, 1), ("cong", True, False, 1), ("ric", False, False, 1),
                   ("cpl", False, False, 1)]


def posterior_scan_shapes():
    """``(monoid, m, r, reverse, inclusive)`` of every generic-order B3 call
    that the posterior processes' ``log_probability`` and ``sample``
    (:func:`posterior_path`, given ``diag=1e-3`` at N = 5000, float64)
    make, in the order of their first call."""
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    (X5, y5), _ = bench_data()
    Xs, ys = (torch.as_tensor(a[::20], dtype=torch.float64, device="cuda") for a in (X5, y5))
    noise = torch.as_tensor(np.random.default_rng(3).normal(size=(Xs.shape[0], 16)),
                            device="cuda")
    shapes = {}
    launch = cuda_scan._launch

    def recording(monoid, m, r, reverse, inclusive, operands, out_rows, m2=None):
        if m > 4 and monoid in ("ric", "aff"):
            shapes.setdefault((monoid, m, r, reverse, inclusive), None)
        return launch(monoid, m, r, reverse, inclusive, operands, out_rows, m2=m2)

    cuda_scan._launch = recording
    try:
        with torch.no_grad():
            posterior_path(Xs, ys, 1e-3, noise=noise)
    finally:
        cuda_scan._launch = launch
    return list(shapes)


def b3_generic_times():
    """B3's generic-order Riccati flow and affine scan at the posterior
    processes' shapes (order 8, 12, 16 and 20; the affine scan with 1 and
    16 columns, in the directions the path takes) on random float64
    operands at N = 1e5 and 5000; the order-5 and order-9 sums'
    conditioning couplings (9, 9), (10, 10) and (18, 18) at 1e5 in float32
    and the order-20 posterior's reverse congruence at 5000 in float64; and
    at N = 17,161 in float64 and float32 the couplings (12, 12) and
    (16, 16) and every monoid at m = 24 and 32 (ENGINE_ORDERS, the shapes
    the three-phase engine ran before these kernels): CUDA-event times of every case
    first, and of the whole posterior calls (``condition`` then
    ``log_probability`` or ``sample``, at N = 1e5 with the default jitter
    and at 5000 given ``diag=1e-3``), then each case's device time and
    device operations per call from a ``torch.profiler`` trace (pass by
    pass), two launches compared bit for bit and the result held to the
    float64 plain version (1e-8, float32 5e-4). Also the registers and
    spills of the generic sources' kernels. Run alone by ``--b3-times
    generic``; through entry points that older trees share, so that one
    chip call can time this tree and its parent in turns."""
    import torch

    from tinygp_tpu_torch import cuda_build

    log_ptxas("quasisep_generic", only=r"^(ric|aff|cong|cpl)_")
    if "quasisep_wide" in cuda_build.build_all():
        log_ptxas("quasisep_wide")
    f32, f64 = torch.float32, torch.float64
    shapes = [(monoid, m, r, reverse, inclusive, n, f64)
              for monoid, m, r, reverse, inclusive in posterior_scan_shapes()
              for n in (100_000, 5000)]
    shapes += [("cpl", 9, 1, False, False, 100_000, f32), ("cpl", 10, 1, True, False, 100_000, f32),
               ("cpl", 18, 1, True, False, 100_000, f32), ("cong", 20, 1, True, False, 5000, f64)]
    shapes += [("cpl", m, 1, False, False, N_LONG, dtype) for m in (12, 16) for dtype in (f64, f32)]
    shapes += [(monoid, m, r, reverse, inclusive, N_LONG, dtype) for m in ENGINE_ORDERS
               for monoid, reverse, inclusive, r in ENGINE_VARIANTS for dtype in (f64, f32)]
    cases = {}
    for monoid, m, r, reverse, inclusive, n, dtype in shapes:
        label = (f"{monoid} m={m}" + (f"x{m}" if monoid == "cpl" else "")
                 + (f" r={r}" if r > 1 else "") + f" N={n} {str(dtype)[6:]} "
                 f"({'reverse' if reverse else 'forward'} "
                 f"{'inclusive' if inclusive else 'exclusive'})")
        ops = scan_operands(monoid, m, n, r, dtype, seed=m + r)
        cases[label] = ((monoid, m, r, reverse, inclusive, ops),
                        lambda c=(monoid, m, r, reverse, inclusive, ops): scan_kernel(*c))
    from tinygp_tpu_torch import GaussianProcess

    (X5, y5), _ = bench_data()
    X64, y64 = (torch.as_tensor(a, dtype=torch.float64, device="cuda") for a in (X5, y5))
    whole = {}
    for n, step, diag in ((100_000, 1, None), (5000, 20, 1e-3)):
        X, y = X64[::step].contiguous(), y64[::step].contiguous()
        for name, kernel in POSTERIOR_MODELS.items():
            def post(k=kernel, X=X, y=y, diag=diag):
                gp = GaussianProcess(k(), X, diag=0.1, assume_sorted=True)
                return gp.condition(y, diag=diag)[1]
            whole[f"{name} posterior N={n} condition + log_probability"] = (
                lambda post=post, y=y: post().log_probability(y))
            whole[f"{name} posterior N={n} condition + sample (16 draws)"] = (
                lambda post=post: post().sample(torch.Generator(device="cuda").manual_seed(0),
                                                (16,)))
    event_ms = {label: cuda_ms(fn, reps=30, warmup=3) for label, (_, fn) in cases.items()}
    whole_ms = {label: cuda_ms(fn, reps=5, warmup=1) for label, fn in whole.items()}
    for label, ms in whole_ms.items():
        log(f"b3-generic-times whole {label} float64 [{CARD}]: {ms:.4f} ms (events; the "
            f"posterior's own condition included)")
    for label, ((monoid, m, r, reverse, inclusive, ops), fn) in cases.items():
        got, again = fn(), fn()
        same = torch.equal(got, again)
        want = scan_plain(monoid, m, r, reverse, inclusive, [x.double() for x in ops])
        (err, _), = stream_errors([got], [want])
        rtol = 1e-8 if ops[0].dtype == torch.float64 else 5e-4
        if not (err <= rtol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"B3 generic {label} disagrees with the plain version: "
                                 f"{err:.3e}")
        del got, again, want
        split, per_call = kernel_split(fn)
        device = ("not measured (no device time in the trace)" if split is None else
                  f"{sum(ms * per for ms, per in split.values()):.4f} ms")
        shown = ("" if split is None else
                 ", ".join(f"{k} {ms:.4f} x {per:g}" for k, (ms, per) in split.items()))
        bound, by = scan_bound_ms(monoid, m, r, ops[0].shape[-1], ops[0].element_size())
        log(f"b3-generic-times {label} [{CARD}]: events {event_ms[label]:.4f} ms, "
            f"device {device} (bound {bound:.4f} ms, {by}); two launches equal bit for bit "
            f"{same}; against the float64 plain version rel {err:.2e} (limit {rtol:g}) ok")
        log(f"b3-generic-times {label} trace: {per_call:g} device operations per call; ms per "
            f"launch x launches per call: {shown}")


# ---------------------------------------------------------------------------
# Kernel B7: the tiled gram builder, on its own entry point.
# ---------------------------------------------------------------------------

GRAM_N = 10_000  # benchmarks/dense_pieces.py:17
GRAM_GRAD_N = 2048
GRAM_RAGGED = (1037, 515)
GRAM_LEAVES = ("Exp", "ExpSquared", "Matern32", "Matern52", "Cosine", "ExpSineSquared",
               "RationalQuadratic")


def gram_work(n1, n2, d, ops, n_params):
    """Bytes and operations of B7 on ``(n1, d)`` and ``(n2, d)`` points:
    the points and the ``n_params`` parameters read once and the output written once; per
    entry 3 d operations (difference, absolute value or square, sum) for
    each of the L1 and L2 sums the program needs, about ten for each leaf
    (its transcendental counted as one) and one for each sum or product."""
    from tinygp_tpu_torch.ops import gram

    leaves = [(op, metric) for op, metric, _ in ops if op > gram._MUL]
    uses_l1 = any(metric == 0 or op not in gram._SQUARED for op, metric in leaves)
    uses_l2 = any(metric == 1 for _, metric in leaves)
    per_entry = 3 * d * (uses_l1 + uses_l2) + 10 * len(leaves) + (len(ops) - len(leaves))
    nbytes = 4 * ((n1 + n2) * d + n1 * n2 + n_params)
    return nbytes, n1 * n2 * per_entry


def gram_f64(kernel, X1, X2):
    """The kernel's matrix in float64 on the float32 values B7 reads: the
    float32 inputs and the hyperparameters rounded to float32."""
    import torch

    params = {n: b.float().double() for n, b in kernel.named_buffers()}
    return torch.func.functional_call(kernel, params, (X1.double(), X2.double()))


def strip_shapes(n, block):
    """The dense path's strips, ``(lo, cr)``: rows ``lo:n`` against columns
    ``lo:cr`` (``ops/dense.py:kernel_loglik_terms``)."""
    return [(lo, min(lo + block, n)) for lo in range(0, n, block)]


def phase_gram():
    """Kernel B7 on its entry point ``ops.gram.gram_tiled``: the path
    (``benchmarks/dense_pieces.py``'s gram at N = 1e4 and a gradient at
    N = 2048) with its launches counted; B7 against its plain version on
    every kernel of its set; its times beside its bound and the plain
    version's, at 1e4 and summed over the dense path's strips. Returns B7's
    record."""
    import torch

    from tinygp_tpu_torch import kernels, transforms
    from tinygp_tpu_torch.ops import gram

    def card(a):
        return torch.as_tensor(a, dtype=torch.float32, device="cuda")

    # The path, once: the count set to 0 before it and read after.
    X = card(np.sort(np.random.default_rng(0).uniform(0, 10, GRAM_N)))
    pieces = (1.5 * kernels.Matern32(scale=2.5)).to("cuda")
    Xg = card(np.random.default_rng(2).uniform(0, 5, GRAM_GRAD_N))
    amp, scale = (torch.tensor(v, device="cuda", requires_grad=True) for v in (1.5, 1.4))
    x1 = Xg.clone().requires_grad_(True)
    w = torch.arange(GRAM_GRAD_N, dtype=torch.float32, device="cuda")
    gram.LAUNCHES["gram"] = 0
    K = gram.gram_tiled(pieces, X, X)
    Kg = gram.gram_tiled(kernels.Constant(amp) * kernels.Matern32(scale=scale), x1, Xg)
    grads = torch.autograd.grad((torch.sin(Kg) * w).sum(), (amp, scale, x1))
    torch.cuda.synchronize()
    launches = gram.LAUNCHES["gram"]
    del Kg

    failures = []
    worst = {"abs": 0.0}

    def check(label, kernel, X1, X2, got=None):
        # The plain versions broadcast a Constant's value to a matrix on the
        # value's device, so the hyperparameters go where the points are.
        kernel = kernel.to("cuda")
        got = gram.gram_tiled(kernel, X1, X2) if got is None else got
        want = gram_f64(kernel, X1, X2)
        err = float((got.double() - want).abs().max())
        plain = float((gram.plain_gram(kernel, X1, X2).double() - want).abs().max())
        top = float(want.abs().max())
        limit = 2 * plain + 1e-6 * top
        ok = err <= limit and tuple(got.shape) == tuple(want.shape) and bool(
            torch.isfinite(got).all())
        worst["abs"] = max(worst["abs"], err)
        log(f"gram {label} {tuple(X1.shape)} x {tuple(X2.shape)}: against float64 {err:.3e}, "
            f"the float32 plain version {plain:.3e}, limit {limit:.3e} (max|K| {top:.4g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)

    rng = np.random.default_rng(15)
    n1, n2 = GRAM_RAGGED
    extra = {"ExpSineSquared": dict(gamma=0.9), "RationalQuadratic": dict(alpha=1.1)}
    one = [card(rng.uniform(0, 10, n)) for n in (n1, n2)]
    three = [card(rng.normal(size=(n, 3))) for n in (n1, n2)]
    for name in GRAM_LEAVES:
        for metric in ("L1Distance", "L2Distance"):
            leaf = getattr(kernels, name)(scale=1.7, distance=getattr(kernels, metric)(),
                                          **extra.get(name, {}))
            for pts in (one, three):
                check(f"{name} {metric}", leaf, *pts)
    composite = kernels.ExpSineSquared(scale=2.0, gamma=0.9) + kernels.RationalQuadratic(alpha=1.1)
    check("ExpSineSquared(2.0, 0.9) + RationalQuadratic(alpha=1.1)", composite, *one)
    check("1.3 * Matern32(scale=1.7)", 1.3 * kernels.Matern32(scale=1.7), *three)
    check("ExpSquared(scale=1.2)", kernels.ExpSquared(scale=1.2), *three)
    roots = {
        "Linear(per-dimension scale)": transforms.Linear(
            torch.tensor([2.0, 0.5, 1.3]), kernels.ExpSquared(scale=1.1)),
        "Cholesky(2-d factor)": transforms.Cholesky.from_parameters(
            torch.tensor([1.5, 0.7, 2.0]), torch.tensor([0.3, -0.2, 0.4]),
            kernels.Matern52(scale=1.1)),
        "Subspace(axis=[0, 2])": transforms.Subspace(
            np.array([0, 2]), 0.5 * kernels.Matern32(scale=0.8)),
    }
    for label, kernel in roots.items():
        check(label, kernel, *three)
    check("dense_pieces.py 1.5 * Matern32(scale=2.5)", pieces, X, X, got=K)
    del K

    # The gradient against float64 autograd through the kernel's own matrix.
    a64, s64 = (torch.tensor(v, dtype=torch.float64, device="cuda", requires_grad=True)
                for v in (1.5, 1.4))
    x64 = Xg.double().requires_grad_(True)
    K64 = (kernels.Constant(a64) * kernels.Matern32(scale=s64))(x64, Xg.double())
    want = torch.autograd.grad((torch.sin(K64) * w.double()).sum(), (a64, s64, x64))
    del K64
    rels = [float((g.double() - v).abs().max() / v.abs().max()) for g, v in zip(grads, want)]
    grad_ok = max(rels) <= 1e-4
    log(f"gram gradient of sum(sin(K) w) N={GRAM_GRAD_N} float32 in (amp, scale, X1): "
        f"{[float(grads[0]), float(grads[1])]} vs float64 {[float(want[0]), float(want[1])]}; "
        f"errors relative per parameter {[f'{r:.3e}' for r in rels]} (limit 1e-4) "
        f"{'ok' if grad_ok else 'FAIL'}")
    if not grad_ok:
        failures.append("gradient")
    log(f"gram path launches (value at N={GRAM_N} and the gradient): {launches}")
    if not launches:
        failures.append("no launch on the path")

    # Times: at 1e4 x 1e4, and summed over the dense path's strip shapes.
    ops, params = gram._compile(pieces, X, X)[2:4]
    nbytes, flops = gram_work(GRAM_N, GRAM_N, 1, ops, len(params))
    bound, by = bound_ms(nbytes, flops)
    k_ms = cuda_ms(lambda: gram.gram_tiled(pieces, X, X), reps=20, warmup=3)
    p_ms = cuda_ms(lambda: gram.plain_gram(pieces, X, X), reps=20, warmup=3)
    cdist_ms = cuda_ms(lambda: torch.cdist(X[:, None], X[:, None]), reps=20, warmup=3)
    split, _ = kernel_split(lambda: gram.gram_tiled(pieces, X, X))
    device_ms = None if split is None else sum(
        ms * per for name, (ms, per) in split.items() if name.startswith("gram_kernel"))
    log(f"gram dense_pieces.py N={GRAM_N} [{CARD}]: B7 {k_ms:.4f} ms by events, "
        + ("device not measured (no device time in the trace)" if device_ms is None else
           f"{device_ms:.4f} ms of device time (trace)")
        + f", bound {bound:.4f} ms ({by}; {nbytes} bytes, {flops} operations), plain "
        f"{p_ms:.4f} ms")
    log(f"gram yardstick, not the same function [{CARD}]: torch.cdist of the same points "
        f"(the distance alone) {cdist_ms:.4f} ms")

    Xd = card(dense_data()[0])
    strips = strip_shapes(DENSE_N, DENSE_BLOCK)
    entries = sum((DENSE_N - lo) * (cr - lo) for lo, cr in strips)
    s_bytes = s_flops = 0
    for lo, cr in strips:
        nb, fl = gram_work(DENSE_N - lo, cr - lo, 1, ops, len(params))
        s_bytes, s_flops = s_bytes + nb, s_flops + fl
    s_bound, s_by = bound_ms(s_bytes, s_flops)
    strip_b7 = cuda_ms(
        lambda: [gram.gram_tiled(pieces, Xd[lo:], Xd[lo:cr]) for lo, cr in strips],
        reps=20, warmup=3)
    strip_now = cuda_ms(lambda: [pieces(Xd[lo:], Xd[lo:cr]) for lo, cr in strips],
                        reps=20, warmup=3)
    # The same launches without gram_tiled's host work (the tree walk, the
    # root maps, the autograd Function), and that host work per call.
    P = Xd[:, None]
    strip_launch = cuda_ms(lambda: [gram._launch(ops, params, P[lo:], P[lo:cr])
                                    for lo, cr in strips], reps=20, warmup=3)
    tiny = X[:64]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        gram.gram_tiled(pieces, tiny, tiny)
    torch.cuda.synchronize()
    call_us = (time.perf_counter() - t0) / 200 * 1e6
    log(f"gram strip shapes of the dense path (N={DENSE_N}, block {DENSE_BLOCK}: {len(strips)} "
        f"strips, {entries} entries) [{CARD}]: B7 summed {strip_b7:.4f} ms through gram_tiled, "
        f"{strip_launch:.4f} ms launched directly, bound {s_bound:.4f} ms ({s_by}); "
        f"kernel(X[lo:n], X[lo:cr]) as the strip build calls it today {strip_now:.4f} ms; one "
        f"gram_tiled call of 64 x 64 points {call_us:.1f} us on the host clock")
    if failures:
        raise AssertionError(f"kernel B7 failed: {failures}")
    return {
        "name": "gram_tiled",
        "route": "cuda",
        "source": "tinygp_tpu_torch/csrc/gram.cu",
        "replaces": "tinygp_tpu/ops/pallas_gram.py:107",
        "launches": launches,
        "max_abs_err": worst["abs"],
        "ms": k_ms,
        "device_ms": device_ms,
        "plain_ms": p_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }


def gram_host_split(kernel, X, calls=500):
    """Host microseconds of one ``gram_tiled(kernel, X, X)`` call (host
    clock, the card keeping up), and a ``cProfile`` split of ``calls``
    calls: the cumulative microseconds per call of each function of
    ``ops/gram.py`` and of the calls with the most time of their own."""
    import cProfile
    import pstats

    import torch

    from tinygp_tpu_torch.ops import gram

    for _ in range(20):
        gram.gram_tiled(kernel, X, X)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        gram.gram_tiled(kernel, X, X)
    torch.cuda.synchronize()
    call_us = (time.perf_counter() - t0) / calls * 1e6
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        gram.gram_tiled(kernel, X, X)
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    own = {}
    ours = {}
    for (path, line, func), (_, _, tottime, cumtime, _) in stats.items():
        name = f"{path.rsplit('/', 1)[-1]}:{func}" if line else func
        own[name] = own.get(name, 0.0) + tottime
        if path.endswith("ops/gram.py"):
            ours[f"{func}:{line}"] = cumtime
    total = sum(own.values()) / calls * 1e6
    top = sorted(own.items(), key=lambda kv: -kv[1])[:12]
    return call_us, total, {k: v / calls * 1e6 for k, v in ours.items()}, [
        (k, v / calls * 1e6) for k, v in top]


def gram_times():
    """``--gram-times``: kernel B7 alone, float32, on
    ``benchmarks/dense_pieces.py``'s ``1.5 * Matern32(scale=2.5)``: at
    1e4 x 1e4 and summed over the dense path's 20 strip shapes, each through
    ``gram_tiled`` and launched directly (``_launch``), beside PyTorch's
    ``fill_`` of a 1e4 x 1e4 output (a yardstick for the stores, not the
    same function); the host time of one
    64 x 64 ``gram_tiled`` call and its ``cProfile`` split. Every CUDA-event
    time is taken first, before any ``torch.profiler`` trace; then each
    case's device time and launches per call from a trace, two launches
    compared bit for bit and the 1e4 gram held to phase 15's limit (every
    number printed before a failure raises). Through entry points that older trees share,
    so that one chip call can time this tree and its parent in turns."""
    import torch

    from tinygp_tpu_torch import kernels
    from tinygp_tpu_torch.ops import gram

    def card(a):
        return torch.as_tensor(a, dtype=torch.float32, device="cuda")

    X = card(np.sort(np.random.default_rng(0).uniform(0, 10, GRAM_N)))
    pieces = (1.5 * kernels.Matern32(scale=2.5)).to("cuda")
    ops, params = gram._compile(pieces, X, X)[2:4]
    P = X[:, None]
    Xd = card(dense_data()[0])
    Pd = Xd[:, None]
    strips = strip_shapes(DENSE_N, DENSE_BLOCK)
    cases = {
        f"N={GRAM_N} gram_tiled": lambda: gram.gram_tiled(pieces, X, X),
        f"N={GRAM_N} launched directly": lambda: gram._launch(ops, params, P, P),
        f"{len(strips)} strips gram_tiled": lambda: [
            gram.gram_tiled(pieces, Xd[lo:], Xd[lo:cr]) for lo, cr in strips],
        f"{len(strips)} strips launched directly": lambda: [
            gram._launch(ops, params, Pd[lo:], Pd[lo:cr]) for lo, cr in strips],
    }
    # A yardstick, not the same function: PyTorch's fill of an output of the
    # same size, what plain stores reach on this card.
    filled = torch.empty(GRAM_N, GRAM_N, device="cuda")
    cases[f"N={GRAM_N} yardstick fill_"] = lambda: filled.fill_(1.5)
    nbytes, flops = gram_work(GRAM_N, GRAM_N, 1, ops, len(params))
    s_bytes = s_flops = 0
    for lo, cr in strips:
        nb, fl = gram_work(DENSE_N - lo, cr - lo, 1, ops, len(params))
        s_bytes, s_flops = s_bytes + nb, s_flops + fl
    bounds = [bound_ms(nbytes, flops)] * 2 + [bound_ms(s_bytes, s_flops)] * 2 + [
        bound_ms(4 * GRAM_N * GRAM_N, 0)]

    # The clocks first: no trace has run in this process yet.
    event_ms = {label: cuda_ms(fn, reps=50, warmup=5) for label, fn in cases.items()}
    call_us, profiled_us, ours, top = gram_host_split(pieces, X[:64])

    got, again = cases[f"N={GRAM_N} gram_tiled"](), cases[f"N={GRAM_N} launched directly"]()
    same = torch.equal(got, again)
    want = gram_f64(pieces, X, X)
    err = float((got.double() - want).abs().max())
    plain = float((gram.plain_gram(pieces, X, X).double() - want).abs().max())
    limit = 2 * plain + 1e-6 * float(want.abs().max())
    del got, again, want
    for (label, fn), (bound, by) in zip(cases.items(), bounds):
        split, per_call = kernel_split(fn)
        device = ("not measured (no device time in the trace)" if split is None else
                  f"{sum(ms * per for ms, per in split.values()):.4f} ms")
        shown = ("" if split is None else
                 ", ".join(f"{k} {ms:.4f} x {per:g}" for k, (ms, per) in split.items()))
        log(f"gram-times {label} float32 [{CARD}]: events {event_ms[label]:.4f} ms, device "
            f"{device} (bound {bound:.4f} ms, {by})")
        log(f"gram-times {label} trace: {per_call:g} device operations per call; ms per launch "
            f"x launches per call: {shown}")
    ok = same and err <= limit
    log(f"gram-times N={GRAM_N}: two launches equal bit for bit {same}; against float64 "
        f"{err:.3e} (limit {limit:.3e}) {'ok' if ok else 'FAIL'}")
    log(f"gram-times one gram_tiled call of 64 x 64 points [{CARD}]: {call_us:.1f} us on the "
        f"host clock; under cProfile {profiled_us:.1f} us")
    log("gram-times cProfile, ops/gram.py cumulative us per call: "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(ours.items(), key=lambda kv: -kv[1])))
    log("gram-times cProfile, most own time, us per call: "
        + ", ".join(f"{k} {v:.1f}" for k, v in top))
    if not ok:
        raise AssertionError(f"B7 at N={GRAM_N} failed its checks")


# ---------------------------------------------------------------------------
# A chain axis in B1, B1r and B2, and the many-chain samplers (phases 17-18).
# ---------------------------------------------------------------------------

# (chains, N, m, dtype, shared y): the sampler path's shape with and without
# its shared data, a long series whose chains span 196 tiles each, and the
# templated kernels' largest order in float64.
CHAIN_CASES = [
    (1024, 512, 2, "float32", True),
    (1024, 512, 2, "float32", False),
    (64, 100_000, 2, "float32", False),
    (16, 4096, 4, "float64", False),
]


def chain_bound_ms(kind, chains, m, n, itemsize, shared_y):
    """Least time for one chain-axis launch: ``chains`` times the unbatched
    bytes (``loglik_bound_ms``, ``bwd_bound_ms``), y read once when every
    chain shares it, or the operations."""
    per = {"b1": m * m + 2 * m + 2, "b1r": 2 * m * m + 3 * m + 3, "b2": 3 * m * m + 5 * m + 4}
    values = chains * per[kind] * n - (chains - 1) * n * shared_y
    ops = 8 * m**3 + 25 * m**2 + 30 * m + 25 if kind == "b2" else 4 * m**3 + 11 * m**2 + 6 * m + 8
    return bound_ms(values * itemsize + 2 * chains * itemsize, chains * n * ops)


def chain_err(got, want):
    """The largest, over chains, of each chain's largest error relative to
    its stream's largest magnitude, in float64."""
    g, w = got.double().flatten(1), want.double().flatten(1)
    return float(((g - w).abs().amax(1) / w.abs().amax(1).clamp_min(1e-300)).max())


def chain_operands_on_card(chains, n, m, dtype, shared_y, seed):
    import torch

    from tinygp_tpu_torch.test_utils import random_qsm_operands

    per = [random_qsm_operands(m, n, seed + c) for c in range(chains)]
    ops = [torch.as_tensor(np.stack(x), dtype=dtype, device="cuda") for x in zip(*per)]
    if shared_y:
        ops[4] = ops[4][0].clone()
    return ops


def phase_chain_kernels():
    """Phase 17: B1, B1r and B2 over a chain axis at each of CHAIN_CASES,
    against their plain versions (per chain and output stream, rtol 1e-8
    in float64 and 5e-4 in float32 against float64) and, bit for bit,
    against the unbatched launch on each chain's operands; one launch each;
    CUDA-event times beside the bound, the plain version and, for B1r, the
    unbatched launches of every chain in turn. Returns the three records at
    the sampler path's shape (the first case)."""
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik as cl

    records = {}
    failures = []
    for chains, n, m, dtype_name, shared in CHAIN_CASES:
        dtype = getattr(torch, dtype_name)
        itemsize = torch.empty((), dtype=dtype).element_size()
        d, ps, qs, as_, y = ops = chain_operands_on_card(chains, n, m, dtype, shared, 1000 * m)
        qbar = torch.linspace(0.5, 1.5, chains, dtype=dtype, device="cuda")
        lbar = torch.tensor(-1.0, dtype=dtype, device="cuda")
        before = dict(cl.LAUNCHES_CHAINS)
        value = cl.fused_loglik_terms_chains(*ops)
        res = cl.fused_loglik_res_chains(*ops)
        bwd_ops = (ps, qs, as_, y, *res[2:], qbar, lbar)
        grads = cl.fused_loglik_bwd_chains(*bwd_ops)
        torch.cuda.synchronize()
        one = all(cl.LAUNCHES_CHAINS[k] == before[k] + 1 for k in before)

        # Bit for bit: each chain's unbatched launch on its own operands.
        def part(x, c, rank):
            return x[c] if x.ndim == rank + 1 else x

        singles = [cl.fused_loglik_res(*(part(x, c, r) for x, r in zip(ops, (1, 2, 2, 2, 1))))
                   for c in range(chains)]
        single_values = [cl.fused_loglik_terms(*(part(x, c, r) for x, r in
                                                 zip(ops, (1, 2, 2, 2, 1))))
                         for c in range(chains)]
        single_grads = [cl.fused_loglik_bwd(*(part(x, c, r) for x, r in
                                              zip(bwd_ops, (2, 2, 2, 1, 2, 2, 1, 0, 0))))
                        for c in range(chains)]
        same = (all(torch.equal(a, torch.stack(b)) for a, b in zip(res, zip(*singles)))
                and all(torch.equal(a, torch.stack(b)) for a, b in zip(value, zip(*single_values)))
                and all(torch.equal(a, torch.stack(b)) for a, b in zip(grads, zip(*single_grads))))
        del singles, single_values, single_grads

        # The plain versions in float64 on the same values.
        f64 = [x.double() for x in ops]
        want_res = cl.plain_loglik_terms_res_chains(*f64)
        want_bwd = cl.plain_loglik_bwd_chains(*f64[1:], *(x.double() for x in res[2:]),
                                              qbar.double(), lbar.double())
        rtol = 1e-8 if dtype == torch.float64 else 5e-4
        errs = {
            "b1": max(chain_err(g[:, None], w[:, None]) for g, w in zip(value, want_res[:2])),
            "b1r": max(chain_err(g if g.ndim > 1 else g[:, None], w if w.ndim > 1 else w[:, None])
                       for g, w in zip(res, want_res)),
            "b2": max(chain_err(g, w) for g, w in zip(grads, want_bwd)),
        }
        abs_errs = {
            "b1": max(float((g.double() - w).abs().max()) for g, w in zip(value, want_res[:2])),
            "b1r": max(float((g.double() - w).abs().max()) for g, w in zip(res, want_res)),
            "b2": max(float((g.double() - w).abs().max()) for g, w in zip(grads, want_bwd)),
        }
        finite = all(bool(torch.isfinite(x).all()) for x in (*value, *res, *grads))
        del f64, want_res, want_bwd

        ms = {
            "b1": cuda_ms(lambda: cl.fused_loglik_terms_chains(*ops), reps=20, warmup=3),
            "b1r": cuda_ms(lambda: cl.fused_loglik_res_chains(*ops), reps=20, warmup=3),
            "b2": cuda_ms(lambda: cl.fused_loglik_bwd_chains(*bwd_ops), reps=20, warmup=3),
        }
        loop_ms = cuda_ms(lambda: [cl.fused_loglik_res(*(part(x, c, r) for x, r in
                                                         zip(ops, (1, 2, 2, 2, 1))))
                                   for c in range(chains)], reps=3, warmup=1)
        plain_ms = {
            "b1": None,
            "b1r": cuda_ms(lambda: cl.plain_loglik_terms_res_chains(*ops), reps=1, warmup=0),
            "b2": cuda_ms(lambda: cl.plain_loglik_bwd_chains(*bwd_ops), reps=1, warmup=0),
        }
        plain_ms["b1"] = plain_ms["b1r"]  # B1's plain version is B1r's, the residuals dropped
        ok = one and same and finite and all(e <= rtol for e in errs.values())
        for kind in ("b1", "b1r", "b2"):
            bound, by = chain_bound_ms(kind, chains, m, n, itemsize, shared)
            log(f"chain-kernel {kind} C={chains} N={n} m={m} {dtype_name}"
                f"{' shared y' if shared else ''}: one launch {one}, bit for bit the unbatched "
                f"launch of each chain {same}, vs plain (float64) rel {errs[kind]:.3e} abs "
                f"{abs_errs[kind]:.4g} (rtol {rtol:g}), {ms[kind]:.4f} ms (events), bound "
                f"{bound:.4f} ms ({by}), plain {plain_ms[kind]:.4f} ms"
                + (f", {chains} unbatched launches in turn {loop_ms:.4f} ms" if kind == "b1r"
                   else "") + f" {'ok' if ok else 'FAIL'}")
            if (chains, n, m, dtype_name, shared) == CHAIN_CASES[0]:
                records[kind] = {
                    "max_abs_err": abs_errs[kind], "ms": ms[kind], "plain_ms": plain_ms[kind],
                    "bound_ms": bound, "bound_by": by, "library_ms": None,
                }
        if not ok:
            failures.append((chains, n, m, dtype_name, shared))
        del ops, res, value, grads, bwd_ops
    if failures:
        raise AssertionError(f"chain-axis kernels failed: {failures}")
    names = {"b1": ("quasisep_loglik_chains", "quasisep_loglik.cu", 86),
             "b1r": ("quasisep_loglik_res_chains", "quasisep_loglik.cu", 86),
             "b2": ("quasisep_loglik_bwd_chains", "quasisep_loglik_bwd.cu", 414)}
    for kind, (name, source, line) in names.items():
        records[kind] = {"name": name, "route": "cuda",
                         "source": f"tinygp_tpu_torch/csrc/{source}",
                         "replaces": f"tinygp_tpu/solvers/quasisep/pallas_loglik.py:{line}",
                         "launches": 0, **records[kind]}
    return records


SAMPLER_INIT = {"log_amp": 0.0, "log_omega": 1.0, "log_q": 1.0, "log_jitter": -2.0}


def nuts_model(device, n=512):
    """``benchmarks/nuts_throughput.py:38-54``: ``amp * SHO(omega, quality)``,
    ``diag = jitter + 0.09``, standard-normal priors on the four log
    parameters, its data from ``default_rng(0)``, float32 on ``device``."""
    import torch

    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep

    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 10, n))
    y = np.sin(3 * t) * np.exp(-0.1 * t) + 0.3 * rng.normal(size=n)
    X = torch.as_tensor(t, dtype=torch.float32, device=device)
    Y = torch.as_tensor(y, dtype=torch.float32, device=device)

    def gp_of(params):
        amp, omega, q, jitter = (torch.exp(params[k]) for k in SAMPLER_INIT)
        kernel = amp * quasisep.SHO(omega=omega, quality=q)
        return GaussianProcess(kernel, X, diag=jitter + 0.09, assume_sorted=True, device=device)

    def log_prob(params):
        return gp_of(params).log_probability(Y) - 0.5 * sum(
            torch.sum(torch.square(v)) for v in params.values())

    init = {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in SAMPLER_INIT.items()}
    return log_prob, gp_of, init, Y


def loglik_counts():
    """B1, B1r and B2 launches since reset_loglik_counts(), unbatched and
    over a chain axis, and those of the generic-order sources and of B3."""
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik as cl, cuda_scan

    return {"b1": cl.LAUNCHES, "b1r": cl.LAUNCHES_RES, "b2": cl.LAUNCHES_BWD,
            "chains": dict(cl.LAUNCHES_CHAINS), "generic": sum(cl.LAUNCHES_GENERIC.values()),
            "b3": sum(cuda_scan.LAUNCHES.values()) + sum(cuda_scan.LAUNCHES_GENERIC.values())}


def reset_loglik_counts():
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik as cl

    reset_counts()
    for k in cl.LAUNCHES_CHAINS:
        cl.LAUNCHES_CHAINS[k] = 0


def sampler_counts(hmc_mod):
    """The kernels' and the samplers' counts since reset_sampler_counts()."""
    return {"evaluations": hmc_mod.EVALUATIONS, **loglik_counts()}


def reset_sampler_counts(hmc_mod):
    reset_loglik_counts()
    hmc_mod.EVALUATIONS = 0


def one_launch_per_evaluation(counts):
    """Each batched gradient evaluation was one chain-axis B1r and one B2
    launch, with no per-chain, value-only or other launch."""
    e = counts["evaluations"]
    return (e > 0 and counts["b1r"] == counts["chains"]["b1r"] == e
            and counts["b2"] == counts["chains"]["b2"] == e
            and counts["b1"] == counts["chains"]["b1"] == 0
            and counts["generic"] == counts["b3"] == 0)


# nuts_throughput.py's settings. The whole script's phase 18 runs half the
# warmup and a quarter of the samples (on an NVIDIA H100 80GB HBM3 at
# 700.00 W one run took 178 s at these settings and 65-123 s at half of
# both, and phase 25 adds two 1024-chain runs of its own); ``--sampler``
# runs them as they are.
NUTS_RUN = dict(num_chains=1024, num_warmup=100, num_samples=100, max_tree_depth=6,
                jitter_init=0.1, steps_per_dispatch=25)
NUTS_RUN_CUT = dict(NUTS_RUN, num_warmup=50, num_samples=25)


def phase_sampler(run=NUTS_RUN_CUT):
    """Phase 18: ``run_mcmc(..., sampler="nuts")`` on ``nuts_throughput.py``'s
    model and settings (1024 chains, N = 512, float32; ``run``, by default
    with half its warmup and a quarter of its samples) with the launch counts read around it; finite samples, a mean accept statistic in
    [0.6, 0.95] and split R-hat below 1.1 on every parameter; the batched
    value and gradient of four chains against the plain version on the
    CPU; a checkpointed run interrupted and resumed equal to the
    uninterrupted one; samples/s, the wall time and one batched gradient
    evaluation's time and split; then ``hmc`` (8 leapfrogs of 1e-3, 5
    steps) on 64 chains of the Matern32 model at ``bench.py``'s N = 1e5. Returns the
    launches of B1r and B2 over both runs."""
    import importlib
    import os

    import torch

    from tinygp_tpu_torch.samplers import potential_scale_reduction, run_mcmc
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik as cl

    hmc_mod = importlib.import_module("tinygp_tpu_torch.samplers.hmc")
    log_prob, gp_of, init, Y = nuts_model("cuda")

    # The main path, once, with the counts read around it.
    reset_sampler_counts(hmc_mod)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, info = run_mcmc(0, log_prob, init, device="cuda", **run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = sampler_counts(hmc_mod)
    one = one_launch_per_evaluation(counts)
    finite = all(bool(torch.isfinite(v).all()) for v in samples.values())
    shapes = all(v.shape == (run["num_samples"], run["num_chains"]) for v in samples.values())
    accept = float(info.accept_prob.mean())
    rhat = {k: float(potential_scale_reduction(v.double())) for k, v in samples.items()}
    moments = {k: (float(v.double().mean()), float(v.double().std())) for k, v in samples.items()}
    total = run["num_chains"] * run["num_samples"]
    steps = info.num_steps.double()
    log(f"sampler nuts: {run}, {CARD}: wall {wall:.3f} s (warmup included), "
        f"{total / wall:.1f} samples/s, batched evaluations {counts['evaluations']}, launches "
        f"{counts}, one chain-axis B1r and B2 launch per evaluation and none per chain {one}")
    log(f"sampler nuts: accept {accept:.4f} (limits [0.6, 0.95]), split R-hat {rhat} (< 1.1), "
        f"mean/sd {moments}, leapfrogs per transition mean {float(steps.mean()):.2f} max "
        f"{int(steps.max())}, divergent {float(info.diverging.double().mean()):.4f}, finite "
        f"{finite}, shapes {shapes}")
    ok = (one and finite and shapes and 0.6 <= accept <= 0.95
          and all(r < 1.1 for r in rhat.values()))

    # One batched evaluation at the final positions, timed whole and split.
    flat = torch.stack([samples[k][-1] for k in SAMPLER_INIT], dim=-1).contiguous()
    ravel, unravel, dim = hmc_mod._ravel_spec(init)
    value_and_grad = hmc_mod._value_and_grad(lambda z: log_prob(unravel(z)))
    eval_ms = cuda_ms(lambda: value_and_grad(flat), reps=20, warmup=3)
    with torch.no_grad():
        def construct(z):
            return gp_of(unravel(z)).solver.ssm

        construct_ms = cuda_ms(lambda: torch.func.vmap(construct)(flat), reps=20, warmup=3)
        d, ps, qs, as_ = torch.func.vmap(construct)(flat)
        ops = tuple(x.contiguous() for x in (d, ps, qs, as_)) + (Y,)
        b1r_ms = cuda_ms(lambda: cl.fused_loglik_res_chains(*ops), reps=20, warmup=3)
        res = cl.fused_loglik_res_chains(*ops)
        bars = (torch.full((flat.shape[0],), -0.5, dtype=flat.dtype, device="cuda"),
                torch.full((flat.shape[0],), -1.0, dtype=flat.dtype, device="cuda"))
        b2_ms = cuda_ms(lambda: cl.fused_loglik_bwd_chains(*ops[1:], *res[2:], *bars),
                        reps=20, warmup=3)
    log(f"sampler nuts: one batched gradient evaluation ({flat.shape[0]} chains, N = 512, "
        f"float32, {CARD}) {eval_ms:.4f} ms (events): constructor {construct_ms:.4f}, B1r "
        f"{b1r_ms:.4f}, B2 {b2_ms:.4f}, autograd and the rest "
        f"{eval_ms - construct_ms - b1r_ms - b2_ms:.4f} ms")

    # Four chains' value and gradient against the plain version on the CPU,
    # float32 both (the tolerance table's 5e-4).
    lp_card, g_card = value_and_grad(flat[:4])
    cpu_log_prob, _, cpu_init, _ = nuts_model("cpu")
    _, cpu_unravel, _ = hmc_mod._ravel_spec(cpu_init)
    ref_err = 0.0
    for c in range(4):
        z = flat[c].cpu().clone().requires_grad_(True)
        lp = cpu_log_prob(cpu_unravel(z))
        (g,) = torch.autograd.grad(lp, z)
        lp = float(lp.detach())
        ref_err = max(ref_err, abs(float(lp_card[c]) - lp) / abs(lp),
                      float((g_card[c].cpu() - g).abs().max() / g.abs().max()))
    log(f"sampler nuts: batched value and gradient of 4 chains vs the plain version on the CPU "
        f"(float32): rel {ref_err:.3e} (5e-4)")
    ok = ok and ref_err <= 5e-4

    # A checkpointed run, interrupted after its third save, resumed: the
    # uninterrupted run's samples bit for bit (full width, short phases).
    short = dict(NUTS_RUN, num_warmup=6, num_samples=4, steps_per_dispatch=3)
    path = os.path.join("build", "chip_smoke", "mcmc.npz")
    if os.path.exists(path):
        os.remove(path)
    t0 = time.perf_counter()
    full = run_mcmc(7, log_prob, init, device="cuda", **short)
    real_save, calls = hmc_mod.checkpoint.save_pytree, [0]

    class Preempted(Exception):
        pass

    def exploding_save(p, tree):
        real_save(p, tree)
        calls[0] += 1
        if calls[0] == 3:
            raise Preempted

    hmc_mod.checkpoint.save_pytree = exploding_save
    try:
        run_mcmc(7, log_prob, init, checkpoint_path=path, device="cuda", **short)
        interrupted = False
    except Preempted:
        interrupted = True
    finally:
        hmc_mod.checkpoint.save_pytree = real_save
    resumed = run_mcmc(7, log_prob, init, checkpoint_path=path, device="cuda", **short)
    same = interrupted and all(torch.equal(full[0][k], resumed[0][k]) for k in full[0]) and all(
        torch.equal(a, b) for a, b in zip(full[1], resumed[1]))
    log(f"sampler nuts: checkpointed run {short}, interrupted after its third save "
        f"{interrupted}, resumed equal to the uninterrupted run bit for bit {same} "
        f"({time.perf_counter() - t0:.2f} s for the three runs)")
    ok = ok and same
    launches = {"b1r": counts["b1r"], "b2": counts["b2"]}

    # The long series: hmc, 8 leapfrogs, 5 steps, 64 chains at N = 1e5.
    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep

    (X5, y5), _ = bench_data()
    X = torch.as_tensor(X5, dtype=torch.float32, device="cuda")
    y = torch.as_tensor(y5, dtype=torch.float32, device="cuda")

    def matern32_log_prob(params):
        amp, scale = torch.exp(params["log_amp"]), torch.exp(params["log_scale"])
        gp = GaussianProcess(amp * quasisep.Matern32(scale=scale), X, diag=0.1,
                             assume_sorted=True, device="cuda")
        return gp.log_probability(y) - 0.5 * (params["log_amp"] ** 2 + params["log_scale"] ** 2)

    m32_init = {k: torch.tensor(math.log(v), dtype=torch.float32, device="cuda")
                for k, v in (("log_amp", 1.5), ("log_scale", 2.5))}
    reset_sampler_counts(hmc_mod)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # A step of 1e-3 in the log parameters, whose posterior sd at this N is
    # about 5e-3: the trajectories accept, so the chains move.
    m32, m32_info = run_mcmc(1, matern32_log_prob, m32_init, num_chains=64, num_warmup=0,
                             num_samples=5, sampler="hmc", num_leapfrog=8,
                             initial_step_size=1e-3, jitter_init=0.01, steps_per_dispatch=None,
                             device="cuda")
    torch.cuda.synchronize()
    m32_wall = time.perf_counter() - t0
    m32_counts = sampler_counts(hmc_mod)
    m32_one = one_launch_per_evaluation(m32_counts)
    m32_finite = all(bool(torch.isfinite(v).all()) for v in m32.values())
    log(f"sampler hmc matern32: 64 chains, N = 1e5, float32, 8 leapfrogs x 5 steps of 1e-3, "
        f"{CARD}: wall {m32_wall:.3f} s, batched evaluations "
        f"{m32_counts['evaluations']}, launches {m32_counts}, one chain-axis B1r and B2 launch "
        f"per evaluation {m32_one}, accept {float(m32_info.accept_prob.mean()):.4f}, finite "
        f"{m32_finite}")
    ok = ok and m32_one and m32_finite
    if not ok:
        raise AssertionError("the sampler phase failed")
    launches["b1r"] += m32_counts["b1r"]
    launches["b2"] += m32_counts["b2"]
    return launches


# ---------------------------------------------------------------------------
# ADVI, tempered SMC and CARMA (phases 19-21).
# ---------------------------------------------------------------------------

SMC_VI_INIT = {"log_amp": 0.0, "log_omega": 1.0, "log_q": 1.0}


def smc_vi_model(device, m5=False):
    """``benchmarks/smc_vi_rate.py:36-68``: ``amp * SHO(omega, quality)``,
    ``diag=0.09``, N = 512 from ``default_rng(0)``, standard-normal priors
    on the three log parameters, float32 on ``device``; with ``m5``, plus
    ``Matern52(scale=2.5)`` (m = 5). Returns ``(log_like, log_prior,
    log_post, init, gp_of, Y)``."""
    import torch

    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep

    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 10, 512))
    y = np.sin(3 * t) * np.exp(-0.1 * t) + 0.3 * rng.normal(size=512)
    X = torch.as_tensor(t, dtype=torch.float32, device=device)
    Y = torch.as_tensor(y, dtype=torch.float32, device=device)

    def gp_of(p):
        kernel = torch.exp(p["log_amp"]) * quasisep.SHO(omega=torch.exp(p["log_omega"]),
                                                       quality=torch.exp(p["log_q"]))
        if m5:
            kernel = kernel + quasisep.Matern52(scale=2.5)
        return GaussianProcess(kernel, X, diag=0.09, assume_sorted=True, device=device)

    def log_like(p):
        return gp_of(p).log_probability(Y)

    def log_prior(p):
        return -0.5 * sum(torch.sum(torch.square(v)) for v in p.values())

    def log_post(p):
        return log_like(p) + log_prior(p)

    init = {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in SMC_VI_INIT.items()}
    return log_like, log_prior, log_post, init, gp_of, Y


def flat(fn):
    """``fn`` of a dict position as a function of a flat ``(3,)`` one."""
    return lambda z: fn({k: z[i] for i, k in enumerate(SMC_VI_INIT)})


def c6_check(m5):
    """The gradient of ``mean(vmap(log_post)(zs))`` taken outside the
    ``vmap`` (ADVI's order; ROADMAP C6), 8 draws of ``smc_vi_model``, float32:
    on the card by ``torch.autograd.grad`` and by ``torch.func.grad``,
    against the plain path on the CPU and against each draw's unbatched
    gradient on the card. Logs both gradients and their distances; returns
    whether they agree within 5e-4 of the largest entry with the expected
    launches (at m = 2 one chain-axis B1r and B2, at m = 5 eight unbatched
    ones)."""
    import torch

    zs_np = np.array([0.0, 1.0, 1.0]) + 0.2 * np.random.default_rng(1).normal(size=(8, 3))

    def mean_grad(device, how):
        lp = flat(smc_vi_model(device, m5)[2])
        zs = torch.as_tensor(zs_np, dtype=torch.float32, device=device)
        if how == "func":
            return torch.func.grad(lambda z: torch.mean(torch.func.vmap(lp)(z)))(zs)
        zs.requires_grad_(True)
        return torch.autograd.grad(torch.mean(torch.func.vmap(lp)(zs)), zs)[0]

    reset_loglik_counts()
    card = mean_grad("cuda", "autograd")
    torch.cuda.synchronize()
    launches = loglik_counts()
    cpu = mean_grad("cpu", "autograd")
    lp_card = flat(smc_vi_model("cuda", m5)[2])
    loop = []
    for z in torch.as_tensor(zs_np, dtype=torch.float32, device="cuda"):
        z = z.clone().requires_grad_(True)
        loop.append(torch.autograd.grad(lp_card(z) / 8, z)[0])
    loop = torch.stack(loop)
    scale = float(cpu.abs().max())
    grads = {"autograd": card}
    try:
        grads["func"] = mean_grad("cuda", "func")
    except RuntimeError as err:  # a tree whose vmap rule launches on functorch's wrappers
        log(f"c6: torch.func.grad outside the vmap raised: {err}")
    errs = {name: float((g.cpu() - cpu).abs().max()) / scale for name, g in grads.items()}
    errs.setdefault("func", math.inf)
    loop_err = max(float((g - loop).abs().max()) / scale for g in grads.values())
    m, per = (5, 8) if m5 else (2, 1)
    counts_ok = (launches["b1"] == 0 and launches["b1r"] == launches["b2"] == per
                 and launches["chains"]["b1r"] == launches["chains"]["b2"] == (m == 2))
    ok = max(errs.values()) <= 5e-4 and loop_err <= 5e-4 and counts_ok
    log(f"c6 m={m}: d mean(vmap(log_post)(zs)) / d zs outside the vmap, 8 draws of "
        f"smc_vi_rate.py's model{' + Matern52(2.5)' if m5 else ''}, N = 512, float32, zs = "
        f"{np.round(zs_np, 6).tolist()} [{CARD}]")
    log(f"c6 m={m}: card (autograd) {np.round(card.cpu().double().numpy(), 6).tolist()}")
    log(f"c6 m={m}: CPU plain path {np.round(cpu.double().numpy(), 6).tolist()}")
    log(f"c6 m={m}: card against the CPU, of the largest entry {scale:.6g}: autograd "
        f"{errs['autograd']:.3e}, func {errs['func']:.3e}; against each draw's unbatched "
        f"gradient on the card {loop_err:.3e} (limits 5e-4); launches of the autograd "
        f"gradient {launches} (want {per} B1r and B2"
        f"{', over a chain axis' if m == 2 else ', unbatched'}) {'ok' if ok else 'FAIL'}")
    return ok


ADVI_RUN = dict(num_elbo_samples=8, learning_rate=1e-2)


def phase_advi(steps=200):
    """Phase 19: ``fit_advi`` at ``benchmarks/smc_vi_rate.py``'s settings
    (``smc_vi_model``, 8 ELBO draws, lr 1e-2), mean-field and full-rank,
    ``steps`` steps (the script's 1000 under ``--sampler``). First the
    gradient outside the ``vmap`` (``c6_check`` at m = 2 and 5) and the ELBO's
    gradient at fixed noise on the card against the CPU plain path (5e-4 of
    its largest entry). Each run once with the counts read around it: one
    chain-axis B1r and one B2 launch a step and nothing else; a finite trace
    whose last 100 steps' mean beats the first 100's. Steps/s cold (the
    first run) and warm (a second seed), as ``smc_vi_rate.py`` takes them,
    and one step's CUDA-event time split into the constructor, B1r, B2 and
    the rest. Returns the chain-axis B1r and B2 launches of the runs."""
    import torch

    from tinygp_tpu_torch.samplers import fit_advi
    from tinygp_tpu_torch.samplers.hmc import _ravel_spec
    from tinygp_tpu_torch.samplers.vi import _elbo
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik as cl

    ok = c6_check(False)
    ok = c6_check(True) and ok

    # The ELBO's gradient in phi at fixed noise, card against the CPU.
    eps_np = np.random.default_rng(2).normal(size=(8, 3))
    for full_rank in (False, True):
        grads = []
        for device in ("cuda", "cpu"):
            _, _, log_post, init, _, _ = smc_vi_model(device)
            phi = [torch.tensor([-1.0, 1.1, 2.0], device=device),
                   torch.tensor([-1.5, -2.0, -0.8], device=device)]
            if full_rank:
                phi.append(torch.as_tensor(0.3 * np.random.default_rng(3).normal(size=(3, 3)),
                                           dtype=torch.float32, device=device))
            phi = [p.requires_grad_(True) for p in phi]
            _, unravel, _ = _ravel_spec(init)
            elbo = _elbo(lambda z: log_post(unravel(z)), full_rank)(
                phi, torch.as_tensor(eps_np, dtype=torch.float32, device=device))
            grads.append(torch.cat([g.reshape(-1).cpu() for g in torch.autograd.grad(elbo, phi)]))
        err = float((grads[0] - grads[1]).abs().max() / grads[1].abs().max())
        log(f"advi {'full-rank' if full_rank else 'mean-field'}: the ELBO's gradient in phi at "
            f"fixed noise, card against the CPU plain path {err:.3e} of its largest entry "
            f"(limit 5e-4) {'ok' if err <= 5e-4 else 'FAIL'}")
        ok = ok and err <= 5e-4

    launches = {"b1r": 0, "b2": 0}
    _, _, log_post, init, gp_of, Y = smc_vi_model("cuda")
    for full_rank in (False, True):
        name = "full-rank" if full_rank else "mean-field"
        reset_loglik_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit_advi(0, log_post, init, num_steps=steps, full_rank=full_rank, device="cuda",
                       **ADVI_RUN)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        counts = loglik_counts()
        t0 = time.perf_counter()
        fit_advi(1, log_post, init, num_steps=steps, full_rank=full_rank, device="cuda",
                 **ADVI_RUN)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        one = (counts["b1r"] == counts["chains"]["b1r"] == steps
               and counts["b2"] == counts["chains"]["b2"] == steps
               and counts["b1"] == counts["generic"] == counts["b3"] == 0)
        trace = res.elbo_trace.cpu().numpy()
        finite = bool(np.isfinite(trace).all()) and all(
            bool(torch.isfinite(x).all()) for x in res[:2])
        rising = float(trace[-100:].mean()) > float(trace[:100].mean())
        log(f"advi {name}: {steps} steps, {ADVI_RUN}, [{CARD}]: cold {cold:.3f} s "
            f"({steps / cold:.1f} steps/s), warm {warm:.3f} s ({steps / warm:.1f} steps/s); "
            f"launches {counts}, one chain-axis B1r and B2 a step and nothing else {one}; "
            f"ELBO first/last 100 steps {float(trace[:100].mean()):.4f} / "
            f"{float(trace[-100:].mean()):.4f}, final {float(trace[-1]):.4f}, finite {finite}; "
            f"mean {res.mean.cpu().numpy().round(4).tolist()}")
        ok = ok and one and finite and rising
        launches["b1r"] += counts["chains"]["b1r"]
        launches["b2"] += counts["chains"]["b2"]

        # One step, timed whole and split.
        ravel, unravel, dim = _ravel_spec(init)
        mean0 = ravel(init)
        phi = [mean0.clone(), torch.full_like(mean0, -2.0)]
        if full_rank:
            phi.append(mean0.new_zeros(dim, dim))
        phi = [p.requires_grad_(True) for p in phi]
        optimizer = torch.optim.Adam(phi, lr=ADVI_RUN["learning_rate"])
        elbo = _elbo(lambda z: log_post(unravel(z)), full_rank)
        eps = torch.randn((8, dim), generator=torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")

        def step():
            optimizer.zero_grad(set_to_none=True)
            (-elbo(phi, eps)).backward()
            optimizer.step()

        step_ms = cuda_ms(step, reps=20, warmup=3)
        zs = phi[0].detach()[None, :] + 0.1 * eps
        with torch.no_grad():
            def construct(z):
                return gp_of(unravel(z)).solver.ssm

            construct_ms = cuda_ms(lambda: torch.func.vmap(construct)(zs), reps=20, warmup=3)
            ops = tuple(x.contiguous() for x in torch.func.vmap(construct)(zs)) + (Y,)
            b1r_ms = cuda_ms(lambda: cl.fused_loglik_res_chains(*ops), reps=20, warmup=3)
            res = cl.fused_loglik_res_chains(*ops)
            bars = (torch.full((8,), -0.5, device="cuda"), torch.full((8,), -1.0, device="cuda"))
            b2_ms = cuda_ms(lambda: cl.fused_loglik_bwd_chains(*ops[1:], *res[2:], *bars),
                            reps=20, warmup=3)
        bounds = [chain_bound_ms(kind, 8, 2, 512, 4, True)[0] for kind in ("b1r", "b2")]
        log(f"advi {name}: one step (8 draws, N = 512, float32, [{CARD}]) {step_ms:.4f} ms "
            f"(events): constructor {construct_ms:.4f}, B1r {b1r_ms:.4f}, B2 {b2_ms:.4f} "
            f"(bounds {bounds[0]:.6f}, {bounds[1]:.6f}), autograd, Adam and the rest "
            f"{step_ms - construct_ms - b1r_ms - b2_ms:.4f} ms")
    if not ok:
        raise AssertionError("the ADVI phase failed")
    return launches


SMC_PARTICLES = 1024


def phase_smc():
    """Phase 20: ``run_smc`` at ``benchmarks/smc_vi_rate.py``'s settings
    (``smc_vi_model``'s likelihood and prior, 1024 particles about the
    initial position, 5 mutations), cold and warm, with the counts read
    around the cold run: one chain-axis B1 launch per batched evaluation and
    nothing else. The ladder increasing to 1.0 and NaN-padded, acceptance
    in [0, 1], finite particles and log evidence; 4 particles'
    log-likelihood against the plain version on the CPU (5e-4); then
    ``tests/test_samplers/test_vi_smc.py``'s Gaussian target with its
    analytic posterior and evidence (0.15). Returns the chain-axis B1
    launches of the cold run."""
    import importlib

    import torch

    from tinygp_tpu_torch.samplers import run_smc

    smc_mod = importlib.import_module("tinygp_tpu_torch.samplers.smc")
    log_like, log_prior, _, init, _, _ = smc_vi_model("cuda")
    rng = np.random.default_rng(0)
    parts = {k: v + torch.as_tensor(rng.normal(size=SMC_PARTICLES), dtype=torch.float32,
                                    device="cuda") for k, v in init.items()}

    reset_loglik_counts()
    smc_mod.EVALUATIONS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_smc(0, log_prior, log_like, parts, num_mutations=5, device="cuda")
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    counts, evals = loglik_counts(), smc_mod.EVALUATIONS
    t0 = time.perf_counter()
    warm_res = run_smc(1, log_prior, log_like, parts, num_mutations=5, device="cuda")
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0

    one = (evals > 0 and counts["b1"] == counts["chains"]["b1"] == evals
           and counts["b1r"] == counts["b2"] == counts["generic"] == counts["b3"] == 0)
    ok = one
    for label, out in (("cold", res), ("warm", warm_res)):
        k = int(out.num_stages)
        betas, accs = out.betas.double().cpu().numpy(), out.acceptance.double().cpu().numpy()
        ladder = (betas[k - 1] == 1.0 and bool(np.all(np.diff(betas[:k]) > 0))
                  and bool(np.isnan(betas[k:]).all()) and bool(np.isnan(accs[k:]).all()))
        accept = bool(((accs[:k] >= 0) & (accs[:k] <= 1)).all())
        finite = all(bool(torch.isfinite(v).all()) for v in out.particles.values()) and (
            math.isfinite(float(out.log_evidence)))
        log(f"smc {label}: {SMC_PARTICLES} particles, 5 mutations, N = 512, float32 [{CARD}]: "
            f"stages {k}, ladder {np.round(betas[:k], 6).tolist()}, acceptance "
            f"{np.round(accs[:k], 4).tolist()}, log evidence {float(out.log_evidence):.6f}, "
            f"ladder increasing to 1.0 and NaN-padded {ladder}, acceptance in [0, 1] {accept}, "
            f"finite {finite}")
        ok = ok and ladder and accept and finite
    stages = int(warm_res.num_stages)
    log(f"smc: wall cold {cold:.3f} s, warm {warm:.3f} s ({stages} stages, "
        f"{SMC_PARTICLES * stages * 5 / warm:.1f} particle-stage-mutations/s); cold run's "
        f"batched evaluations {evals}, launches {counts}, one chain-axis B1 per evaluation and "
        f"nothing else {one}")

    # Four particles' log-likelihood against the plain version on the CPU.
    z4 = torch.stack([v[:4] for v in res.particles.values()], dim=-1)
    cpu_like = smc_vi_model("cpu")[0]
    with torch.no_grad():
        card = torch.func.vmap(flat(log_like))(z4).cpu()
        want = torch.func.vmap(flat(cpu_like))(z4.cpu())
    err = float(((card - want).abs() / want.abs()).max())
    log(f"smc: 4 particles' log-likelihood on the card against the plain version on the CPU "
        f"(float32) rel {err:.3e} (5e-4)")
    ok = ok and err <= 5e-4

    # test_vi_smc.py:66-93's Gaussian target on the card.
    mu = torch.tensor([1.0, -2.0], device="cuda")
    sd = torch.tensor([0.5, 1.5], device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    gauss = run_smc(2, lambda p: -0.5 * torch.sum(torch.square(p["x"]) / 16.0),
                    lambda p: -0.5 * torch.sum(torch.square((p["x"] - mu) / sd)),
                    {"x": 4.0 * torch.randn((2048, 2), generator=g, device="cuda")},
                    device="cuda")
    MU, SD = mu.cpu().numpy(), sd.cpu().numpy()
    x = gauss.particles["x"].cpu().numpy()
    post_var = 1.0 / (1.0 / 16.0 + 1.0 / SD**2)
    post_mean = post_var * MU / SD**2
    var_sum = 16.0 + SD**2
    log_z = float(np.sum(-0.5 * (MU**2 / var_sum + np.log(var_sum / SD**2))))
    errs = (float(np.abs(x.mean(0) - post_mean).max()),
            float(np.abs(x.std(0) - np.sqrt(post_var)).max()),
            abs(float(gauss.log_evidence) - log_z))
    gauss_ok = max(errs) <= 0.15 and int(gauss.num_stages) < 50
    log(f"smc gaussian (2048 particles, float32): mean, sd and log evidence against the "
        f"analytic posterior {errs[0]:.4f}, {errs[1]:.4f}, {errs[2]:.4f} (limits 0.15), "
        f"stages {int(gauss.num_stages)} {'ok' if gauss_ok else 'FAIL'}")
    if not (ok and gauss_ok):
        raise AssertionError("the SMC phase failed")
    return counts["chains"]["b1"]


def carma21(a, b):
    """``benchmarks/model_family_bench.py:44-47``'s CARMA(2, 1): ``alpha =
    (a, 1.4)``, ``beta = (b, 0.1)``, complex roots at its ``a = 1.2``,
    ``b = 1.7``."""
    import torch

    from tinygp_tpu_torch.kernels import quasisep

    return quasisep.CARMA.init(alpha=torch.stack([a, torch.full_like(a, 1.4)]),
                               beta=torch.stack([b, torch.full_like(b, 0.1)]))


def carma_acvf_np(alpha, beta):
    """The CARMA autocovariance of Kelly et al. (2014, Eq. 4) as a function
    of the lag, from ``numpy.roots`` of the AR polynomial: the dense
    reference, independent of the state-space form."""
    from tinygp_tpu_torch.kernels.quasisep import carma_acvf

    roots = np.roots(np.append(1.0, np.asarray(alpha, np.float64)[::-1]))
    acf = carma_acvf(roots, np.asarray(alpha, np.float64), np.asarray(beta, np.float64)).numpy()

    def k(tau):
        tau = np.asarray(tau, np.float64)
        return np.real(np.tensordot(acf, np.exp(roots[:, None] * tau.reshape(1, -1)), 1)
                       ).reshape(tau.shape)

    return k


def plain_route_grad(build, params, y):
    """The gradient of ``build(*params).log_probability(y)`` in ``params``
    through the plain versions of B1r and B2 (autograd only for the
    operands' construction)."""
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik as cl

    params = [p.detach().clone().requires_grad_(True) for p in params]
    gp = build(*params)
    d, ps, qs, as_ = (x.contiguous() for x in gp.solver.ssm)
    r = (y - gp.loc).contiguous()
    with torch.no_grad():
        res = cl.plain_loglik_terms_res(d, ps, qs, as_, r)
        qbar, lbar = (torch.tensor(v, dtype=y.dtype, device=y.device) for v in (-0.5, -1.0))
        bars = cl.plain_loglik_bwd(ps, qs, as_, r, *res[2:], qbar, lbar)
    outs, cotangents = zip(*((x, g) for x, g in zip((d, ps, qs, as_, r), bars)
                             if x.requires_grad))
    return torch.autograd.grad(outs, params, cotangents)


def phase_carma():
    """Phase 21: CARMA(2, 1) of ``model_family_bench.py`` on ``bench.py``'s
    data (N = 1e5, ``diag=0.1``) in float32 and float64: the value (one B1)
    and the gradient in ``(a, b)`` (one B1r and one B2), each kernel
    against its plain version on the path's operands per stream (5e-4 in
    float32 against float64, 1e-8 in float64) and the float64 gradient
    against the plain route's (1e-8); in float64 at N = 2000 the value
    against a dense Cholesky of Kelly's autocovariance (1e-9), and at
    N = 5000 ``condition`` and ``predict`` against the dense posterior
    (1e-9 / 1e-8); a p = 3 process (Durand-Kerner roots) through the value
    at 1e5. Times: the constructor, the whole calls. Returns the launches:
    B1, B1r, B2 and B3's by (monoid, m, r)."""
    import torch

    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik as cl, cuda_scan

    (X5, y5), _ = bench_data()
    launches = {"b1": 0, "b1r": 0, "b2": 0, "b3": {}}
    ok = True
    for dtype in (torch.float32, torch.float64):
        label = str(dtype)[6:]
        X, y = (torch.as_tensor(v, dtype=dtype, device="cuda") for v in (X5, y5))
        a, b = (torch.tensor(v, dtype=dtype, device="cuda") for v in (1.2, 1.7))

        def build(a, b):
            return GaussianProcess(carma21(a, b), X, diag=0.1, assume_sorted=True)

        def value():
            with torch.no_grad():
                return build(a, b).log_probability(y)

        def grad():
            params = [p.clone().requires_grad_(True) for p in (a, b)]
            return torch.autograd.grad(build(*params).log_probability(y), params)

        reset_loglik_counts()
        lp = value()
        torch.cuda.synchronize()
        c_value = loglik_counts()
        reset_loglik_counts()
        g = grad()
        torch.cuda.synchronize()
        c_grad = loglik_counts()
        counts_ok = (c_value["b1"] == 1 and c_value["b1r"] == c_value["b2"] == 0
                     and c_grad["b1"] == 0 and c_grad["b1r"] == c_grad["b2"] == 1
                     and c_value["generic"] == c_grad["generic"] == 0)
        for k in ("b1", "b1r", "b2"):
            launches[k] += c_value[k] + c_grad[k]

        with torch.no_grad():
            gp = build(a, b)
            d, ps, qs, as_ = gp.solver.ssm
            ops = (d, ps, qs, as_, (y - gp.loc).contiguous())
            ops64 = tuple(x.double() for x in ops)
            qbar, lbar = (torch.tensor(v, dtype=dtype, device="cuda") for v in (-0.5, -1.0))
            res = cl.fused_loglik_res(*ops)
            bwd = (*ops[1:], *res[2:], qbar, lbar)
            errs = {
                "b1": max(e for e, _ in stream_errors(cl.fused_loglik_terms(*ops),
                                                      cl.plain_loglik_terms(*ops64))),
                "b1r": max(e for e, _ in stream_errors(res, cl.plain_loglik_terms_res(*ops64))),
                "b2": max(e for e, _ in stream_errors(
                    cl.fused_loglik_bwd(*bwd), cl.plain_loglik_bwd(*(x.double() for x in bwd)))),
            }
        limit = 5e-4 if dtype == torch.float32 else 1e-8
        grad_err = None
        if dtype == torch.float64:
            want = plain_route_grad(build, (a, b), y)
            grad_err = max(rel_err(float(u), float(w)) for u, w in zip(g, want))
        finite = math.isfinite(float(lp)) and all(math.isfinite(float(v)) for v in g)
        construct_ms = cuda_ms(lambda: carma21(a, b), reps=20, warmup=3)
        value_ms = cuda_ms(value, reps=20, warmup=3)
        grad_ms = cuda_ms(grad, reps=20, warmup=3)
        kernel_ms = [cuda_ms(lambda: cl.fused_loglik_terms(*ops), reps=20, warmup=3),
                     cuda_ms(lambda: cl.fused_loglik_res(*ops), reps=20, warmup=3),
                     cuda_ms(lambda: cl.fused_loglik_bwd(*bwd), reps=20, warmup=3)]
        n, itemsize = X.shape[0], X.element_size()
        bounds = [loglik_bound_ms(2, n, itemsize)[0], loglik_bound_ms(2, n, itemsize, True)[0],
                  bwd_bound_ms(2, n, itemsize)[0]]
        this_ok = (counts_ok and finite and max(errs.values()) <= limit
                   and (grad_err is None or grad_err <= 1e-8))
        log(f"carma CARMA(2, 1) alpha (1.2, 1.4) beta (1.7, 0.1) N=100000 {label} [{CARD}]: "
            f"log_probability {float(lp)!r}, gradient in (a, b) {[float(v) for v in g]}, finite "
            f"{finite}; launches value {c_value}, gradient {c_grad}; kernels against the plain "
            f"versions (float64) per stream: B1 {errs['b1']:.2e}, B1r {errs['b1r']:.2e}, B2 "
            f"{errs['b2']:.2e} (limit {limit:g})"
            + (f"; gradient against the plain route {grad_err:.2e} (1e-8)" if grad_err is not None
               else "")
            + f"; constructor {construct_ms:.4f} ms, value {value_ms:.4f} ms, gradient "
            f"{grad_ms:.4f} ms (events, constructor included); B1, B1r, B2 alone "
            f"{', '.join(f'{t:.4f}' for t in kernel_ms)} ms, bounds "
            f"{', '.join(f'{t:.4f}' for t in bounds)} ms {'ok' if this_ok else 'FAIL'}")
        ok = ok and this_ok

    # Float64 against dense references of Kelly's autocovariance.
    acvf = carma_acvf_np((1.2, 1.4), (1.7, 0.1))
    t, yt = X5[::50], y5[::50]
    K = acvf(np.abs(t[:, None] - t[None, :])) + 0.1 * np.eye(t.shape[0])
    L = np.linalg.cholesky(K)
    alpha = np.linalg.solve(L, yt)
    dense_lp = -0.5 * alpha @ alpha - np.log(np.diag(L)).sum() - 0.5 * t.shape[0] * math.log(
        2 * math.pi)
    a, b = (torch.tensor(v, dtype=torch.float64, device="cuda") for v in (1.2, 1.7))
    with torch.no_grad():
        lp = GaussianProcess(carma21(a, b), torch.as_tensor(t, device="cuda"), diag=0.1,
                             assume_sorted=True).log_probability(torch.as_tensor(yt, device="cuda"))
    dense_err = rel_err(float(lp), dense_lp)
    log(f"carma dense N=2000 float64: log_probability {float(lp)!r}, dense Cholesky of Kelly's "
        f"autocovariance {dense_lp!r}, rel {dense_err:.2e} (1e-9) "
        f"{'ok' if dense_err <= 1e-9 else 'FAIL'}")
    ok = ok and dense_err <= 1e-9

    t, yt = X5[::20], y5[::20]
    t_test = np.linspace(0.0, 10.0, 500)
    want = dense_posterior(t, yt, t_test, acvf, 0.1, math.sqrt(np.finfo(np.float64).eps))
    launch = cuda_scan._launch

    def recording_launch(monoid, m, r, reverse, inclusive, operands, out_rows, m2=None):
        key = (monoid, m, r)
        launches["b3"][key] = launches["b3"].get(key, 0) + 1
        return launch(monoid, m, r, reverse, inclusive, operands, out_rows, m2=m2)

    cuda_scan._launch = recording_launch
    try:
        gp = GaussianProcess(carma21(a, b), torch.as_tensor(t, device="cuda"), diag=0.1,
                             assume_sorted=True)
        log_prob, post = gp.condition(torch.as_tensor(yt, device="cuda"))
        mu = gp.predict(torch.as_tensor(yt, device="cuda"), torch.as_tensor(t_test, device="cuda"))
        got = (log_prob.item(), post.loc.cpu().numpy(), post.variance.cpu().numpy(),
               mu.cpu().numpy())
    finally:
        cuda_scan._launch = launch
    errs = [rel_err(got[0], want[0])] + [rel_max(u, w) for u, w in zip(got[1:], want[1:])]
    cond_ok = errs[0] <= 1e-9 and max(errs[1:]) <= 1e-8 and bool(launches["b3"])
    log(f"carma condition N=5000 float64: log prob {got[0]!r} (dense {want[0]!r}); against the "
        f"dense posterior: log prob rel {errs[0]:.2e}, mean {errs[1]:.2e}, variance "
        f"{errs[2]:.2e}, predict at 500 points {errs[3]:.2e} (limits 1e-9, 1e-8); B3 launches "
        f"{launches['b3']} {'ok' if cond_ok else 'FAIL'}")
    ok = ok and cond_ok

    # p = 3: the roots by Durand-Kerner, the value at 1e5 in float32.
    quads = ([1.1, 1.2, 0.5], [0.2], [1.0])
    args = [torch.tensor(q, dtype=torch.float32, device="cuda") for q in quads]
    X, y = (torch.as_tensor(v, dtype=torch.float32, device="cuda") for v in (X5, y5))
    kernel = quasisep.CARMA.from_quads(*args)
    reset_loglik_counts()
    with torch.no_grad():
        gp = GaussianProcess(kernel, X, diag=0.1, assume_sorted=True)
        lp = gp.log_probability(y)
        torch.cuda.synchronize()
        counts = loglik_counts()
        ops = tuple(x.contiguous() for x in gp.solver.ssm) + ((y - gp.loc).contiguous(),)
        err = max(e for e, _ in stream_errors(cl.fused_loglik_terms(*ops),
                                              cl.plain_loglik_terms(*(x.double() for x in ops))))
    launches["b1"] += counts["b1"]
    construct_ms = cuda_ms(lambda: quasisep.CARMA.from_quads(*args), reps=10, warmup=2)
    p3_ok = (math.isfinite(float(lp)) and err <= 5e-4 and counts["b1"] == 1
             and counts["b1r"] == counts["b2"] == counts["generic"] == 0)
    nan_case = quasisep.CARMA.from_quads(*(torch.tensor(q, device="cuda")
                                             for q in ([1.1, 1.2, 0.5], [0.9], [0.3])))
    log(f"carma p=3 from_quads{quads} N=100000 float32: m={ops[1].shape[0]}, roots "
        f"{kernel.arroots.cpu().numpy().round(6).tolist()}, log_probability {float(lp)!r}, "
        f"B1 against its plain version (float64) {err:.2e} (5e-4), launches {counts}, "
        f"constructor (64 Durand-Kerner steps) {construct_ms:.4f} ms (events) "
        f"{'ok' if p3_ok else 'FAIL'}; from_quads([1.1, 1.2, 0.5], [0.9], [0.3]) has a finite "
        f"observation model {bool(torch.isfinite(nan_case.obsmodel).all())} (its pair's "
        f"celerite term has a c < b d, NaN in the JAX package too)")
    ok = ok and p3_ok
    if not ok:
        raise AssertionError("the CARMA phase failed")
    return launches


# ---------------------------------------------------------------------------
# Gradients through conditioning (N8), the low-rank and Kalman solvers (L2).
# ---------------------------------------------------------------------------

class B3Watch:
    """Every B3 launch while active, by ``(monoid, m, m2, r)`` (with the
    first launch's direction, output and operands, for the records), the
    reverse launches by monoid, and the plain blocked scan's calls on a
    CUDA tensor (there must be none)."""

    def __init__(self):
        self.counts, self.first, self.reverse = {}, {}, {}
        self.plain_on_card = 0

    def snapshot(self):
        return dict(self.counts), dict(self.reverse)

    @contextlib.contextmanager
    def active(self):
        from tinygp_tpu_torch.solvers.quasisep import cuda_scan, scan

        launch, monoid_scan = cuda_scan._launch, scan.monoid_scan

        def recording(monoid, m, r, reverse, inclusive, operands, out_rows, m2=None):
            key = (monoid, m, m if m2 is None else m2, r)
            self.counts[key] = self.counts.get(key, 0) + 1
            self.first.setdefault(key, (reverse, inclusive, operands))
            self.reverse[monoid] = self.reverse.get(monoid, 0) + bool(reverse)
            return launch(monoid, m, r, reverse, inclusive, operands, out_rows, m2=m2)

        def counting(combine, identity, elems, **kwargs):
            self.plain_on_card += elems[0].is_cuda
            return monoid_scan(combine, identity, elems, **kwargs)

        cuda_scan._launch, scan.monoid_scan = recording, counting
        try:
            yield self
        finally:
            cuda_scan._launch, scan.monoid_scan = launch, monoid_scan


def count_diff(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def by_monoid(counts):
    out = {}
    for (monoid, *_), v in counts.items():
        out[monoid] = out.get(monoid, 0) + v
    return out


def b3_name(monoid, m, m2, r):
    """The kernels line's name of B3 at this shape (the templated source's
    records and the generic source's, as phases 8 and 16 name them)."""
    if m == m2 and m <= 4:
        return f"quasisep_scan_{monoid}_m{m}" + (f"_r{r}" if r > 1 else "")
    return (f"quasisep_generic_scan_{monoid}_m{m}" + (f"x{m2}" if monoid == "cpl" else "")
            + (f"_r{r}" if r > 1 else ""))


def b3_source(m, m2):
    """B3's CUDA source at these orders."""
    stem = ("quasisep_scan" if m == m2 and m <= 4
            else "quasisep_wide" if max(m, m2) > 16 else "quasisep_generic")
    return f"tinygp_tpu_torch/csrc/{stem}.cu"


def b3_records(watch, tag):
    """A JSON record for each shape the watch saw: B3 against its plain
    version in float64 on random operands of the first launch's shape (the
    posteriors' own operands are ill-conditioned for any parallel
    composition, as phase 16 found), its CUDA-event time on the path's
    operands, its plain version's, its bound; ``launches`` the watch's
    count."""
    import torch

    records = {}
    for key, count in sorted(watch.counts.items()):
        monoid, m, m2, r = key
        reverse, inclusive, operands = watch.first[key]
        n_op, dtype = operands[0].shape[-1], operands[0].dtype
        rtol = 1e-8 if dtype == torch.float64 else 5e-4
        checks = scan_operands(monoid, m, n_op, r, dtype, seed=m + m2 + r, m2=m2)
        got = scan_kernel(monoid, m, r, reverse, inclusive, checks, m2=m2)
        want = scan_plain(monoid, m, r, reverse, inclusive, [x.double() for x in checks], m2=m2)
        (rel, abs_err), = stream_errors([got], [want])
        ms = cuda_ms(lambda: scan_kernel(monoid, m, r, reverse, inclusive, operands, m2=m2),
                     reps=10, warmup=2)
        plain_ms = cuda_ms(lambda: scan_plain(monoid, m, r, reverse, inclusive, operands, m2=m2),
                           reps=1, warmup=1)
        bound, by = scan_bound_ms(monoid, m, r, n_op, operands[0].element_size(), m2=m2)
        name = b3_name(monoid, m, m2, r)
        ok = rel <= rtol and bool(torch.isfinite(got).all())
        log(
            f"{tag} B3 {name} N={n_op} {str(dtype)[6:]} ({count} launches; first "
            f"{'reverse' if reverse else 'forward'} {'inclusive' if inclusive else 'exclusive'}): "
            f"{ms:.4f} ms, bound {bound:.4f} ms ({by}), plain {plain_ms:.4f} ms (one call); "
            f"on random operands of this shape against the plain version in float64 rel "
            f"{rel:.2e} (limit {rtol:g}), abs {abs_err:.3e} {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            raise AssertionError(f"{tag}: B3 {name} disagrees with its plain version")
        records[name] = {
            "name": name,
            "route": "cuda",
            "source": b3_source(m, m2),
            "replaces": "tinygp_tpu/solvers/quasisep/pallas_scan.py:331",
            "launches": count,
            "max_abs_err": abs_err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,
        }
    return records


GRAD_THETA = (1.5, 2.5)


def predict_loss(th, X, y, X_test, w, var=True):
    """``sum(w * mu) + sum(var)`` of ``predict(y, X_test, return_var=True)``
    for ``amp * Matern32(scale)`` with ``th = (amp, scale)``, ``diag=0.1``,
    on ``th``'s device and in its dtype."""
    import torch

    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep

    X, y, X_test, w = (torch.as_tensor(a, dtype=th.dtype, device=th.device)
                       for a in (X, y, X_test, w))
    gp = GaussianProcess(th[0] * quasisep.Matern32(scale=th[1]), X, diag=0.1,
                         assume_sorted=True, device=th.device.type)
    mu, spread = gp.predict(y, X_test, return_var=True)
    return torch.sum(w * mu) + (torch.sum(spread) if var else 0.0)


def posterior_kernel(name, th):
    """The posterior models of phase 16 with an amplitude and a time scale
    to differentiate: Matern32 and Matern52 at (amp, scale) = (1.5, 2.5);
    the 2-term celerite with its rates divided by the scale, at (1, 1);
    phase 16's order-5 sum with its frequency divided and its scale
    multiplied by the scale, at (1, 1)."""
    from tinygp_tpu_torch.kernels import quasisep

    if name == "sum5":
        return th[0] * sum5_kernel((SUM5_PARAMS[0], SUM5_PARAMS[1] / th[1], SUM5_PARAMS[2],
                                    SUM5_PARAMS[3] * th[1]))
    if name == "matern32":
        return th[0] * quasisep.Matern32(scale=th[1])
    if name == "matern52":
        return th[0] * quasisep.Matern52(scale=th[1])
    return th[0] * (quasisep.Celerite(a=1.0, b=0.1, c=0.5 / th[1], d=1.0 / th[1])
                    + quasisep.Celerite(a=0.5, b=0.05, c=1.5 / th[1], d=3.0 / th[1]))


POSTERIOR_THETA = {"matern32": (1.5, 2.5), "matern52": (1.5, 2.5), "celerite2": (1.0, 1.0)}
ORDER20_THETA = (1.0, 1.0)  # the order-5 sum's posterior (order 20): amplitude, time scale


def posterior_log_prob(name, th, X, y, post_diag):
    """``condition(y, diag=post_diag)``'s process, its ``log_probability(y)``
    (order 4m: 8, 12, 16, 20)."""
    from tinygp_tpu_torch import GaussianProcess

    gp = GaussianProcess(posterior_kernel(name, th), X, diag=0.1, assume_sorted=True,
                         device=X.device.type)
    return gp.condition(y, diag=post_diag).gp.log_probability(y)


def dense_posterior_log_prob(name, th, X, y, post_diag):
    """The same in dense float64 algebra (``torch.linalg`` on the tensors'
    device): the posterior at the training points ``K - K (K + 0.1 I)^-1 K
    + post_diag I`` and mean ``K (K + 0.1 I)^-1 y``."""
    import torch

    K = posterior_kernel(name, th)(X, X)
    eye = torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
    L = torch.linalg.cholesky(K + 0.1 * eye)
    A = torch.linalg.solve_triangular(L, K, upper=False)
    loc = K @ torch.cholesky_solve(y[:, None], L)[:, 0]
    P = K - A.T @ A + post_diag * eye
    Lp = torch.linalg.cholesky(0.5 * (P + P.T))
    r = torch.linalg.solve_triangular(Lp, (y - loc)[:, None], upper=False)[:, 0]
    return (-0.5 * (r @ r) - torch.sum(torch.log(torch.diagonal(Lp)))
            - 0.5 * X.shape[0] * math.log(2 * math.pi))


def value_and_grad(fn, theta, dtype, device):
    import torch

    th = torch.tensor(theta, dtype=dtype, device=device, requires_grad=True)
    value = fn(th)
    (grad,) = torch.autograd.grad(value, th)
    return value.detach(), grad.detach()


def grad_err(got, want):
    """The largest entry's difference relative to the reference's largest."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300)


GRAD_CHECK_STEP = 1000  # the float32 gradient's held configuration: every 1000th point, N = 100
# The JAX package's float32 value and gradient of predict_loss at N = 1e5
# (jit(value_and_grad) under x64 on float32 inputs, from
# ``python tests/c7_reference.py 1``), and the gradient's limit against the
# card's float64: twice the JAX package's own distance from its float64
# gradient, 4.67e-3 of the largest entry.
C7_JAX_FLOAT32 = (-0.7856727155, (-0.02532959, 0.04539728))
C7_GRAD_LIMIT = 2 * 4.67e-3
POSTERIOR_CHECK_STEP = 100  # the float64 posteriors' held configuration: N = 1000


def phase_condition_gradient(tf32=False):
    """Gradients through conditioning on the card (N8). Held to limits
    (PERF.md section 2), each where the plain float32 or float64 arithmetic
    can meet it: the float32 held-out ``predict`` loss on every 1000th of
    ``bench.py``'s points (N = 100, 1000 new points; the CPU plain path's
    float32 gradient is about 4e-5 of its largest entry off float64 there)
    within 5e-4 of the CPU plain path's float32 gradient and of the card's
    float64 one; the float64 posterior processes' ``log_probability`` from
    ``condition(y, diag=0.1)`` on every 100th point (N = 1000) within 1e-7
    of the CPU plain path; central differences of the card's own value
    there (Matern32's posterior with ``diag=1.0``) within 1e-6.
    Driven and timed at size, with the errors printed and not held: the
    same loss at ``bench.py``'s N = 1e5 (its float32 gradient is an open
    fault, PERF.md section 7) and the posteriors at N = 5000 with
    ``diag=1e-3``, Matern32, Matern52 and the 2-term celerite (orders 8, 12,
    16). Every run's B3 launches are counted, forward and backward apart:
    each must launch ``cong`` and a reverse ``aff`` backward (and ``cpl`` on
    the posteriors) and no plain scan may run on a CUDA tensor. With
    ``tf32`` the float32 part reruns with TF32 on (``phase_tf32``), also
    held within 5e-4 of the same call with TF32 off. Returns the watch of
    the runs at size."""
    import torch

    (X5, y5), _ = bench_data()
    X_test = np.linspace(0, 10, 1000)
    w = np.random.default_rng(7).normal(size=1000)
    tag = "tf32: condition-gradient" if tf32 else "condition-gradient"
    watch, check = B3Watch(), B3Watch()
    failures = []

    def launched_ok(w_, fwd, total, posterior=False):
        bwd, bwd_rev = count_diff(total[0], fwd[0]), count_diff(total[1], fwd[1])
        kinds = by_monoid(bwd)
        ok = (kinds.get("cong", 0) > 0 and w_.plain_on_card == 0
              and (kinds.get("cpl", 0) > 0 if posterior else bwd_rev.get("aff", 0) > 0))
        return ok, (f"B3 launches forward {by_monoid(fwd[0])}, backward {kinds} (reverse "
                    f"{bwd_rev}), plain scans on the card {w_.plain_on_card}")

    def card_gradient(w_, fn, theta, dtype, posterior=False):
        with w_.active():
            before = w_.snapshot()
            th = torch.tensor(theta, dtype=dtype, device="cuda", requires_grad=True)
            value = fn(th)
            torch.cuda.synchronize()
            mid = w_.snapshot()
            (g,) = torch.autograd.grad(value, th)
            torch.cuda.synchronize()
            after = w_.snapshot()
        fwd = (count_diff(mid[0], before[0]), count_diff(mid[1], before[1]))
        total = (count_diff(after[0], before[0]), count_diff(after[1], before[1]))
        ok, text = launched_ok(w_, fwd, total, posterior)
        return value.detach(), g.detach(), ok, text

    # Float32, held: N = 100.
    Xa, ya = (a[::GRAD_CHECK_STEP].astype(np.float32) for a in (X5, y5))

    def loss_a(t):
        return predict_loss(t, Xa, ya, X_test, w)

    _, g32, ok_launch, text = card_gradient(check, loss_a, GRAD_THETA, torch.float32)
    with float32_defaults():
        g64 = value_and_grad(loss_a, GRAD_THETA, torch.float64, "cuda")[1]
        cpu32 = value_and_grad(loss_a, GRAD_THETA, torch.float32, "cpu")[1]
        off32 = value_and_grad(loss_a, GRAD_THETA, torch.float32, "cuda")[1] if tf32 else g32
    errs = {"the CPU plain path's float32": grad_err(g32, cpu32),
            "the card's float64": grad_err(g32, g64)}
    if tf32:
        errs["the card's float32 with TF32 off"] = grad_err(g32, off32)
    ok = ok_launch and bool(torch.isfinite(g32).all()) and max(errs.values()) <= 5e-4
    log(
        f"{tag} predict loss matern32 N={len(Xa)} float32 (every {GRAD_CHECK_STEP}th point), "
        f"1000 new points: gradient {[float(v) for v in g32]!r}; float64 (card) "
        f"{[float(v) for v in g64]!r}; against "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" of the largest entry (limit 5e-4 each); the CPU plain path's float32 off float64 "
        f"{grad_err(cpu32, g64):.3e}; {text} {'ok' if ok else 'FAIL'}"
    )
    if not ok:
        failures.append("float32 predict loss N=100")

    # Float32 at size: N = 1e5, launches, value and gradient held (C7).
    X32, y32 = X5.astype(np.float32), y5.astype(np.float32)

    def loss(t):
        return predict_loss(t, X32, y32, X_test, w)

    v32, g32, ok, text = card_gradient(watch, loss, GRAD_THETA, torch.float32)
    grad_ms = cuda_ms(lambda: value_and_grad(loss, GRAD_THETA, torch.float32, "cuda"), reps=5,
                      warmup=1)
    fwd_ms = cuda_ms(lambda: loss(torch.tensor(GRAD_THETA, device="cuda")), reps=5, warmup=1)
    with float32_defaults():
        g64 = value_and_grad(loss, GRAD_THETA, torch.float64, "cuda")[1]
        if tf32:
            off = value_and_grad(loss, GRAD_THETA, torch.float32, "cuda")[1]
            printed = f"the card's float32 with TF32 off {grad_err(g32, off):.3e}"
        else:
            mean = [value_and_grad(lambda t: predict_loss(t, X32, y32, X_test, w, var=False),
                                   GRAD_THETA, dtype, "cuda")[1]
                    for dtype in (torch.float32, torch.float64)]
            printed = f"the mean's term alone, the card's float32 off float64 {grad_err(*mean):.3e}"
    value_off = rel_err(float(v32), C7_JAX_FLOAT32[0])
    ok = (ok and bool(torch.isfinite(g32).all()) and grad_err(g32, g64) <= C7_GRAD_LIMIT
          and value_off <= 1e-5)
    log(
        f"{tag} predict loss matern32 N={len(X32)} float32, 1000 new points: value "
        f"{float(v32)!r}, against the JAX package's float32 {C7_JAX_FLOAT32[0]!r} rel "
        f"{value_off:.3e} (limit 1e-5); gradient {[float(v) for v in g32]!r} (the JAX "
        f"package's float32 {list(C7_JAX_FLOAT32[1])!r}); float64 (card, same inputs) "
        f"{[float(v) for v in g64]!r}, the card's float32 off it {grad_err(g32, g64):.3e} of "
        f"the largest entry (limit {C7_GRAD_LIMIT:.3e}, twice the JAX package's 4.67e-3); "
        f"{printed}; {text}; gradient call {grad_ms:.4f} ms, forward {fwd_ms:.4f} ms (events) "
        f"{'ok' if ok else 'FAIL'}"
    )
    if not ok:
        failures.append("float32 predict loss N=1e5")
    if tf32:
        if failures:
            raise AssertionError(f"{tag} failed: {failures}")
        return watch

    # Float64 posteriors, held: N = 1000, posterior diag=0.1, against the
    # CPU plain path.
    Xk, yk = X5[::POSTERIOR_CHECK_STEP].copy(), y5[::POSTERIOR_CHECK_STEP].copy()
    Xkc, ykc = (torch.as_tensor(a, device="cuda") for a in (Xk, yk))
    Xkh, ykh = (torch.as_tensor(a) for a in (Xk, yk))
    for name, theta in POSTERIOR_THETA.items():
        _, g, ok, text = card_gradient(
            check, lambda t: posterior_log_prob(name, t, Xkc, ykc, 0.1), theta, torch.float64,
            posterior=True)
        cpu = value_and_grad(lambda t: posterior_log_prob(name, t, Xkh, ykh, 0.1), theta,
                             torch.float64, "cpu")[1]
        dense = value_and_grad(lambda t: dense_posterior_log_prob(name, t, Xkc, ykc, 0.1), theta,
                               torch.float64, "cuda")[1]
        err = grad_err(g, cpu)
        ok = ok and err <= 1e-7 and bool(torch.isfinite(g).all())
        log(f"{tag} posterior {name} N={len(Xk)} float64 diag=0.1: gradient "
            f"{[float(v) for v in g]!r}, against the CPU plain path {err:.3e} of the largest "
            f"entry (limit 1e-7), against dense {grad_err(g, dense):.3e} (the CPU's "
            f"{grad_err(cpu, dense):.3e}); {text} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"posterior {name} N={len(Xk)}")

    # The order-20 posterior (phase 16's order-5 sum) at N = 1000, float64,
    # diag=0.1, its launches recorded with the runs at size: backward a
    # reverse congruence at m = 20 (the Riccati adjoint), a reverse affine
    # scan and the couplings. Held to 1e-7 of the CPU plain path, or, where
    # the CPU plain path is more than 1e-8 off a dense float64 gradient, to
    # ten times that distance (PERF.md section 2's rule for generic-order
    # posteriors).
    with watch.active():
        before = watch.snapshot()
        th = torch.tensor(ORDER20_THETA, dtype=torch.float64, device="cuda", requires_grad=True)
        value = posterior_log_prob("sum5", th, Xkc, ykc, 0.1)
        torch.cuda.synchronize()
        mid = watch.snapshot()
        (g,) = torch.autograd.grad(value, th)
        torch.cuda.synchronize()
        after = watch.snapshot()
    bwd, bwd_rev = count_diff(after[0], mid[0]), count_diff(after[1], mid[1])
    launch_ok = (bwd.get(("cong", 20, 20, 1), 0) > 0 and bwd_rev.get("cong", 0) > 0
                 and bwd_rev.get("aff", 0) > 0 and by_monoid(bwd).get("cpl", 0) > 0
                 and watch.plain_on_card == 0)
    cpu = value_and_grad(lambda t: posterior_log_prob("sum5", t, Xkh, ykh, 0.1), ORDER20_THETA,
                         torch.float64, "cpu")[1]
    dense = value_and_grad(lambda t: dense_posterior_log_prob("sum5", t, Xkc, ykc, 0.1),
                           ORDER20_THETA, torch.float64, "cuda")[1]
    err, cpu_dense = grad_err(g, cpu), grad_err(cpu, dense)
    limit = 1e-7 if cpu_dense <= 1e-8 else 10 * cpu_dense
    ok = launch_ok and err <= limit and bool(torch.isfinite(g).all())
    log(f"{tag} posterior sum5 (order 20) N={len(Xk)} float64 diag=0.1: gradient "
        f"{[float(v) for v in g]!r}, against the CPU plain path {err:.3e} of the largest entry "
        f"(limit {limit:.3e}: the CPU plain path against dense {cpu_dense:.3e}), the card "
        f"against dense {grad_err(g, dense):.3e}; B3 launches forward "
        f"{count_diff(mid[0], before[0])}, backward {bwd} (reverse {bwd_rev}), plain scans on "
        f"the card {watch.plain_on_card} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"posterior sum5 N={len(Xk)}")

    # Float64 posteriors at size: N = 5000, posterior diag=1e-3 (ill-
    # conditioned, ROADMAP N11), launches held, errors printed.
    Xs, ys = X5[::20].copy(), y5[::20].copy()
    Xc, yc = (torch.as_tensor(a, device="cuda") for a in (Xs, ys))
    Xh, yh = (torch.as_tensor(a) for a in (Xs, ys))
    for name, theta in POSTERIOR_THETA.items():
        value, g, ok, text = card_gradient(
            watch, lambda t: posterior_log_prob(name, t, Xc, yc, 1e-3), theta, torch.float64,
            posterior=True)
        cpu = value_and_grad(lambda t: posterior_log_prob(name, t, Xh, yh, 1e-3), theta,
                             torch.float64, "cpu")
        dense = value_and_grad(lambda t: dense_posterior_log_prob(name, t, Xc, yc, 1e-3), theta,
                               torch.float64, "cuda")
        ms = cuda_ms(lambda: value_and_grad(lambda t: posterior_log_prob(name, t, Xc, yc, 1e-3),
                                            theta, torch.float64, "cuda"), reps=3, warmup=1)
        fwd_ms = cuda_ms(lambda: posterior_log_prob(
            name, torch.tensor(theta, dtype=torch.float64, device="cuda"), Xc, yc, 1e-3),
            reps=3, warmup=1)
        ok = ok and bool(torch.isfinite(g).all())
        log(
            f"{tag} posterior {name} N={len(Xs)} float64 diag=1e-3 (launches held, errors "
            f"printed): log prob {value.item()!r} (CPU {cpu[0].item()!r}, dense "
            f"{dense[0].item()!r}); gradient {[float(v) for v in g]!r}, CPU plain "
            f"{[float(v) for v in cpu[1]]!r}, dense {[float(v) for v in dense[1]]!r}; card "
            f"against the CPU {grad_err(g, cpu[1]):.3e}, against dense "
            f"{grad_err(g, dense[1]):.3e}, the CPU against dense {grad_err(cpu[1], dense[1]):.3e} "
            f"of the largest entry; {text}; gradient call {ms:.4f} ms, forward {fwd_ms:.4f} ms "
            f"(events) {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            failures.append(f"posterior {name} N={len(Xs)}")

    # Central differences of the card's own value, where the value is
    # smooth enough for them: Matern32's posterior with diag=1.0 at N =
    # 1000, the five-point stencil at h = 1e-2 x (its floor on the CPU plain
    # path, printed beside it, is about 3e-8 there and 2.9e-6 at N = 5000).
    def fd_residual(X, y, g):
        def f(i, v):
            t = list(POSTERIOR_THETA["matern32"])
            t[i] = v
            with torch.no_grad():
                return posterior_log_prob("matern32", torch.tensor(t, dtype=torch.float64,
                                                                   device=X.device), X, y, 1.0).item()

        fd = []
        for i, x in enumerate(POSTERIOR_THETA["matern32"]):
            h = 1e-2 * max(1.0, abs(x))
            fd.append((-f(i, x + 2 * h) + 8 * f(i, x + h) - 8 * f(i, x - h) + f(i, x - 2 * h))
                      / (12 * h))
        return grad_err(g, torch.tensor(fd)), fd

    fns = {dev: (lambda t, X=X, y=y: posterior_log_prob("matern32", t, X, y, 1.0))
           for dev, X, y in (("cuda", Xkc, ykc), ("cpu", Xkh, ykh))}
    g_card = value_and_grad(fns["cuda"], POSTERIOR_THETA["matern32"], torch.float64, "cuda")[1]
    g_cpu = value_and_grad(fns["cpu"], POSTERIOR_THETA["matern32"], torch.float64, "cpu")[1]
    (fd_card, fd_c), (fd_cpu, _) = fd_residual(Xkc, ykc, g_card), fd_residual(Xkh, ykh, g_cpu)
    ok = fd_card <= 1e-6
    log(
        f"{tag} central differences matern32 posterior N={len(Xk)} float64 diag=1.0: card "
        f"gradient {[float(v) for v in g_card]!r} against its own value's five-point stencil "
        f"{fd_c!r}: {fd_card:.3e} of the largest entry (limit 1e-6; the CPU plain path's own "
        f"{fd_cpu:.3e}) {'ok' if ok else 'FAIL'}"
    )
    if not ok:
        failures.append("central differences")
    if failures:
        raise AssertionError(f"{tag} failed: {failures}")
    return watch


LOWRANK_N = (10_000, 20_000, 100_000)
LOWRANK_M = 512


def lowrank_data():
    """``benchmarks/lowrank_bench.py:33-44``'s draws, in its order:
    ``default_rng(42)``, at each N sorted X and y, float32."""
    rng = np.random.default_rng(42)
    out = {}
    for n in LOWRANK_N:
        X = np.sort(rng.uniform(0, 10, n)).astype(np.float32)
        out[n] = (X, rng.normal(size=n).astype(np.float32))
    return out


def lowrank_loss(th, X, y, Z, diag=0.1):
    from tinygp_tpu_torch import GaussianProcess, kernels
    from tinygp_tpu_torch.solvers import LowRankSolver

    gp = GaussianProcess(th[0] * kernels.Matern32(scale=th[1]), X, diag=diag,
                         solver=LowRankSolver, inducing_points=Z, device=X.device.type)
    return gp.log_probability(y)


def phase_lowrank(tf32=False):
    """The low-rank solver (L2) at ``benchmarks/lowrank_bench.py``'s
    settings: ``1.5 * Matern32(scale=2.5)`` (dense), ``diag=0.1``, M = 512,
    ``Z = X[::N // M][:M]``, N = 1e4, 2e4 and 1e5 in float32: the value and
    its gradient in (amp, scale), finite, against the CPU plain path in
    float64 at 1e4; CUDA-event times beside a ``torch.linalg.cholesky`` of
    the dense K at 1e4. With ``tf32`` (``phase_tf32``) each N's float32
    value and gradient must also be within 5e-4 of the same call with TF32
    off. Then the JAX tests' limits on the card:
    ``Z = X`` in float64 equals ``DirectSolver``; duplicated inducing points
    give a finite gradient; a NaN capacitance gives NaN and -inf, not an
    error; clustered inducing points in float32 (the bench's, N = 1e4) a
    finite value."""
    import torch

    from tinygp_tpu_torch import GaussianProcess, kernels
    from tinygp_tpu_torch.solvers import DirectSolver, LowRankSolver
    from tinygp_tpu_torch.solvers.lowrank import _cap_apply

    tag = "tf32: lowrank" if tf32 else "lowrank"
    failures = []
    for n, (Xn, yn) in lowrank_data().items():
        X, y = (torch.as_tensor(a, device="cuda") for a in (Xn, yn))
        Z = X[:: n // LOWRANK_M][:LOWRANK_M]
        value, grad = value_and_grad(lambda t: lowrank_loss(t, X, y, Z), (1.5, 2.5),
                                     torch.float32, "cuda")
        ok = bool(torch.isfinite(value)) and bool(torch.isfinite(grad).all())
        value_ms = cuda_ms(lambda: lowrank_loss(torch.tensor((1.5, 2.5), device="cuda"), X, y, Z),
                           reps=5, warmup=1)
        grad_ms = cuda_ms(lambda: value_and_grad(lambda t: lowrank_loss(t, X, y, Z), (1.5, 2.5),
                                                 torch.float32, "cuda"), reps=5, warmup=1)
        extra = ""
        if tf32:
            with float32_defaults():
                off = value_and_grad(lambda t: lowrank_loss(t, X, y, Z), (1.5, 2.5),
                                     torch.float32, "cuda")
            v_err, g_err = rel_err(value.item(), off[0].item()), grad_err(grad, off[1])
            ok = ok and v_err <= 5e-4 and g_err <= 5e-4
            extra = (f"; against the same call with TF32 off: value {v_err:.2e}, gradient "
                     f"{g_err:.2e} (limit 5e-4 each)")
        if n == LOWRANK_N[0] and not tf32:
            with float32_defaults():
                K = kernels.Matern32(scale=2.5)(X, X) * 1.5 + 0.1 * torch.eye(
                    n, device="cuda")
                chol_ms = cuda_ms(lambda: torch.linalg.cholesky(K), reps=5, warmup=1)
                del K
                X64, y64 = X.double(), y.double()
                card64 = value_and_grad(lambda t: lowrank_loss(t, X64, y64, X64[:: n // 512][:512]),
                                        (1.5, 2.5), torch.float64, "cuda")
                cpu64 = value_and_grad(
                    lambda t: lowrank_loss(t, X64.cpu(), y64.cpu(), X64.cpu()[:: n // 512][:512]),
                    (1.5, 2.5), torch.float64, "cpu")
            v_err, g_err = rel_err(card64[0].item(), cpu64[0].item()), grad_err(card64[1], cpu64[1])
            ok = ok and v_err <= 1e-8 and g_err <= 1e-6
            extra = (f"; float64 card against the CPU plain path: value {v_err:.2e} (limit 1e-8), "
                     f"gradient {g_err:.2e} (limit 1e-6); yardstick torch.linalg.cholesky of "
                     f"the dense K {chol_ms:.4f} ms")
        log(f"{tag} N={n} M={LOWRANK_M} float32: log prob {value.item()!r}, gradient "
            f"{[float(v) for v in grad]!r}, finite; value {value_ms:.4f} ms, value and "
            f"gradient {grad_ms:.4f} ms (events){extra} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"N={n}")

    # The JAX tests' limits (tests/test_solvers/test_lowrank.py:30, :197,
    # :215, :238) on the card.
    rng = np.random.default_rng(31)
    Xs = torch.as_tensor(np.sort(rng.uniform(0, 10, 150)), device="cuda")
    ys = torch.sin(Xs) + 0.1 * torch.as_tensor(rng.normal(size=150), device="cuda")
    kernel = 1.3 * kernels.ExpSquared(scale=1.5)
    lr = GaussianProcess(kernel, Xs, diag=0.1, solver=LowRankSolver, inducing_points=Xs)
    dense = GaussianProcess(kernel, Xs, diag=0.1, solver=DirectSolver)
    exact = rel_err(lr.log_probability(ys).item(), dense.log_probability(ys).item())
    Zd = torch.cat([Xs[::10], Xs[::10]])
    gdup = value_and_grad(
        lambda t: GaussianProcess(t[0] * kernels.ExpSquared(scale=t[1]), Xs, diag=0.1,
                                  solver=LowRankSolver, inducing_points=Zd).log_probability(ys),
        (1.3, 1.5), torch.float64, "cuda")[1]
    S = torch.full((4, 4), torch.nan, device="cuda", requires_grad=True)
    out = _cap_apply(S, torch.ones(4, 1, device="cuda"), -1)
    (gnan,) = torch.autograd.grad(out.sum(), S)
    lr.solver.S = torch.full_like(lr.solver.S, torch.nan)
    poisoned = lr.log_probability(ys).item()
    Xn, yn = lowrank_data()[LOWRANK_N[0]]
    Xc, yc = (torch.as_tensor(a, device="cuda") for a in (Xn, yn))
    clustered = lowrank_loss(torch.tensor((1.5, 2.5), device="cuda"), Xc, yc,
                             Xc[:: len(Xn) // LOWRANK_M][:LOWRANK_M]).item()
    ok = (exact <= 5e-7 and bool(torch.isfinite(gdup).all()) and bool(torch.isnan(out).all())
          and bool(torch.isnan(gnan).all()) and poisoned == -math.inf and math.isfinite(clustered))
    log(f"{tag} checks: Z = X against DirectSolver (float64, N=150) rel {exact:.2e} (limit "
        f"5e-7, the JAX test's); duplicated inducing points gradient {[float(v) for v in gdup]!r}; NaN "
        f"capacitance: output NaN {bool(torch.isnan(out).all())}, gradient NaN "
        f"{bool(torch.isnan(gnan).all())}, log probability {poisoned!r}; clustered inducing "
        f"points N={len(Xn)} float32 log prob {clustered!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("checks")
    if failures:
        raise AssertionError(f"{tag} failed: {failures}")


KALMAN_KERNELS = {
    "m32": lambda q: q.Matern32(scale=1.5),
    "sho": lambda q: q.SHO(omega=1.2, quality=3.0),
    "exp": lambda q: q.Exp(scale=0.8, sigma=1.3),
    "sum": lambda q: q.Exp(scale=1.5) + q.Matern32(scale=2.0),
}


def phase_kalman():
    """The Kalman oracle (L2): ``tests/test_solvers/test_kalman.py``'s four
    kernels, ``diag=0.2``, float64 on ``bench.py``'s data cut to N = 5000
    (every 20th point) and 1e4 (the first 1e4): ``KalmanSolver``'s
    ``log_probability`` against ``QuasisepSolver``'s (B1) on the card
    within 5e-7 relative; the host loop's time (host clock, synchronized).
    Returns the B1 launches."""
    import torch

    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep
    from tinygp_tpu_torch.solvers import KalmanSolver
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    (X5, y5), _ = bench_data()
    cuts = {5000: (X5[::20], y5[::20]), 10_000: (X5[:10_000], y5[:10_000])}
    failures, b1 = [], 0
    for n, (Xn, yn) in cuts.items():
        X, y = (torch.as_tensor(np.ascontiguousarray(a), device="cuda") for a in (Xn, yn))
        for name, build in KALMAN_KERNELS.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gp_k = GaussianProcess(build(quasisep), X, diag=0.2, solver=KalmanSolver)
            lp_k = gp_k.log_probability(y).item()
            kalman_s = time.perf_counter() - t0
            before = cuda_loglik.LAUNCHES
            lp_q = GaussianProcess(build(quasisep), X, diag=0.2).log_probability(y).item()
            b1 += cuda_loglik.LAUNCHES - before
            err = rel_err(lp_k, lp_q)
            ok = err <= 5e-7
            log(f"kalman {name} N={n} float64: KalmanSolver {lp_k!r}, QuasisepSolver (B1) "
                f"{lp_q!r}, rel {err:.2e} (limit 5e-7); the oracle's host loop {kalman_s:.3f} s "
                f"(host clock, constructor and filter) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{name} N={n}")
    if failures:
        raise AssertionError(f"kalman failed: {failures}")
    return b1


# ---------------------------------------------------------------------------
# The parallel subpackage (phase 25).
# ---------------------------------------------------------------------------

# The sharded samplers' runs: phase 18's model and width with 25 warmup
# steps and 25 samples, trees of depth 4 at most (the comparison with
# run_mcmc holds at any depth; at depth 6 each of the two runs took about a
# minute on an NVIDIA H100 80GB HBM3 at 700.00 W), and a 64-chain run that
# the two-rank group repeats.
PARALLEL_NUTS = dict(num_chains=1024, num_warmup=15, num_samples=15, max_tree_depth=4,
                     jitter_init=0.1)
PARALLEL_NUTS_64 = dict(PARALLEL_NUTS, num_chains=64, num_warmup=5, num_samples=5)
CHOLESKY_TP_N, CHOLESKY_TP_BLOCK = 8192, 256


def cholesky_tp_matrix(dtype):
    """``tests/test_parallel/test_dense_tp.py``'s SPD matrix at n = 8192,
    ``A A^T + I`` with ``A`` standard normal over sqrt(n), made in float64
    on the card from a seeded generator and cast to ``dtype``."""
    import torch

    n = CHOLESKY_TP_N
    g = torch.Generator(device="cuda").manual_seed(7)
    A = torch.randn(n, n, generator=g, dtype=torch.float64, device="cuda") / math.sqrt(n)
    return (A @ A.T + torch.eye(n, dtype=torch.float64, device="cuda")).to(dtype)


def parallel_shared(world):
    """What the one-rank group and each rank of the two-rank gloo group run
    alike: ``sharded_loglik`` of ``bench.py``'s Matern32 at N = 1e5 in
    float64 with its gradient in (amp, scale), ``sharded_loglik_chains`` on
    a (1, world) mesh (two chains), ``cholesky_tp`` at n = 8192, float32,
    ``block=256``, and 64-chain ``run_mcmc_sharded``. Returns this rank's
    outputs on the host and the host-clock seconds of the first three."""
    import torch

    from tinygp_tpu_torch import parallel
    from tinygp_tpu_torch.kernels import quasisep
    from tinygp_tpu_torch.parallel.scan import sharded_loglik, sharded_loglik_chains

    (X5, y5), _ = bench_data()
    X, y = (torch.as_tensor(a, device="cuda") for a in (X5, y5))
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        out[name + "_s"] = time.perf_counter() - t0
        return value

    data = parallel.make_mesh(axis_names=("data",))

    def loglik():
        th = torch.tensor(GRAD_THETA, dtype=torch.float64, device="cuda", requires_grad=True)
        value = sharded_loglik(th[0] * quasisep.Matern32(scale=th[1]), X, y, diag=0.1, mesh=data)
        return value.detach().cpu(), torch.autograd.grad(value, th)[0].cpu()

    out["loglik"] = timed("loglik", loglik)
    grid = parallel.make_mesh(axis_names=("chains", "data"), axis_sizes=(1, world))
    scales = torch.tensor([2.5, 1.5], dtype=torch.float64, device="cuda")
    out["chains"] = timed("chains", lambda: sharded_loglik_chains(
        quasisep.Matern32(scale=scales), X, torch.stack([y, -y]), diag=0.1, mesh=grid).cpu())
    K = cholesky_tp_matrix(torch.float32)
    tp = parallel.make_mesh(axis_names=("tp",))
    parallel.cholesky_tp(K, mesh=tp, block=CHOLESKY_TP_BLOCK)  # warm
    out["cholesky"] = timed("cholesky", lambda: parallel.cholesky_tp(
        K, mesh=tp, block=CHOLESKY_TP_BLOCK).cpu())
    log_prob, _, init, _ = nuts_model("cuda")
    samples, info = parallel.run_mcmc_sharded(0, log_prob, init, mesh=parallel.make_mesh(),
                                              **PARALLEL_NUTS_64)
    out["mcmc64"] = ({k: v.cpu() for k, v in samples.items()}, info["accept_prob"].cpu(),
                     info["num_steps"].cpu())
    return out


def parallel_rank_main(rank, port, out_dir):
    """One rank of phase 25's two-rank gloo group, on the same card as the
    other: :func:`parallel_shared`, saved to ``out_dir/rank{rank}.pt``."""
    import os

    import torch
    import torch.distributed as dist

    from tinygp_tpu_torch import parallel

    parallel.initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu")
    try:
        out = parallel_shared(world=2)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def phase_parallel():
    """Phase 25: the ``parallel`` subpackage (L4) on the card. A one-rank
    NCCL group and ``make_mesh()``: ``run_mcmc_sharded`` at phase 18's model
    and width (1024 chains, N = 512, float32, 25 warmup steps and 25
    samples), bit for bit ``run_mcmc`` with the same seed and settings
    (``warmup_depth_cap=None``), one chain-axis B1r and one B2 launch per
    evaluation; ``run_smc_sharded`` at phase 20's, bit for bit ``run_smc``,
    one chain-axis B1 per batched evaluation; the sharded checkpoint's round
    trip of the MCMC result, bit for bit; ``sharded_loglik`` at ``bench.py``'s
    N = 1e5 in float64 against ``log_probability`` (1e-9 of the value, 1e-6
    of the gradient's largest entry); ``cholesky_tp`` at n = 8192 in float32
    against the float64 factor (5e-4 of its largest entry). Then a
    two-rank gloo group of two processes on the same card repeats
    ``parallel_shared``: each output within those limits of the one-rank
    result, the 64-chain samples bit for bit. Returns the one-rank runs'
    chain-axis launches of B1r, B2 and B1."""
    import importlib
    import os
    import shutil

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from tinygp_tpu_torch import GaussianProcess, parallel
    from tinygp_tpu_torch.kernels import quasisep
    from tinygp_tpu_torch.parallel.mesh import free_port
    from tinygp_tpu_torch.samplers import run_mcmc, run_smc
    from tinygp_tpu_torch.utils.checkpoint import load_pytree_sharded, save_pytree_sharded

    hmc_mod = importlib.import_module("tinygp_tpu_torch.samplers.hmc")
    smc_mod = importlib.import_module("tinygp_tpu_torch.samplers.smc")
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), RANK="0",
                      WORLD_SIZE="1")
    rank, world = parallel.initialize_distributed()
    log(f"parallel: one-rank group, backend {dist.get_backend()}, rank {rank} of {world}")
    failures = []
    try:
        mesh = parallel.make_mesh()
        log_prob, _, init, _ = nuts_model("cuda")
        reset_sampler_counts(hmc_mod)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples, info = parallel.run_mcmc_sharded(0, log_prob, init, mesh=mesh, **PARALLEL_NUTS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = sampler_counts(hmc_mod)
        one = one_launch_per_evaluation(counts)
        t0 = time.perf_counter()
        ref, ref_info = run_mcmc(0, log_prob, init, warmup_depth_cap=None,
                                 steps_per_dispatch=None, device="cuda", **PARALLEL_NUTS)
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t0
        same = (all(torch.equal(samples[k], ref[k]) for k in ref)
                and torch.equal(info["accept_prob"], ref_info.accept_prob)
                and torch.equal(info["num_steps"], ref_info.num_steps))
        total = PARALLEL_NUTS["num_chains"] * PARALLEL_NUTS["num_samples"]
        log(f"parallel run_mcmc_sharded nuts: {PARALLEL_NUTS}, one rank, {CARD}: wall "
            f"{wall:.3f} s (warmup included), {total / wall:.1f} samples/s; run_mcmc with the "
            f"same seed {ref_wall:.3f} s; equal bit for bit {same}; batched evaluations "
            f"{counts['evaluations']}, launches {counts}, one chain-axis B1r and B2 launch per "
            f"evaluation {one}")
        if not (same and one):
            failures.append("run_mcmc_sharded")

        log_like, log_prior, _, smc_init, _, _ = smc_vi_model("cuda")
        rng = np.random.default_rng(0)
        parts = {k: v + torch.as_tensor(rng.normal(size=SMC_PARTICLES), dtype=torch.float32,
                                        device="cuda") for k, v in smc_init.items()}
        reset_loglik_counts()
        smc_mod.EVALUATIONS = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = parallel.run_smc_sharded(0, log_prior, log_like, parts, mesh=mesh, num_mutations=5)
        torch.cuda.synchronize()
        smc_wall = time.perf_counter() - t0
        smc_counts, evals = loglik_counts(), smc_mod.EVALUATIONS
        smc_one = (evals > 0 and smc_counts["b1"] == smc_counts["chains"]["b1"] == evals
                   and smc_counts["b1r"] == smc_counts["b2"] == smc_counts["b3"] == 0)
        want = run_smc(0, log_prior, log_like, parts, num_mutations=5, device="cuda")
        smc_same = (all(torch.equal(res["particles"][k], want.particles[k]) for k in parts)
                    and torch.equal(res["log_evidence"], want.log_evidence)
                    and all(torch.equal(torch.nan_to_num(res[k], nan=-1.0),
                                        torch.nan_to_num(getattr(want, k), nan=-1.0))
                            for k in ("betas", "acceptance"))
                    and int(res["num_stages"]) == int(want.num_stages))
        log(f"parallel run_smc_sharded: {SMC_PARTICLES} particles, N = 512, float32, one rank, "
            f"{CARD}: wall {smc_wall:.3f} s, stages {int(res['num_stages'])}, log evidence "
            f"{float(res['log_evidence']):.6f}; run_smc with the same seed equal bit for bit "
            f"{smc_same}; batched evaluations {evals}, launches {smc_counts}, one chain-axis B1 "
            f"per evaluation {smc_one}")
        if not (smc_same and smc_one):
            failures.append("run_smc_sharded")

        # The sharded checkpoint of the MCMC result: chain-sharded leaves
        # and a replicated one.
        def tree_of(s, a):
            return {"samples": {k: DTensor.from_local(v, mesh, [Shard(1)], run_check=False)
                                for k, v in s.items()},
                    "accept_prob": DTensor.from_local(a, mesh, [Shard(1)], run_check=False),
                    "step": torch.tensor(PARALLEL_NUTS["num_samples"])}

        path = os.path.join("build", "chip_smoke", "sharded")
        save_pytree_sharded(path, tree_of(samples, info["accept_prob"]))
        back = load_pytree_sharded(path, tree_of({k: torch.zeros_like(v) for k, v in
                                                  samples.items()},
                                                 torch.zeros_like(info["accept_prob"])))
        ckpt = (all(torch.equal(back["samples"][k].to_local(), samples[k]) for k in samples)
                and torch.equal(back["accept_prob"].to_local(), info["accept_prob"])
                and int(back["step"]) == PARALLEL_NUTS["num_samples"])
        log(f"parallel sharded checkpoint of the MCMC result: {path}.proc0.npz, round trip "
            f"equal bit for bit {ckpt}")
        if not ckpt:
            failures.append("checkpoint")

        one_rank = parallel_shared(world=1)
        (X5, y5), _ = bench_data()
        X, y = (torch.as_tensor(a, device="cuda") for a in (X5, y5))
        th = torch.tensor(GRAD_THETA, dtype=torch.float64, device="cuda", requires_grad=True)
        lp = GaussianProcess(th[0] * quasisep.Matern32(scale=th[1]), X, diag=0.1,
                             assume_sorted=True).log_probability(y)
        (g,) = torch.autograd.grad(lp, th)
        lp = lp.detach()
        value, grad = one_rank["loglik"]
        errs = (rel_err(float(value), float(lp)), grad_err(grad, g))
        log(f"parallel sharded_loglik matern32 N=1e5 float64, one rank, {CARD}: value "
            f"{float(value)!r} against log_probability {float(lp)!r} rel {errs[0]:.3e} (1e-9), "
            f"gradient {grad.tolist()} against {g.tolist()} {errs[1]:.3e} of the largest entry "
            f"(1e-6); value and gradient {one_rank['loglik_s']:.3f} s (host clock)")
        if errs[0] > 1e-9 or errs[1] > 1e-6:
            failures.append("sharded_loglik")
        L64 = torch.linalg.cholesky(cholesky_tp_matrix(torch.float64)).cpu()
        chol_err = grad_err(one_rank["cholesky"], L64)
        K32 = cholesky_tp_matrix(torch.float32)
        library_ms = cuda_ms(lambda: torch.linalg.cholesky(K32), reps=5, warmup=1)
        log(f"parallel cholesky_tp n={CHOLESKY_TP_N} block={CHOLESKY_TP_BLOCK} float32, one "
            f"rank, {CARD}: against the float64 factor {chol_err:.3e} of its largest entry "
            f"(5e-4); {1e3 * one_rank['cholesky_s']:.3f} ms (host clock), "
            f"torch.linalg.cholesky {library_ms:.3f} ms (events)")
        if chol_err > 5e-4:
            failures.append("cholesky_tp")
    finally:
        dist.destroy_process_group()

    # Two gloo ranks on the same card.
    out_dir = os.path.join("build", "chip_smoke", "gloo")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                               str(r), str(port), out_dir], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    gloo_s = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        raise AssertionError("the two-rank gloo group failed:\n" + "\n".join(logs))
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    lp_errs = [max(rel_err(float(r["loglik"][0]), float(one_rank["loglik"][0])),
                   grad_err(r["loglik"][1], one_rank["loglik"][1])) for r in ranks]
    chain_errs = [grad_err(r["chains"], one_rank["chains"]) for r in ranks]
    L2 = torch.cat([r["cholesky"] for r in ranks], dim=1)
    chol2 = grad_err(L2, L64)
    mcmc_same = all(
        torch.equal(torch.cat([r["mcmc64"][0][k] for r in ranks], dim=1), one_rank["mcmc64"][0][k])
        for k in one_rank["mcmc64"][0]) and all(
        torch.equal(torch.cat([r["mcmc64"][i] for r in ranks], dim=1), one_rank["mcmc64"][i])
        for i in (1, 2))
    gloo_ok = (max(lp_errs) <= 1e-6 and max(chain_errs) <= 1e-9 and chol2 <= 5e-4
               and mcmc_same)
    log(f"parallel two-rank gloo group on one card, {CARD} ({gloo_s:.1f} s with the processes' "
        f"start): sharded_loglik value and gradient against one rank {max(lp_errs):.3e} (1e-6), "
        f"sharded_loglik_chains on (1, 2) {max(chain_errs):.3e} (1e-9), cholesky_tp's blocks "
        f"against the float64 factor {chol2:.3e} (5e-4), against one rank "
        f"{grad_err(L2, one_rank['cholesky']):.3e}; 64-chain run_mcmc_sharded equal to one "
        f"rank's bit for bit {mcmc_same}; times per rank (host clock) loglik "
        f"{[round(r['loglik_s'], 3) for r in ranks]} s, cholesky_tp "
        f"{[round(1e3 * r['cholesky_s'], 3) for r in ranks]} ms {'ok' if gloo_ok else 'FAIL'}")
    if not gloo_ok:
        failures.append("two-rank gloo group")
    if failures:
        raise AssertionError(f"the parallel phase failed: {failures}")
    return {"b1r": counts["b1r"], "b2": counts["b2"], "b1": smc_counts["chains"]["b1"]}


def tf32_mutant_check():
    """The TF32 reruns must be able to fail: with the backward pins removed
    in this process only (``helpers.pin_backward``'s hook a no-op, the
    scan and low-rank ``Function`` s' ``full_float32`` a null context), the
    float32 gradient phase and the low-rank phase rerun with TF32 on. The
    low-rank phase must fail. The gradient phase's float32 conditioning at
    new points runs in float64 (C7), which TF32 does not reach, so it
    passes and is printed. Returns whether the low-rank phase failed."""
    import torch

    from tinygp_tpu_torch import helpers
    from tinygp_tpu_torch.solvers import lowrank
    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    saved = helpers._pin_rest_of_backward, cuda_scan.full_float32, lowrank.full_float32
    helpers._pin_rest_of_backward = lambda grads: None
    cuda_scan.full_float32 = lowrank.full_float32 = contextlib.nullcontext
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    caught = []
    try:
        for phase in (phase_condition_gradient, phase_lowrank):
            try:
                phase(tf32=True)
                log(f"tf32 mutant: {phase.__name__} passed with the backward pins removed")
            except AssertionError as err:
                caught.append(phase)
                log(f"tf32 mutant: {phase.__name__} failed with the backward pins removed ({err})")
    finally:
        helpers._pin_rest_of_backward, cuda_scan.full_float32, lowrank.full_float32 = saved
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    return phase_lowrank in caught


def _timed(phase, start):
    """``phase``, logging its host-clock seconds and the script's so far."""
    import functools

    @functools.wraps(phase)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return phase(*args, **kwargs)
        finally:
            now = time.perf_counter()
            log(f"time {phase.__name__}: {now - t0:.1f} s (since the build {now - start:.1f} s)")

    return run


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from tinygp_tpu_torch.ops import gram
    except ModuleNotFoundError as err:
        print(f"chip_smoke: {err}; run this script from the root of the repository, "
              "beside the tinygp_tpu_torch package", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return 0
    phase_build()
    phase_dense_precision()
    start = time.perf_counter()
    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = _timed(fn, start)
    if sys.argv[1:] == ["--dense-times"]:
        dense_times()
        return 0
    if sys.argv[1:] == ["--riccati-panel-times"]:
        riccati_panel_times()
        return 0
    if sys.argv[1:] == ["--b2-times"]:
        b2_times()
        return 0
    if sys.argv[1:] == ["--b1-times"]:
        b1_times()
        return 0
    if sys.argv[1:] == ["--b1-times", "generic"]:
        generic_loglik_times()
        return 0
    if sys.argv[1:] == ["--b3-times"]:
        b3_times()
        return 0
    if sys.argv[1:] == ["--b3-times", "generic"]:
        b3_generic_times()
        return 0
    if sys.argv[1:] == ["--gram-times"]:
        gram_times()
        return 0
    if sys.argv[1:] == ["--c6"]:
        return 0 if c6_check(False) & c6_check(True) else 1
    if sys.argv[1:] == ["--sampler"]:
        records = phase_chain_kernels()
        sampler_launches = phase_sampler(NUTS_RUN)
        advi_launches = phase_advi(1000)
        records["b1"]["launches"] = phase_smc()
        for kind in ("b1r", "b2"):
            records[kind]["launches"] = sampler_launches[kind] + advi_launches[kind]
        log(json.dumps({"kernels": list(records.values())}))
        return 0
    if sys.argv[1:] == ["--parallel"]:
        phase_parallel()
        return 0
    if sys.argv[1:] == ["--tf32-mutant"]:
        return 0 if tf32_mutant_check() else 1
    if sys.argv[1:] == ["--grad"]:
        watch = phase_condition_gradient()
        phase_lowrank()
        phase_kalman()
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            phase_condition_gradient(tf32=True)
            phase_lowrank(tf32=True)
        finally:
            torch.set_float32_matmul_precision("highest")
            torch.backends.cuda.matmul.allow_tf32 = False
        records = b3_records(watch, "condition-gradient")
        log(json.dumps({"kernels": list(records.values())}))
        return 0
    phase_b1_launches()
    phase_b3_launches()
    phase_b2_launches()
    phase_kernel_vs_plain()
    phase_dense_check()
    phase_dense_gradient()
    record = phase_main_path()
    grad_records = phase_gradient_path()
    trainer_counts = phase_trainer()
    grad_records["res"]["launches"] += trainer_counts[1]
    grad_records["bwd"]["launches"] += trainer_counts[2]
    phase_scan_vs_plain()
    phase_example_condition()
    scan_records = phase_condition_path()
    measured = phase_dense_kernels()
    panel_f64_times()
    launches = dict.fromkeys(DENSE_COUNTS + DENSE_EXTRA_COUNTS, 0)
    gram.LAUNCHES["gram"] = 0
    for phase in (phase_dense_loglik, phase_dense_path_gradient, phase_dense_condition,
                  phase_dense_ill_conditioned):
        for k, v in phase().items():
            launches[k] += v
    missing = [k for k in ("panel", "syrk_inplace", "syrk_inplace_extras", "split", "panel_f64")
               if not launches[k]]
    if missing or launches["syrk"] or gram.LAUNCHES["gram"]:
        raise AssertionError(f"dense main path launches wrong: {launches}, B7 "
                             f"{gram.LAUNCHES['gram']}")
    log(f"dense main path launches: {launches}, B7 {gram.LAUNCHES['gram']} (B6 lies on no entry "
        f"point's path; its launches in the kernels line are those at dense_micro.py's shapes; "
        f"the strip build does not route through B7)")
    phase_tf32()
    gram_record = phase_gram()
    generic_records = phase_orders_path()
    chain_records = phase_chain_kernels()
    sampler_launches = phase_sampler()
    advi_launches = phase_advi()
    chain_records["b1"]["launches"] = phase_smc()
    for kind in ("b1r", "b2"):
        chain_records[kind]["launches"] = sampler_launches[kind] + advi_launches[kind]
    carma_launches = phase_carma()
    grad_watch = phase_condition_gradient()
    phase_lowrank()
    kalman_b1 = phase_kalman()
    parallel_launches = phase_parallel()
    for kind in ("b1", "b1r", "b2"):
        chain_records[kind]["launches"] += parallel_launches[kind]
    record["launches"] += carma_launches["b1"]
    grad_records["res"]["launches"] += carma_launches["b1r"]
    grad_records["bwd"]["launches"] += carma_launches["b2"]
    by_name = {r["name"]: r for r in scan_records}
    for (monoid, m, r), count in carma_launches["b3"].items():
        # CARMA conditions in float64, as the float32 conditioning path
        # does through its float64 twin (C7, C8).
        name = f"quasisep_scan_{monoid}_m{m}" + (f"_r{r}" if r > 1 else "") + "_f64"
        if name not in by_name:
            raise AssertionError(f"CARMA's conditioning launched B3 {name}, which the "
                                 f"conditioning path's records do not hold")
        by_name[name]["launches"] += count
    records = [record, grad_records["res"], grad_records["bwd"], *scan_records]
    records += dense_records(measured, launches)
    records.append(gram_record)
    records += generic_records
    records += list(chain_records.values())
    # The gradient phase's B3 launches, forward and reverse: added to the
    # records of shapes that earlier phases launched, a record of their own
    # for the rest.
    by_name = {r["name"]: r for r in records}
    added = {}
    for name, rec in b3_records(grad_watch, "condition-gradient").items():
        if name in by_name:
            by_name[name]["launches"] += rec["launches"]
        else:
            records.append(rec)
        added[name] = rec["launches"]
    log(f"condition-gradient B3 launches added to the kernels line: {added}; kalman's "
        f"comparison B1 launches {kalman_b1} (not on a path)")
    log(json.dumps({"kernels": records}))
    log(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
