"""Drive the PyTorch port on one CUDA card and check it end to end.

Run from the root of the repository, on a machine with one NVIDIA card and
``nvcc``::

    python3 chip_smoke.py

Phases, each printing its numbers on lines of its own:

1. the card's name and power limit; the build of every CUDA kernel, and
   ``nvcc -Xptxas -v``'s registers, shared memory and spills of each
   kernel of ``csrc/dense_tc.cu`` (with its GEMM's tiles, stages and
   dynamic shared memory), ``dense_syrk.cu`` and the B1-B2 sources
   ``quasisep_loglik_bwd.cu`` and ``quasisep_loglik_generic.cu``;
2. each kernel against its plain PyTorch version on random operands
   (m = 1..4, and 5, 8 and 16 through the generic-order source, at
   N = 17,161 in float64 and float32; m = 2 at N = 1e6): B1 (the
   log-likelihood), B1r (with the residuals a gradient needs) and B2 (the
   backward, on B1r's residuals, with random scalar cotangents; a second
   launch equal bit for bit);
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
   engine at m = 5, 6, 8, 12 and 16 (every monoid, both directions and
   outputs, 1 and 8 columns) and the couplings (2, 4), (4, 8) and (6, 6),
   at N = 17,161 in float64 and float32, with its launches counted;
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
   float64 plain version on the CPU; CUDA-event times of each entry point,
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
15. kernel B7, the tiled gram builder, on its entry point
    ``ops.gram.gram_tiled``: ``benchmarks/dense_pieces.py``'s
    ``1.5 * Matern32(scale=2.5)`` at N = M = 1e4 and the gradient in
    ``(amp, scale, X1)`` of ``sum(sin(K) w)`` at N = 2048 (against float64
    autograd, 1e-4 per parameter), with B7's launches counted; B7 against
    float64 on the same float32 values, within twice the float32 plain
    version's error plus 1e-6 of the largest entry, for every leaf with
    either metric on ragged 1-d and 3-d points, the JAX test's kernels,
    each root transform, and the 1e4 gram; timed at 1e4 and summed over
    the dense path's 20 strip shapes (through ``gram_tiled`` and launched
    directly), beside its bound, its plain version and
    ``kernel(X[lo:n], X[lo:cr])`` as the strip build calls it, and the host
    time of one small ``gram_tiled`` call;
16. every quasiseparable order at ``bench.py``'s data (N = 1e5): in
    float32 Matern52's ``condition``, ``predict(return_var=True)`` and
    ``sample``, the 2-term celerite's ``condition``, and
    ``1.2 * SHO + 1.5 * Matern52`` (m = 5): its value (also at N = 1e6),
    its gradient in four hyperparameters and 20 ``fit_map`` steps; in
    float64 the posterior processes (order 8, 12 and 16) of Matern32,
    Matern52 and the 2-term celerite, ``log_probability`` and ``sample``,
    with their default jitter at N = 1e5 (reported: the reference's O(N)
    factor does not hold there) and given ``diag=1e-3`` at N = 5000; the
    generic-order launches counted over the path, each held to its plain
    version on the path's well-posed operands and timed beside its bound
    (B2 repeated bit for bit, one launch a call);
    the float64 entry points against the CPU's plain version; then the
    generic B1 and B1r at m = 5 (N = 1e5 and 1e6) whole and pass by pass
    (a ``torch.profiler`` trace) and B3's generic Riccati flow at m = 5, 8
    and 16.

The line before the last is a JSON record of every kernel (B3 with one
record per monoid and shape of the conditioning path; B4 with and without
its side products, B5 at either order and B6 each summed over the shapes of
the dense main path; B7 at 1e4; one record per generic-order instantiation
of phase 16, and B1, B1r and B2 at m = 5); the last line
is ``{"ok": true, "device": {...}}``. Any failure raises, and the script
then exits non-zero without that line; it also exits non-zero where CUDA is
not available.

``python3 chip_smoke.py --dense-times`` runs phase 1 and then only times
B4 at each trailing size beside ``addmm`` and the dense value and gradient
calls, through entry points older trees share: copied into a parent
commit's checkout, it times the parent's kernels in the same chip call.
``python3 chip_smoke.py --riccati-panel-times`` does the same for B5's
3-term order per panel shape (beside a float64 ``matmul``), the
generic-order B1/B1r at m = 5 whole and pass by pass, B3's generic
Riccati flow, and the ill-conditioned dense ``log_probability`` at
N = 1e4. ``python3 chip_smoke.py --b2-times`` does the same for B2 (the
Matern32 gradient's operands at N = 1e5 and 1e6, the m = 5 sum's at 1e5,
random m = 8 operands at 1e5): CUDA-event times, the passes of a
``torch.profiler`` trace, two launches compared bit for bit, B1 and B1r
on the same operands, and the whole gradient calls.
"""

from __future__ import annotations

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
    for stem in ("dense_tc", "dense_syrk", "quasisep_loglik_bwd", "quasisep_loglik_generic"):
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
            # Template arguments <storage type, order> as the B1-B3 kernels take them.
            targs = plain and re.match(r"I([fd])Li(\d+)E", plain.group(2))
            name = (f"tc_gemm for {('B5', 'B6', 'B4')[int(kind.group(1))]}" if kind
                    else "split_kernel" if "split_kernel" in mangled
                    else f"{plain.group(1)}<{'float' if targs.group(1) == 'f' else 'double'}, "
                         f"{targs.group(2)}>" if targs
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


def phase_kernel_vs_plain():
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    # m = 1..4 run the templated kernels, 5 and 8 the generic-order source
    # (B2 there in one launch), 16 the generic sequence.
    cases = [(m, N_LONG, torch.float64, 1e-8) for m in (1, 2, 3, 4, 5, 8, 16)]
    cases += [(m, N_LONG, torch.float32, 5e-4) for m in (1, 2, 3, 4, 5, 8, 16)]
    cases += [(2, 1_000_000, torch.float64, 1e-8), (2, 1_000_000, torch.float32, 5e-4)]
    failures = []
    for m, n, dtype, rtol in cases:
        args = random_operands(m, n, dtype, seed=m)
        got = [float(x) for x in cuda_loglik.fused_loglik_terms(*args)]
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

        # B1r: the same sums as B1, and residuals that match the plain ones.
        res = cuda_loglik.fused_loglik_res(*args)
        plain_res = cuda_loglik.plain_loglik_terms_res(*args)
        same = [float(x) for x in res[:2]] == got
        errs = stream_errors(res, plain_res)
        ok = same and max(e for e, _ in errs) <= rtol and all(
            bool(torch.isfinite(x).all()) for x in res
        )
        log(
            f"kernel-vs-plain B1r m={m} N={n} {str(dtype)[6:]}: sums equal B1's "
            f"{same}, rel err per stream (quad, logdet, F, e, 1/c) "
            f"{[f'{e:.2e}' for e, _ in errs]} (rtol {rtol:g}) {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            failures.append(("B1r", m, n, dtype))

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
            shape_ok = value.shape == ()
            value = value.item()
            ok = launches > 0 and shape_ok and math.isfinite(value) and rel <= 5e-4
            log(
                f"main-path {name} m={m} N={n} float32: log_probability "
                f"{value!r}, kernel launches {launches}, kernel-vs-plain abs "
                f"err {abs_err:.4g} rel {rel:.3e} (rtol 5e-4), whole call "
                f"{e2e_ms:.4f} ms (constructor {construct_ms:.4f} ms), kernel "
                f"{kernel_ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
                f"{'ok' if ok else 'FAIL'}"
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
    """B2 launched again on ``bwd_args`` gives ``bars`` bit for bit; and at
    m <= 8, from a ``torch.profiler`` trace, one call is one kernel launch
    and at most one memset. Returns (same bits, (one launch, report))."""
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    same = all(torch.equal(a, b) for a, b in zip(bars, cuda_loglik.fused_loglik_bwd(*bwd_args)))
    split, per_call = kernel_split(lambda: cuda_loglik.fused_loglik_bwd(*bwd_args))
    if split is None:
        return same, (True, "device operations per call not measured (no device time "
                            "in the trace)")
    kernels = [k for k in split if not k.startswith("Memset")]
    one = bwd_args[0].shape[0] > 8 or (
        len(kernels) == 1 and all(per <= 1 for _, per in split.values()))
    return same, (one, f"{per_call:g} device operations per call ("
                       + ", ".join(f"{k} {ms:.4f} ms x {per:g}" for k, (ms, per) in split.items())
                       + ")")


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
        m = ps.shape[0]
        res_bound, res_by = loglik_bound_ms(m, n, 4, residuals=True)
        bwd_bound, bwd_by = bwd_bound_ms(m, n, 4)
        ok = counts == [0, 1, 1] and finite and grad_ok and kernels_ok
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
            f"bit {b2_same}, {b2_ops[1]}"
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
        ok = (
            all(math.isfinite(x) for x in losses)
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
            f"backward); launches B1 {counts[0]} B1r {counts[1]} B2 {counts[2]} "
            f"{'ok' if ok else 'FAIL'}"
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


# The generic-order engine: a subset of the variants above at each order
# (every monoid, both directions, both outputs, 1 and 8 columns), and the
# coupling of unequal orders.
GENERIC_ORDERS = (5, 6, 8, 12, 16)
GENERIC_SCAN_VARIANTS = [
    ("aff", False, False, 1),
    ("aff", True, True, 8),
    ("cong", True, False, 1),
    ("ric", False, False, 1),
    ("cpl", False, False, 1),
    ("cpl", True, True, 1),
]
COUPLING_PAIRS = ((2, 4), (4, 8), (6, 6))


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
    cases += [(2, 1_000_000, torch.float64, 1e-8), (2, 1_000_000, torch.float32, 5e-4)]
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

    # The generic-order engine, at N_LONG: every order of the slice's path
    # and the couplings of unequal orders, with its launches counted.
    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    t0 = time.perf_counter()
    for dtype, rtol in ((torch.float64, 1e-8), (torch.float32, 5e-4)):
        cases = [(m, m, v) for m in GENERIC_ORDERS for v in GENERIC_SCAN_VARIANTS]
        cases += [(m1, m2, ("cpl", rev, rev, 1)) for m1, m2 in COUPLING_PAIRS for rev in (False, True)]
        for m, m2, (monoid, reverse, inclusive, r) in cases:
            operands = scan_operands(monoid, m, N_LONG, r, dtype, seed=10 * m + m2, m2=m2)
            before = cuda_scan.LAUNCHES_GENERIC[monoid]
            got = scan_kernel(monoid, m, r, reverse, inclusive, operands, m2=m2)
            want = scan_plain(monoid, m, r, reverse, inclusive, operands, m2=m2)
            (err, _), = stream_errors([got], [want])
            launched = cuda_scan.LAUNCHES_GENERIC[monoid] - before
            ok = err <= rtol and bool(torch.isfinite(got).all()) and launched == 1
            tag = (f"{monoid}{'-rev' if reverse else ''}{'-incl' if inclusive else ''}-r{r} "
                   f"m={m}" + (f"x{m2}" if monoid == "cpl" else ""))
            log(f"kernel-vs-plain B3 generic {tag} N={N_LONG} {str(dtype)[6:]}: rel err "
                f"{err:.2e} (rtol {rtol:g}), generic launches {launched} "
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
        ok = finite and shapes and float(got[2].min()) > 0 and counts["ric"] == 1
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
    f32_err = rel_max(var32.double().cpu(), var_card)
    f64_ok = max(var_err, loc_err, lp64_err) <= 1e-8 and float(var_card.min()) > 0
    log(
        f"condition-path matern32 N={n} float64: card against the plain version on "
        f"the CPU: variance {var_err:.2e} of the largest prior variance {scale!r} "
        f"({var_own:.2e} of its own largest magnitude {float(np.max(np.abs(var_cpu)))!r}), "
        f"loc {loc_err:.2e}, log prob {lp64_err:.2e} (limit 1e-8); posterior variance "
        f"in [{float(var_card.min())!r}, {float(var_card.max())!r}]; the float32 "
        f"variance against the float64 one {f32_err:.2e} of its largest magnitude "
        f"{'ok' if f64_ok else 'FAIL'}"
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
        key = call[:3]
        seen.setdefault(key, []).append(call)
    for (monoid, m, r), group in seen.items():
        _, _, _, reverse, inclusive, operands = group[0]
        got = scan_kernel(monoid, m, r, reverse, inclusive, operands)
        # Against the plain version in float64 on the same values, which
        # is the kernel's own arithmetic, and in float32 as the caller
        # runs it.
        want64 = scan_plain(monoid, m, r, reverse, inclusive, [x.double() for x in operands])
        (rel, abs_err), = stream_errors([got], [want64])
        (rel32, _), = stream_errors([got], [scan_plain(monoid, m, r, reverse, inclusive, operands)])
        ms = cuda_ms(lambda: scan_kernel(monoid, m, r, reverse, inclusive, operands), reps=30, warmup=3)
        plain_ms = cuda_ms(lambda: scan_plain(monoid, m, r, reverse, inclusive, operands), reps=3, warmup=1)
        bound, by = scan_bound_ms(monoid, m, r, n, 4)
        log(
            f"condition-path B3 {monoid} m={m} r={r} N={n} float32 ({len(group)} launches on "
            f"the path, first {'reverse' if reverse else 'forward'} "
            f"{'inclusive' if inclusive else 'exclusive'}): {ms:.4f} ms, bound {bound:.4f} ms "
            f"({by}), plain {plain_ms:.4f} ms; against the plain version in float64 rel "
            f"{rel:.2e} (limit 5e-4), abs {abs_err:.3e}; in float32 rel {rel32:.2e}"
        )
        path_ok = path_ok and rel <= 5e-4
        records.append({
            "name": f"quasisep_scan_{monoid}_m{m}" + (f"_r{r}" if r > 1 else ""),
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


def sum5_gp(X, p):
    """``1.2 * SHO(omega=1.5, quality=3.0) + 1.5 * Matern52(scale=2.5)``
    (order 5), its four hyperparameters ``p = (amp1, omega, amp2, scale)``."""
    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep

    kernel = p[0] * quasisep.SHO(omega=p[1], quality=3.0) + p[2] * quasisep.Matern52(scale=p[3])
    return GaussianProcess(kernel, X, diag=0.1, assume_sorted=True, device=X.device.type)


SUM5_PARAMS = (1.2, 1.5, 1.5, 2.5)


def sum5_value_and_grad(X, y):
    import torch

    p = [torch.tensor(v, dtype=X.dtype, device=X.device, requires_grad=True) for v in SUM5_PARAMS]
    lp = sum5_gp(X, p).log_probability(y)
    return lp.detach(), torch.autograd.grad(lp, p)


def orders_path(X, y, X_test, generator):
    """The slice's float32 entry points at orders above 4, in the order a
    user calls them; returns every output by name."""
    import torch

    from tinygp_tpu_torch import GaussianProcess, fit_map

    out = {}
    dev = X.device.type
    gp = GaussianProcess(matern52_kernel(), X, diag=0.1, assume_sorted=True, device=dev)
    lp, post = gp.condition(y)
    mu, var = gp.predict(y, X_test, return_var=True)
    out["matern52"] = (lp, post.loc, post.variance, mu, var, gp.sample(generator, (16,)))
    gp = GaussianProcess(celerite2(), X, diag=0.1, assume_sorted=True, device=dev)
    lp, post = gp.condition(y)
    out["celerite2"] = (lp, post.loc, post.variance)
    with torch.no_grad():
        value = sum5_gp(X, SUM5_PARAMS).log_probability(y)
    out["sum5"] = (value, *sum5_value_and_grad(X, y)[1])

    def loss_fn(params):
        return -sum5_gp(X, [torch.exp(params[k]) for k in ("amp1", "omega", "amp2", "scale")]
                        ).log_probability(y)

    init = {k: math.log(v) for k, v in zip(("amp1", "omega", "amp2", "scale"), SUM5_PARAMS)}
    res = fit_map(loss_fn, init, num_steps=20, learning_rate=0.05, dtype=X.dtype, device=dev)
    out["sum5_fit"] = (res.losses, res.loss)
    return out


def matern32_kernel():
    from tinygp_tpu_torch.kernels import quasisep

    return 1.5 * quasisep.Matern32(scale=2.5)


def matern52_kernel():
    from tinygp_tpu_torch.kernels import quasisep

    return 1.5 * quasisep.Matern52(scale=2.5)


POSTERIOR_MODELS = {"matern32": matern32_kernel, "matern52": matern52_kernel,
                    "celerite2": celerite2}


def posterior_path(X, y, post_diag, generator=None, noise=None):
    """Each model's posterior process at the training points (order 4m: 8,
    12, 16): its log probability, and a sample of 16 draws through
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
    N = 1e6. Float64: the posterior processes of Matern32, Matern52 and the
    2-term celerite (order 8, 12 and 16), ``log_probability`` and
    ``sample``, with their default 1.49e-8 jitter at N = 1e5, and given
    ``diag=1e-3`` at N = 5000 (every 20th point), where the O(N) algorithm
    holds (see tests/test_torch_orders.py and PERF.md: with the jitter the
    reference's O(N) posterior factor loses the state from N of a few
    hundred; the JAX package returns -inf for Matern32's at N = 2000).
    Every count is set to 0 before the path and read after it; each
    generic-order instantiation is held to its plain version on random
    operands of its path shape; the float64 entry points against the CPU's plain
    float64 path, and the posteriors given diag=1e-3 against a dense
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

    # The path, once, with the generic engine's launches recorded with their
    # operands.
    calls = {}
    launch = cuda_scan._launch

    def recording(monoid, m, r, reverse, inclusive, operands, out_rows, m2=None):
        key = (monoid, m, m if m2 is None else m2, r)
        if key[1] != key[2] or m > 4:
            calls.setdefault(key, []).append((reverse, inclusive, operands))
        return launch(monoid, m, r, reverse, inclusive, operands, out_rows, m2=m2)

    cuda_scan._launch = recording
    try:
        reset_counts()
        out = orders_path(X, y, X_test, torch.Generator(device="cuda").manual_seed(0))
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
    path_s = time.perf_counter() - t0

    finite = {k: all(bool(torch.isfinite(x).all()) for x in v) for k, v in out.items()}
    finite.update({f"{k} posterior diag=1e-3": all(bool(torch.isfinite(x).all()) for x in v)
                   for k, v in noisy.items()})
    shapes = (
        [tuple(x.shape) for x in out["matern52"]] == [(), (n,), (n,), (1000,), (1000,), (16, n)]
        and [tuple(x.shape) for x in out["celerite2"]] == [(), (n,), (n,)]
        and all([tuple(x.shape) for x in v] == [(), (16, n)] for v in jittered.values())
    )
    losses = [float(x) for x in out["sum5_fit"][0]]
    moved = (
        all(scan_counts[k] > 0 for k in ("aff", "ric", "cpl"))
        and loglik_counts["b1"] == 2 and loglik_counts["b1r"] >= 21 and loglik_counts["b2"] >= 21
    )
    path_ok = all(finite.values()) and shapes and moved and float(out["sum5_fit"][1]) < losses[0]
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
        f"{losses[-1]!r}, value at N=1e6 {out['sum5_n1e6'][0].item()!r}; posteriors given "
        f"diag=1e-3 at N={Xs.shape[0]} float64 log prob "
        f"{ {k: v[0].item() for k, v in noisy.items()} }; finite {finite}, shapes {shapes}; "
        f"generic launches B3 {scan_counts}, B1/B1r/B2 {loglik_counts}; all launches "
        f"B1/B1r/B2 {b123} {'ok' if path_ok else 'FAIL'}"
    )
    log(
        f"orders-path posteriors at N={n} float64 with the default jitter (the reference "
        f"algorithm's O(N) factor does not hold here; recorded, not checked): {jitter_report}"
    )

    # The float64 entry points on the card against the CPU's plain float64
    # path: the m = 5 sum's value and gradient and Matern52's posterior mean
    # and variance at N = 1e5 (the variance within 1e-8 of the largest
    # prior variance, as the conditioning phase holds Matern32's).
    t1 = time.perf_counter()
    Xc, yc = X64.cpu(), y64.cpu()
    card_v, card_g = sum5_value_and_grad(X64, y64)
    cpu_v, cpu_g = sum5_value_and_grad(Xc, yc)
    errs = {"sum5 value": rel_err(card_v.item(), cpu_v.item())}
    errs.update({f"sum5 grad {i}": rel_err(float(a), float(b))
                 for i, (a, b) in enumerate(zip(card_g, cpu_g))})
    from tinygp_tpu_torch import GaussianProcess

    def m52(X):
        return GaussianProcess(matern52_kernel(), X, diag=0.1, assume_sorted=True,
                               device=X.device.type)

    card_post = m52(X64).condition(y64)[1]
    cpu_post = m52(Xc).condition(yc)[1]
    scale = float(m52(Xc).variance.abs().max())
    errs["matern52 loc"] = rel_max(card_post.loc.cpu(), cpu_post.loc)
    errs["matern52 variance"] = float(
        (card_post.variance.cpu() - cpu_post.variance).abs().max()) / scale
    f64_ok = max(errs.values()) <= 1e-8
    log(
        f"orders-path float64, card against the CPU's plain version "
        f"({time.perf_counter() - t1:.1f} s): "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (limit 1e-8) "
        f"{'ok' if f64_ok else 'FAIL'}"
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
            "name": f"quasisep_generic_scan_{monoid}_m{m}" + (f"x{m2}" if monoid == "cpl" else "")
            + (f"_r{r}" if r > 1 else ""),
            "route": "cuda",
            "source": "tinygp_tpu_torch/csrc/quasisep_generic.cu",
            "replaces": "tinygp_tpu/solvers/quasisep/pallas_scan.py:331",
            "launches": len(group),
            "max_abs_err": abs_err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,
        })

    # B1 (at 1e6), B1r and B2 (at 1e5) at m = 5 on the path's operands.
    with torch.no_grad():
        gp6 = sum5_gp(X_1e6, SUM5_PARAMS)
        ops6 = (*gp6.solver.ssm, (y_1e6 - gp6.loc).contiguous())
        gp5 = sum5_gp(X, SUM5_PARAMS)
        ops5 = (*gp5.solver.ssm, (y - gp5.loc).contiguous())
        got = cuda_loglik.fused_loglik_terms(*ops6)
        b1_err = stream_errors(got, cuda_loglik.plain_loglik_terms(*(x.double() for x in ops6)))
        res = cuda_loglik.fused_loglik_res(*ops5)
        res_err = stream_errors(res, cuda_loglik.plain_loglik_terms_res(*(x.double() for x in ops5)))
        qbar, lbar = (torch.tensor(v, device="cuda") for v in (-0.5, -1.0))
        bwd_args = (*ops5[1:], *res[2:], qbar, lbar)
        bars = cuda_loglik.fused_loglik_bwd(*bwd_args)
        bwd_err = stream_errors(bars, cuda_loglik.plain_loglik_bwd(*(x.double() for x in bwd_args)))
        b2_same, (b2_one, b2_report) = b2_launch_checks(bwd_args, bars)
        timings = {
            "b1": (cuda_ms(lambda: cuda_loglik.fused_loglik_terms(*ops6), reps=10, warmup=2),
                   cuda_ms(lambda: cuda_loglik.plain_loglik_terms(*ops6), reps=1, warmup=1)),
            "b1r": (cuda_ms(lambda: cuda_loglik.fused_loglik_res(*ops5), reps=10, warmup=2),
                    cuda_ms(lambda: cuda_loglik.plain_loglik_terms_res(*ops5), reps=1, warmup=1)),
            "b2": (cuda_ms(lambda: cuda_loglik.fused_loglik_bwd(*bwd_args), reps=10, warmup=2),
                   cuda_ms(lambda: cuda_loglik.plain_loglik_bwd(*bwd_args), reps=1, warmup=1)),
        }
    m = ops5[1].shape[0]
    bounds = {
        "b1": loglik_bound_ms(m, X_1e6.shape[0], 4),
        "b1r": loglik_bound_ms(m, n, 4, residuals=True),
        "b2": bwd_bound_ms(m, n, 4),
    }
    errs = {"b1": b1_err, "b1r": res_err, "b2": bwd_err}
    for key, name, replaces in (
        ("b1", "quasisep_loglik_generic_m5", "pallas_loglik.py:86"),
        ("b1r", "quasisep_loglik_res_generic_m5", "pallas_loglik.py:86 residuals=True"),
        ("b2", "quasisep_loglik_bwd_generic_m5", "pallas_loglik.py:414"),
    ):
        rel = max(e for e, _ in errs[key])
        ok = rel <= 5e-4 and (key != "b2" or (b2_same and b2_one))
        kernels_ok = kernels_ok and ok
        (ms, plain_ms), (bound, by) = timings[key], bounds[key]
        n_op = X_1e6.shape[0] if key == "b1" else n
        extra = (f"; a second launch equal bit for bit {b2_same}, {b2_report}"
                 if key == "b2" else "")
        log(
            f"orders-path {key.upper()} generic m={m} N={n_op} float32 ({loglik_counts[key]} "
            f"launches on the path): {ms:.4f} ms, bound {bound:.4f} ms ({by}), plain "
            f"{plain_ms:.4f} ms (one call); against the plain version in float64 rel per "
            f"stream {[f'{e:.2e}' for e, _ in errs[key]]} (limit 5e-4){extra} "
            f"{'ok' if ok else 'FAIL'}"
        )
        records.append({
            "name": name,
            "route": "cuda",
            "source": "tinygp_tpu_torch/csrc/quasisep_loglik_generic.cu",
            "replaces": f"tinygp_tpu/solvers/quasisep/{replaces}",
            "launches": loglik_counts[key],
            "max_abs_err": max(a for _, a in errs[key]),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,
        })
    # B1, B1r and B2 at m = 8 and 16 (no entry point's path above runs them
    # there), on random operands at N = 1e5 in float32, beside their bounds.
    for m_hi in (8, 16):
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
        "celerite2 posterior (order 16, diag=1e-3, N=5000) log_probability": lambda: (
            GaussianProcess(celerite2(), Xs, diag=0.1, assume_sorted=True)
            .condition(ys, diag=1e-3)[1].log_probability(ys)),
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
LOGLIK_STAGES = ("ric chunk", "ric totals", "ric finish", "emit_pass", "aff chunk",
                 "aff totals", "aff finish", "terms_pass", "g_reduce", "other")


def loglik_split(fn, calls=5):
    """Device microseconds per call of each pass of the generic B1/B1r
    sequence, from a ``torch.profiler`` trace of ``calls`` calls of
    ``fn``; None where the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sorted(
        (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.time_range.start)
    split = dict.fromkeys(LOGLIK_STAGES, 0.0)
    ric_done = False
    for e in kernels:
        name, us = e.name, e.time_range.elapsed_us()
        scan = "aff" if ric_done else "ric"
        for key, stage in (("ric_chunk_pass", "ric chunk"), ("ric_finish_pass", "ric finish"),
                           ("aff_chunk_pass", "aff chunk"), ("aff_finish_pass", "aff finish"),
                           ("g_chunk_pass", f"{scan} chunk"), ("g_totals_pass", f"{scan} totals"),
                           ("g_finish_pass", f"{scan} finish"), ("emit_pass", "emit_pass"),
                           ("terms_pass", "terms_pass"), ("g_reduce", "g_reduce")):
            if key in name:
                break
        else:
            stage = "other"
        split[stage] += us / calls
        if "emit_pass" in name or "ric_finish_pass" in name:
            ric_done = True
        if "g_reduce" in name:
            ric_done = False
    return split if sum(split.values()) > 0 else None


def generic_loglik_times():
    """The generic-order B1 and B1r at m = 5 on the m = 5 sum's operands
    (``1.2 * SHO + 1.5 * Matern52``, float32) at N = 1e5 and 1e6: the whole
    call by CUDA events, each pass of the sequence from a profiler trace,
    and the Riccati flow alone through B3's generic entry; B2 at m = 5 and
    1e5; then B3's generic Riccati flow at m = 8 and 16 and its affine scan
    with one column at m = 8 (forward and reverse) in float64 on random
    operands at 1e5. B1, B1r and B2 are held to their float64 plain
    versions (5e-4, the float32 limit). Returns {label: ms}."""
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik, cuda_scan

    (X5, y5), (X6, y6) = bench_data()
    out = {}
    for Xn, yn in ((X5, y5), (X6, y6)):
        X, y = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (Xn, yn))
        n = X.shape[0]
        with torch.no_grad():
            gp = sum5_gp(X, SUM5_PARAMS)
            ops = (*gp.solver.ssm, (y - gp.loc).contiguous())
        want = cuda_loglik.plain_loglik_terms(*(x.double() for x in ops))
        for key, fn in (("B1", cuda_loglik.fused_loglik_terms),
                        ("B1r", cuda_loglik.fused_loglik_res)):
            (rel_q, _), (rel_l, _) = stream_errors(fn(*ops)[:2], want)
            if not max(rel_q, rel_l) <= 5e-4:
                raise AssertionError(f"generic {key} at m = 5, N = {n} disagrees with float64: "
                                     f"{rel_q:.3e} / {rel_l:.3e} (limit 5e-4)")
            ms = cuda_ms(lambda: fn(*ops), reps=10, warmup=2)
            split = loglik_split(lambda: fn(*ops))
            out[f"{key} m=5 N={n}"] = ms
            shown = ("not measured (no device time in the trace)" if split is None else
                     ", ".join(f"{k} {v / 1e3:.4f}" for k, v in split.items() if v))
            bound = loglik_bound_ms(5, n, 4, residuals=key == "B1r")[0]
            log(f"generic-times {key} m=5 N={n} float32 [{CARD}]: {ms:.4f} ms, bound "
                f"{bound:.4f} ms; against float64 plain rel {rel_q:.2e} / {rel_l:.2e} (limit "
                f"5e-4) ok; split (ms per call): {shown}")
        ric = cuda_ms(lambda: cuda_scan.riccati(*ops[:4]), reps=10, warmup=2)
        out[f"ric m=5 N={n}"] = ric
        log(f"generic-times B3 Riccati flow alone m=5 N={n} float32 [{CARD}]: {ric:.4f} ms")
        if n == 100_000:
            # B2, whose reverse affine scan has one column.
            res = cuda_loglik.fused_loglik_res(*ops)
            bwd_args = (*ops[1:], *res[2:], *(torch.ones((), device="cuda") for _ in range(2)))
            plain = cuda_loglik.plain_loglik_bwd(*(x.double() for x in bwd_args))
            worst = max(rel for rel, _ in stream_errors(cuda_loglik.fused_loglik_bwd(*bwd_args),
                                                        plain))
            if not worst <= 5e-4:
                raise AssertionError(f"generic B2 at m = 5 disagrees with float64: {worst:.3e}")
            ms = cuda_ms(lambda: cuda_loglik.fused_loglik_bwd(*bwd_args), reps=10, warmup=2)
            out[f"B2 m=5 N={n}"] = ms
            log(f"generic-times B2 m=5 N={n} float32 [{CARD}]: {ms:.4f} ms, bound "
                f"{bwd_bound_ms(5, n, 4)[0]:.4f} ms; against float64 plain rel {worst:.2e} "
                f"(limit 5e-4) ok")
            del res, bwd_args, plain
        del X, y, gp, ops
    for m in (8, 16):
        args = random_operands(m, 100_000, torch.float64, seed=m)
        ms = cuda_ms(lambda: cuda_scan.riccati(*args[:4]), reps=10, warmup=2)
        out[f"ric m={m} N=100000 float64"] = ms
        log(f"generic-times B3 Riccati flow m={m} N=100000 float64 [{CARD}]: {ms:.4f} ms, bound "
            f"{scan_bound_ms('ric', m, 1, 100_000, 8)[0]:.4f} ms")
    gen = torch.Generator(device="cuda").manual_seed(8)
    trans = torch.randn(64, 100_000, generator=gen, device="cuda", dtype=torch.float64) / 8
    loads = torch.randn(8, 100_000, generator=gen, device="cuda", dtype=torch.float64)
    for reverse in (False, True):
        ms = cuda_ms(lambda: cuda_scan.affine(trans, loads, 8, 1, reverse=reverse, exclusive=True),
                     reps=10, warmup=2)
        out[f"aff m=8 r=1 reverse={reverse} N=100000 float64"] = ms
        log(f"generic-times B3 affine m=8 r=1 reverse={reverse} N=100000 float64 [{CARD}]: "
            f"{ms:.4f} ms, bound {scan_bound_ms('aff', 8, 1, 100_000, 8)[0]:.4f} ms")
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
    float64 ``matmul``; the generic-order B1/B1r at m = 5 whole and by
    pass, and B3's generic Riccati flow; the ill-conditioned dense
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
    calls. (None, 0) where the trace holds no device time."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted(
        (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
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
    ops, params = gram._compile(pieces, X, X)[2:]
    nbytes, flops = gram_work(GRAM_N, GRAM_N, 1, ops, len(params))
    bound, by = bound_ms(nbytes, flops)
    k_ms = cuda_ms(lambda: gram.gram_tiled(pieces, X, X), reps=20, warmup=3)
    p_ms = cuda_ms(lambda: gram.plain_gram(pieces, X, X), reps=20, warmup=3)
    cdist_ms = cuda_ms(lambda: torch.cdist(X[:, None], X[:, None]), reps=20, warmup=3)
    log(f"gram dense_pieces.py N={GRAM_N} [{CARD}]: B7 {k_ms:.4f} ms, bound {bound:.4f} ms "
        f"({by}; {nbytes} bytes, {flops} operations), plain {p_ms:.4f} ms")
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
        "plain_ms": p_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }


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
    phase_build()
    phase_dense_precision()
    if sys.argv[1:] == ["--dense-times"]:
        dense_times()
        return 0
    if sys.argv[1:] == ["--riccati-panel-times"]:
        riccati_panel_times()
        return 0
    if sys.argv[1:] == ["--b2-times"]:
        b2_times()
        return 0
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
    gram_record = phase_gram()
    generic_records = phase_orders_path()
    generic_loglik_times()
    records = [record, grad_records["res"], grad_records["bwd"], *scan_records]
    records += dense_records(measured, launches)
    records.append(gram_record)
    records += generic_records
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
