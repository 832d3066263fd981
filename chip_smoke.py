"""Drive the PyTorch port on one CUDA card and check it end to end.

Run from the root of the repository, on a machine with one NVIDIA card and
``nvcc``::

    python3 chip_smoke.py

Phases, each printing its numbers on lines of its own:

1. the card's name and power limit; the build of every CUDA kernel;
2. each kernel against its plain PyTorch version on random operands
   (m = 1..4 at N = 17,161 in float64 and float32; m = 2 at N = 1e6);
3. the kernel path's ``log_probability`` against a dense numpy/scipy
   Cholesky log-likelihood built from the kernels' closed forms (float64);
4. the main path at full size in float32, as ``bench.py`` runs it:
   ``GaussianProcess(kernel, X, diag=0.1, assume_sorted=True)
   .log_probability(y)`` for Matern32 at N = 1e5 and 1e6, the flagship SHO
   and the 2-term celerite at N = 1e5, with the kernel launches counted
   over each call, and CUDA-event timings of the whole call, of the
   constructor alone, of the kernel alone and of the plain version.

The line before the last is a JSON record of every kernel; the last line
is ``{"ok": true, "device": {...}}``. Any failure raises, and the script
then exits non-zero without that line; it also exits non-zero where CUDA is
not available.
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


def loglik_bound_ms(m, n, itemsize):
    """Least time for (quad, logdet): read every operand once, or do the
    sequential algorithm's operations, whichever is longer."""
    nbytes = (m * m + 2 * m + 2) * n * itemsize + 2 * itemsize
    # Per element: F p, p.Fp and a F p (4m^2 + 2m), alpha (2m + 4),
    # the affine step and its update (4m^2 + 2m), a F a^T + u u^T / c2
    # (4m^3 + 3m^2), c and log c (4).
    flops = n * (4 * m**3 + 11 * m**2 + 6 * m + 8)
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


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
    log("card name and power limit (nvidia-smi):")
    log(smi.stdout.strip())
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}"
    )
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")


def phase_kernel_vs_plain():
    import torch

    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    cases = [(m, N_LONG, torch.float64, 1e-8) for m in (1, 2, 3, 4)]
    cases += [(m, N_LONG, torch.float32, 5e-4) for m in (1, 2, 3, 4)]
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
            failures.append((m, n, dtype))
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


def phase_main_path():
    """The main path at full size; returns the kernel's JSON record."""
    import torch

    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    # bench.py's draws, in its order: X, y at 1e5, then X6, y6 at 1e6.
    rng = np.random.default_rng(42)
    X5 = np.sort(rng.uniform(0, 10, 100_000))
    y5 = rng.normal(size=100_000)
    X6 = np.sort(rng.uniform(0, 10, 1_000_000))
    y6 = rng.normal(size=1_000_000)

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
            cuda_loglik.LAUNCHES = 0
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    phase_build()
    phase_kernel_vs_plain()
    phase_dense_check()
    record = phase_main_path()
    log(json.dumps({"kernels": [record]}))
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
