"""Drive the PyTorch port on one CUDA card and check it end to end.

Run from the root of the repository, on a machine with one NVIDIA card and
``nvcc``::

    python3 chip_smoke.py

Phases, each printing its numbers on lines of its own:

1. the card's name and power limit; the build of every CUDA kernel;
2. each kernel against its plain PyTorch version on random operands
   (m = 1..4 at N = 17,161 in float64 and float32; m = 2 at N = 1e6): B1
   (the log-likelihood), B1r (with the residuals a gradient needs) and B2
   (the backward, on B1r's residuals, with random scalar cotangents);
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
   forward and backward, of B1r, of B2 and of their plain versions;
6. the trainer: 20 Adam steps of ``fit_map`` on the Matern32 model's log
   hyperparameters at N = 1e5 and 1e6 in float32, with one B1r and one B2
   launch per step.

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
    from tinygp_tpu_torch.solvers.quasisep import cuda_loglik

    cuda_loglik.LAUNCHES = cuda_loglik.LAUNCHES_RES = cuda_loglik.LAUNCHES_BWD = 0


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
        plain_bars = cuda_loglik.plain_loglik_bwd(*bwd_args)
        errs = stream_errors(bars, plain_bars)
        ok = max(e for e, _ in errs) <= rtol and all(
            bool(torch.isfinite(x).all()) for x in bars
        )
        log(
            f"kernel-vs-plain B2 m={m} N={n} {str(dtype)[6:]}: rel err per "
            f"stream (dbar, psbar, qsbar, asbar, ybar) "
            f"{[f'{e:.2e}' for e, _ in errs]} (rtol {rtol:g}) {'ok' if ok else 'FAIL'}"
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
            kernels_ok = (
                max(e for e, _ in res_err64) <= 5e-4
                and max(e for e, _ in bwd_err64) <= 5e-4
                and max(e for e, _ in res_err32[:2]) <= 5e-4
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
            f"float64; the sums also against float32)"
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    phase_build()
    phase_kernel_vs_plain()
    phase_dense_check()
    phase_dense_gradient()
    record = phase_main_path()
    grad_records = phase_gradient_path()
    trainer_counts = phase_trainer()
    grad_records["res"]["launches"] += trainer_counts[1]
    grad_records["bwd"]["launches"] += trainer_counts[2]
    log(json.dumps({"kernels": [record, grad_records["res"], grad_records["bwd"]]}))
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
