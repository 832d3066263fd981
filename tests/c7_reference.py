"""The figures of ``tests/test_torch_c7.py``: the value and gradient in
``(amp, scale)`` of the held-out loss
``sum(w * mu) + sum(var)`` of ``predict(y, linspace(0, 10, 1000),
return_var=True)`` for ``amp * Matern32(scale)`` at ``(1.5, 2.5)``,
``diag=0.1``, on every ``step``-th point of ``bench.py``'s N = 1e5 draws
(``w`` from ``default_rng(7)``), in float64 and on float32 inputs: by
default the JAX package's, under x64 and with ``jit(value_and_grad)``, as
its tests run; with ``--x64-off`` the JAX package's float32 with x64 off
(the TPU's float32 mode: no float64 anywhere); with ``--port`` the port's
on the CPU (``chip_smoke.predict_loss``, no JAX imported).

Run from the repository root, one JSON line per step and dtype:

    python tests/c7_reference.py 100 10 1
    python tests/c7_reference.py --x64-off 100
    python tests/c7_reference.py --port 100 10

Each JAX compile takes minutes on a CPU (about ten at N = 1e4, several GB
of memory).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

THETA = (1.5, 2.5)


def data(step):
    rng = np.random.default_rng(42)
    X = np.sort(rng.uniform(0, 10, 100_000))
    y = rng.normal(size=100_000)
    w = np.random.default_rng(7).normal(size=1000)
    return X[::step], y[::step], np.linspace(0, 10, 1000), w


def jax_value_and_grad(step, dtype, x64=True):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    import jax.numpy as jnp

    from tinygp_tpu import GaussianProcess
    from tinygp_tpu.kernels import quasisep

    def loss(th, X, y, X_test, w):
        gp = GaussianProcess(th[0] * quasisep.Matern32(scale=th[1]), X, diag=0.1,
                             assume_sorted=True)
        mu, var = gp.predict(y, X_test, return_var=True)
        return jnp.sum(w * mu) + jnp.sum(var)

    args = [jnp.asarray(a.astype(dtype)) for a in data(step)]
    value, grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(THETA, dtype), *args)
    return float(value), [float(g) for g in grad]


def port_value_and_grad(step, dtype):
    import torch

    from chip_smoke import predict_loss

    th = torch.tensor(THETA, dtype=getattr(torch, np.dtype(dtype).name), requires_grad=True)
    value = predict_loss(th, *data(step))
    (grad,) = torch.autograd.grad(value, th)
    return float(value.detach()), [float(g) for g in grad]


def main(argv):
    mode = argv[0] if argv[:1] in (["--port"], ["--x64-off"]) else "jax"
    dtypes = (np.float32,) if mode == "--x64-off" else (np.float64, np.float32)
    for step in [int(s) for s in argv if not s.startswith("--")] or [100]:
        for dtype in dtypes:
            t0 = time.perf_counter()
            if mode == "--port":
                value, grad = port_value_and_grad(step, dtype)
            else:
                value, grad = jax_value_and_grad(step, dtype, x64=mode == "jax")
            print(json.dumps({
                "n": 100_000 // step, "dtype": np.dtype(dtype).name, "value": value,
                "grad": grad, "seconds": round(time.perf_counter() - t0, 1),
                "package": {"--port": "port", "--x64-off": "jax, x64 off"}.get(mode, "jax"),
            }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
