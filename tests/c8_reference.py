"""The figures of ``tests/test_torch_c8.py``: the JAX package's
``condition(y).gp.loc`` and ``.variance`` at the training points for
``1.5 * Matern32(scale=2.5)``, ``diag=0.1``, on every ``step``-th point of
``bench.py``'s N = 1e5 draws (``default_rng(42)``), under x64 on float32
inputs (its float64 result, as the JAX package returns it there): the
values at ``INDICES`` and the sums of both.

Run from the repository root, one JSON line per step:

    python tests/c8_reference.py 100

About 40 s on a CPU at N = 1000 (step 100).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

INDICES = (0, 1, 137, 500, 998, 999)


def data(step):
    rng = np.random.default_rng(42)
    X = np.sort(rng.uniform(0, 10, 100_000))
    y = rng.normal(size=100_000)
    return X[::step].astype(np.float32), y[::step].astype(np.float32)


def jax_condition(step):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from tinygp_tpu import GaussianProcess
    from tinygp_tpu.kernels import quasisep

    X, y = (jnp.asarray(a) for a in data(step))
    gp = GaussianProcess(1.5 * quasisep.Matern32(scale=2.5), X, diag=0.1, assume_sorted=True)
    post = gp.condition(y).gp
    return np.asarray(post.loc), np.asarray(post.variance)


def main(argv):
    for step in [int(s) for s in argv] or [100]:
        t0 = time.perf_counter()
        loc, var = jax_condition(step)
        idx = [i for i in INDICES if i < loc.shape[0]]
        print(json.dumps({
            "n": int(loc.shape[0]), "dtype": str(loc.dtype), "indices": idx,
            "loc": [float(loc[i]) for i in idx], "variance": [float(var[i]) for i in idx],
            "loc_sum": float(np.sum(loc)), "variance_sum": float(np.sum(var)),
            "loc_absmax": float(np.max(np.abs(loc))), "variance_absmax": float(np.max(np.abs(var))),
            "seconds": round(time.perf_counter() - t0, 1),
        }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
