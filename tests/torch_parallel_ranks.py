"""Rank programs for the ``parallel`` tests of the port (``test_torch_parallel_*.py``).

:class:`Groups` starts gloo groups of CPU processes, one process per
rank, all at once: each runs ``python tests/torch_parallel_ranks.py SUITE
RANK WORLD PORT OUT TIMEOUT``, joins its group on ``127.0.0.1:PORT``, runs the
suite's checks on one thread and saves what it found to
``OUT/SUITE.WORLD.RANK.pt``. The tests read those files and compare them
with the JAX package in their own process. This file imports no JAX.
"""

from __future__ import annotations

import faulthandler
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_parallel/test_sharded.py's targets.
MU = np.array([1.0, -2.0])
SD = np.array([0.5, 1.5])


class Groups:
    """Gloo groups of CPU processes running ``suite``, one process per
    rank, one group of each size in ``worlds``, all started at once;
    :meth:`wait` returns each size's per-rank results."""

    def __init__(self, suite: str, worlds, out: str, timeout: float = 600.0):
        from tinygp_tpu_torch.parallel.mesh import free_port

        self.suite, self.worlds, self.out = suite, tuple(worlds), out
        self.deadline = time.monotonic() + timeout
        self.procs = []
        for world in self.worlds:
            port = free_port()
            for rank in range(world):
                cmd = [sys.executable, os.path.abspath(__file__), suite, str(rank), str(world),
                       str(port), out, str(timeout)]
                self.procs.append(subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))

    def wait(self) -> dict[int, list]:
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=max(1.0, self.deadline - time.monotonic()))[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(self.procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"{' '.join(p.args[2:5])} failed:\n{log}")
        return {
            world: [torch.load(os.path.join(self.out, f"{self.suite}.{world}.{rank}.pt"),
                               weights_only=False) for rank in range(world)]
            for world in self.worlds
        }


def raises(fn, match: str) -> bool:
    """Whether ``fn()`` raises ``ValueError`` with ``match`` in its text."""
    try:
        fn()
    except ValueError as err:
        return match in str(err)
    return False


def gp_data(n=256, seed=86):
    """tests/test_parallel/test_sharded_scan.py's data."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(0, 10, n)), rng.normal(size=n)


SCAN_KERNELS = {
    "sho": lambda q, amp, scale: amp * q.SHO(omega=scale, quality=3.0),
    "sum_scale": lambda q, amp, scale: q.Matern32(scale=scale) + q.Cosine(scale=2.0) * amp,
}


def suite_scan(rank: int, world: int) -> dict:
    """``sharded_loglik`` (values and gradients), ``sharded_loglik_chains``
    on a 2-D mesh, the three sharded scans against the one-rank scans,
    and the validation errors."""
    from tinygp_tpu_torch.kernels import quasisep as tq
    from tinygp_tpu_torch.parallel import make_mesh
    from tinygp_tpu_torch.parallel.mesh import axis_group
    from tinygp_tpu_torch.parallel.scan import (
        sharded_affine_scan,
        sharded_loglik,
        sharded_loglik_chains,
        sharded_riccati_scan,
    )
    from tinygp_tpu_torch.solvers.quasisep import scan as chip_scan
    from tinygp_tpu_torch.test_utils import random_qsm_operands

    out = {}
    X, y = (torch.as_tensor(a) for a in gp_data())
    mesh = make_mesh(axis_names=("data",), device="cpu")
    for name, make in SCAN_KERNELS.items():
        amp, scale = (torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (1.4, 2.1))
        value = sharded_loglik(make(tq, amp, scale), X, y, diag=0.1, mesh=mesh)
        out[name] = (value.detach(), *torch.autograd.grad(value, (amp, scale)))
    out["uneven"] = raises(
        lambda: sharded_loglik(tq.Matern32(scale=1.0), X[:251], y[:251], diag=0.1, mesh=mesh),
        "divide evenly")

    # The scans on random operands: this rank's slice of the global states.
    n = 64 * world
    d, ps, qs, as_, _ = (torch.as_tensor(v) for v in random_qsm_operands(3, n, seed=5))
    p, q, a = ps.T, qs.T, as_.T.reshape(n, 3, 3)
    B = torch.as_tensor(np.random.default_rng(6).normal(size=(n, 3, 2)))
    rows = slice(rank * n // world, (rank + 1) * n // world)
    group = axis_group(mesh, "data")
    out["affine"] = (sharded_affine_scan(a[rows], B[rows], axis_name=group),
                     chip_scan.affine_scan(a, B, reverse=False, parallel=False)[rows])
    out["riccati"] = (sharded_riccati_scan(d[rows], p[rows], q[rows], a[rows], axis_name=group),
                      chip_scan.riccati_scan(d, p, q, a, parallel=False)[rows])

    if world > 1:
        mesh2d = make_mesh(axis_names=("chains", "data"), axis_sizes=(world // 2, 2),
                           device="cpu")
        scales = torch.tensor([1.3, 2.1, 0.8, 3.0], dtype=torch.float64)
        ys = torch.stack([y, -y, 0.5 * y, y**2 - 1.0])
        out["chains"] = sharded_loglik_chains(tq.Matern32(scale=scales), X, ys, diag=0.1,
                                              mesh=mesh2d)
        scales2 = torch.tensor([1.5, 2.5], dtype=torch.float64, requires_grad=True)
        total = torch.sum(sharded_loglik_chains(tq.Matern32(scale=scales2), X,
                                                torch.stack([y, -y]), diag=0.1, mesh=mesh2d))
        out["chains_grad"] = torch.autograd.grad(total, scales2)[0]
        three = tq.Matern32(scale=torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64))
        out["chains_errors"] = (
            raises(lambda: sharded_loglik_chains(three, X, torch.stack([y, y, y]), diag=0.1,
                                                 mesh=mesh2d), "chains must divide")
            if world // 2 > 1 else True,
            raises(lambda: sharded_loglik_chains(three, X, y, diag=0.1, mesh=mesh2d),
                   "must be (num_chains"),
        )
    return out


def suite_dense(rank: int, world: int) -> dict:
    """``cholesky_tp``'s blocks and its gradient at
    tests/test_parallel/test_dense_tp.py's sizes, and the uneven error."""
    from tinygp_tpu_torch.parallel import cholesky_tp, make_mesh

    mesh = make_mesh(axis_names=("tp",), device="cpu")
    out = {}
    for n, block in ((512, 64), (512, 128)):
        rng = np.random.default_rng(7)
        A = rng.normal(size=(n, n)) / np.sqrt(n)
        out[(n, block)] = cholesky_tp(torch.as_tensor(A @ A.T + np.eye(n)), mesh=mesh, block=block)
    n, block = 256, 64
    A = torch.as_tensor(np.random.default_rng(3).normal(size=(n, n)) / np.sqrt(n),
                        ).requires_grad_()
    K = A @ A.T + torch.eye(n, dtype=A.dtype)
    L = cholesky_tp(K, mesh=mesh, block=block)
    out["grad"] = torch.autograd.grad(torch.sum(L), A)[0]
    out["uneven"] = raises(lambda: cholesky_tp(torch.eye(500, dtype=torch.float64), mesh=mesh,
                                               block=64), "divide evenly")
    return out


GAUSSIAN_INIT = {"x": torch.zeros(2, dtype=torch.float64)}
MCMC_SETTINGS = {
    "nuts": dict(num_chains=32, num_warmup=300, num_samples=300),
    "hmc": dict(num_chains=32, num_warmup=30, num_samples=30, num_leapfrog=8),
}
GP_INIT = {"log_scale": torch.zeros((), dtype=torch.float64),
           "log_amp": torch.zeros((), dtype=torch.float64)}
GP_SETTINGS = dict(num_chains=8, num_warmup=12, num_samples=8, jitter_init=0.3,
                   max_tree_depth=4)


def smc_particles():
    return {"x": 4.0 * torch.randn(2048, 2, generator=torch.Generator().manual_seed(1),
                                   dtype=torch.float64)}


def gp_posterior_data():
    rng = np.random.default_rng(11)
    return torch.as_tensor(np.sort(rng.uniform(0, 10, 80))), torch.as_tensor(rng.normal(size=80))


def gaussian_log_prob(p):
    return -0.5 * torch.sum(torch.square((p["x"] - torch.as_tensor(MU)) / torch.as_tensor(SD)))


def gaussian_log_prior(p):
    return -0.5 * torch.sum(torch.square(p["x"]) / 16.0)


def gp_log_post(t, y):
    """tests/test_parallel/test_sharded.py's GP hyperparameter posterior."""
    from tinygp_tpu_torch import GaussianProcess
    from tinygp_tpu_torch.kernels import quasisep as tq

    def log_post(p):
        gp = GaussianProcess(torch.exp(2 * p["log_amp"]) * tq.Matern32(scale=torch.exp(p["log_scale"])),
                             t, diag=0.01, device="cpu")
        return gp.log_probability(y) - 0.5 * (p["log_amp"] ** 2 + p["log_scale"] ** 2)

    return log_post


def suite_sharded(rank: int, world: int) -> dict:
    """The sharded samplers against the single-process ones with the same
    seed, the sharded checkpoint, ``window_adaptation`` with a group, the
    mesh rules and the collectives' adjoints."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard

    from tinygp_tpu_torch import samplers
    from tinygp_tpu_torch.parallel import (
        local_chunk,
        make_mesh,
        run_mcmc_sharded,
        run_smc_sharded,
    )
    from tinygp_tpu_torch.parallel import mesh as pmesh
    from tinygp_tpu_torch.utils.checkpoint import load_pytree_sharded, save_pytree_sharded

    out = {}
    mesh = make_mesh(device="cpu")
    for sampler, settings in MCMC_SETTINGS.items():
        samples, info = run_mcmc_sharded(0, gaussian_log_prob, GAUSSIAN_INIT, mesh=mesh,
                                         sampler=sampler, device="cpu", **settings)
        out[sampler] = (samples["x"], info["accept_prob"], info["num_steps"])
    res = run_smc_sharded(2, gaussian_log_prior, gaussian_log_prob, smc_particles(), mesh=mesh,
                          device="cpu")
    out["smc"] = res
    t, y = gp_posterior_data()
    out["gp"] = run_mcmc_sharded(0, gp_log_post(t, y), GP_INIT, mesh=mesh, device="cpu",
                                 **GP_SETTINGS)[0]

    # window_adaptation with the group, on this rank's chains, against
    # the same steps without one on all of them.
    from tinygp_tpu_torch.samplers.hmc import _generator, _Rows

    init_fn, step_fn = samplers.nuts(lambda z: gaussian_log_prob({"x": z}), max_tree_depth=4)
    z0 = torch.randn(16, 2, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    c_loc = 16 // world
    rows = slice(rank * c_loc, (rank + 1) * c_loc)
    carries = []
    for axis, z, stream in ((None, z0, lambda k: _generator(4, 1, k, "cpu")),
                            (pmesh.axis_group(mesh, "chains"), z0[rows],
                             lambda k: _Rows(_generator(4, 1, k, "cpu"), 16, rows.start))):
        adapt = samplers.window_adaptation(step_fn, num_warmup=40, axis=axis)
        carry = adapt.init(init_fn(z))
        for k in range(40):
            carry = adapt.body(carry, k, stream(k))
        carries.append(adapt.finish(carry))
    (states, step, inv_mass, info), (states_g, step_g, inv_mass_g, info_g) = carries
    out["window"] = (torch.equal(states.z[rows], states_g.z) and torch.equal(step, step_g)
                     and torch.equal(inv_mass, inv_mass_g)
                     and all(torch.equal(a, b) for a, b in zip(info, info_g)))

    # The sharded checkpoint's round trip, and a changed layout.
    path = os.path.join(tempfile.gettempdir(), f"ckpt_{os.environ['TORCH_PARALLEL_TEST_ID']}")
    block = out["nuts"][0]
    tree = {"samples": DTensor.from_local(block, mesh, [Shard(1)], run_check=False),
            "step": torch.tensor(7), "scale": np.float64(0.25)}
    save_pytree_sharded(path, tree)
    like = {"samples": DTensor.from_local(torch.zeros_like(block), mesh, [Shard(1)],
                                          run_check=False),
            "step": torch.tensor(0), "scale": np.float64(0.0)}
    back = load_pytree_sharded(path, like)
    out["ckpt"] = (torch.equal(back["samples"].to_local(), block)
                   and isinstance(back["samples"], DTensor) and int(back["step"]) == 7
                   and float(back["scale"]) == 0.25)
    # The same placements on a mesh of the ranks in reverse order: every
    # rank's block belongs elsewhere.
    flipped = DeviceMesh("cpu", torch.arange(world).flip(0), mesh_dim_names=("chains",))
    moved = dict(like, samples=DTensor.from_local(torch.zeros_like(block), flipped, [Shard(1)],
                                                  run_check=False))
    out["ckpt_layout"] = world == 1 or raises(lambda: load_pytree_sharded(path, moved),
                                              "layout changed")
    wrong = dict(like, step=torch.zeros(3))
    out["ckpt_shape"] = raises(lambda: load_pytree_sharded(path, wrong), "shape")
    dist.barrier()
    os.remove(f"{path}.proc{rank}.npz")

    # The mesh rules on this group.
    out["mesh"] = (
        tuple(mesh.mesh_dim_names) == ("chains",) and mesh.size(0) == world,
        local_chunk(8 * world, mesh) == 8,
        raises(lambda: local_chunk(8 * world + 1, mesh), "evenly") if world > 1 else True,
        raises(lambda: make_mesh(axis_names=("a", "b"), axis_sizes=(world,), device="cpu"),
               "axis names"),
        raises(lambda: make_mesh(axis_names=("a", "b"), axis_sizes=(-1, -1), device="cpu"),
               "-1"),
        raises(lambda: make_mesh(axis_names=("a", "b"), axis_sizes=(3, 3), device="cpu"),
               "devices"),
        raises(lambda: make_mesh(axis_names=("a", "b"), axis_sizes=(-1, 3), device="cpu"),
               "divide"),
    )
    if world == 4:
        two_d = make_mesh(axis_names=("chains", "data"), axis_sizes=(-1, 2), device="cpu")
        sub = make_mesh(2, device="cpu")
        out["mesh_4"] = (two_d.size(0) == 2 and two_d.size(1) == 2
                         and two_d.mesh.flatten().tolist() == [0, 1, 2, 3],
                         sub.size(0) == 2)

    # The collectives and their adjoints: x_r = (r + 1) * v on rank r.
    group = pmesh.axis_group(mesh, "chains")
    v = torch.arange(1.0, 4.0, dtype=torch.float64)
    x = ((rank + 1) * v).requires_grad_()
    w = torch.arange(3 * world, dtype=torch.float64)
    checks = {
        "sum": (pmesh.group_sum(x, group), lambda s: torch.sum(s * (rank + 1))),
        "mean": (pmesh.group_mean(x, group), lambda s: torch.sum(s)),
        "gather": (pmesh.gather(x, group), lambda g: torch.sum(g * w)),
        "broadcast": (pmesh.broadcast(x, world - 1, group), lambda b: torch.sum(b * (rank + 1))),
        "replicate": (pmesh.replicate(x, group), lambda r: torch.sum(r * r)),
    }
    out["collectives"] = {
        k: (value.detach(), torch.autograd.grad(loss(value), x)[0]) for k, (value, loss) in
        checks.items()
    }
    out["collectives"]["max"] = pmesh.group_max(x, group)
    out["collectives"]["replicated_sum"] = torch.autograd.grad(
        pmesh.group_sum(x, group, replicated=True).sum(), x)[0]
    return out


SUITES = {"scan": suite_scan, "dense": suite_dense, "sharded": suite_sharded}


def main(argv) -> None:
    suite, rank, world, port, out = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    # A rank that hangs prints where, before the launcher kills it.
    faulthandler.dump_traceback_later(max(1.0, float(argv[5]) - 5.0), exit=True)
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from tinygp_tpu_torch.parallel import initialize_distributed

    os.environ["TORCH_PARALLEL_TEST_ID"] = f"{os.path.basename(out)}_{suite}_{world}"
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        result = SUITES[suite](rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out, f"{suite}.{world}.{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1:])
