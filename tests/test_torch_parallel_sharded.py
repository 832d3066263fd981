"""The port's sharded samplers, sharded checkpoint, mesh rules and
collectives, in gloo groups of 2 and 4 CPU processes
(``torch_parallel_ranks.py``, suite ``sharded``), against the
single-process samplers with the same seed, bit for bit, and
``tests/test_parallel/test_sharded.py``'s moments.
"""

import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks

from tinygp_tpu_torch import samplers
from tinygp_tpu_torch.parallel.mesh import _mesh_sizes

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both groups run while this process runs the single-process
    references with the same seeds."""
    groups = ranks.Groups("sharded", WORLDS, str(tmp_path_factory.mktemp("sharded")))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = {}
        for sampler, settings in ranks.MCMC_SETTINGS.items():
            samples, info = samplers.run_mcmc(0, ranks.gaussian_log_prob, ranks.GAUSSIAN_INIT,
                                              sampler=sampler, warmup_depth_cap=None,
                                              device="cpu", **settings)
            single[sampler] = (samples["x"], info.accept_prob, info.num_steps)
        single["smc"] = samplers.run_smc(2, ranks.gaussian_log_prior, ranks.gaussian_log_prob,
                                         ranks.smc_particles(), device="cpu")
        t, y = ranks.gp_posterior_data()
        single["gp"] = samplers.run_mcmc(0, ranks.gp_log_post(t, y), ranks.GP_INIT,
                                         warmup_depth_cap=None, device="cpu",
                                         **ranks.GP_SETTINGS)[0]
    finally:
        torch.set_num_threads(threads)
    return groups.wait(), single


def blocks(per_rank, key, dim):
    return torch.cat([r[key] if dim is None else r[key][dim] for r in per_rank], dim=1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("sampler", ["nuts", "hmc"])
def test_sharded_mcmc_is_the_single_run(results, world, sampler):
    """Each rank's chains are bit for bit its rows of ``run_mcmc`` with the
    same seed (samples, accept probabilities, steps)."""
    got, single = results
    for i, want in enumerate(single[sampler]):
        assert torch.equal(torch.cat([r[sampler][i] for r in got[world]], dim=1), want)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_mcmc_moments(results, world):
    """tests/test_parallel/test_sharded.py's moments, 32 chains, 300 + 300."""
    got, _ = results
    x = torch.cat([r["nuts"][0] for r in got[world]], dim=1)
    assert x.shape == (300, 32, 2)
    x = x.reshape(-1, 2).numpy()
    np.testing.assert_allclose(x.mean(0), ranks.MU, atol=0.1)
    np.testing.assert_allclose(x.std(0), ranks.SD, atol=0.15)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_gp_posterior_is_the_single_run(results, world):
    """The quasiseparable GP posterior: each rank's batched plain
    log-likelihood gives its chains the bits of one batch of all."""
    got, single = results
    for name in ("log_scale", "log_amp"):
        assert torch.equal(torch.cat([r["gp"][name] for r in got[world]], dim=1),
                           single["gp"][name])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_smc_is_the_single_run(results, world):
    got, single = results
    want = single["smc"]
    parts = torch.cat([r["smc"]["particles"]["x"] for r in got[world]])
    assert torch.equal(parts, want.particles["x"])
    for r in got[world]:
        for key in ("log_evidence", "betas", "acceptance"):
            torch.testing.assert_close(r["smc"][key], getattr(want, key), rtol=0, atol=0,
                                       equal_nan=True)
        assert int(r["smc"]["num_stages"]) == int(want.num_stages)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_smc_matches_analytic(results, world):
    """tests/test_parallel/test_sharded.py's limits, 2048 particles."""
    got, _ = results
    x = torch.cat([r["smc"]["particles"]["x"] for r in got[world]]).numpy()
    post_var = 1.0 / (1.0 / 16.0 + 1.0 / ranks.SD**2)
    post_mean = post_var * ranks.MU / ranks.SD**2
    np.testing.assert_allclose(x.mean(0), post_mean, atol=0.15)
    np.testing.assert_allclose(x.std(0), np.sqrt(post_var), atol=0.15)
    var_sum = 16.0 + ranks.SD**2
    log_z = np.sum(-0.5 * (ranks.MU**2 / var_sum + np.log(var_sum / ranks.SD**2)))
    np.testing.assert_allclose(float(got[world][0]["smc"]["log_evidence"]), log_z, atol=0.2)


@pytest.mark.parametrize("world", WORLDS)
def test_window_adaptation_with_a_group(results, world):
    """With the group, on each rank's block of 16 chains, 40 warmup steps
    end where they end without one on all 16 chains: states, step size,
    inverse mass and the warmup's diagnostics."""
    got, _ = results
    assert all(r["window"] for r in got[world])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_checkpoint(results, world):
    """The round trip of a chain-sharded ``DTensor`` leaf beside replicated
    ones; a template laid out otherwise (the ranks in reverse order) or of
    another shape raises."""
    got, _ = results
    for r in got[world]:
        assert r["ckpt"] and r["ckpt_layout"] and r["ckpt_shape"]


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_on_a_group(results, world):
    """make_mesh and local_chunk on the group: the default one axis, the
    size rules' errors, and at 4 ranks an inferred 2-D mesh and a mesh of
    the first 2 ranks."""
    got, _ = results
    for r in got[world]:
        assert all(r["mesh"])
        assert world != 4 or all(r["mesh_4"])


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_and_their_adjoints(results, world):
    """Rank r holds x_r = (r + 1) v and backpropagates its own loss; each
    gradient is that of the sum of the ranks' losses."""
    got, _ = results
    v = np.arange(1.0, 4.0)
    total = world * (world + 1) / 2
    for rank, r in enumerate(got[world]):
        c = {k: tuple(np.asarray(t) for t in val) if isinstance(val, tuple) else np.asarray(val)
             for k, val in r["collectives"].items()}
        np.testing.assert_array_equal(c["sum"][0], total * v)
        np.testing.assert_array_equal(c["sum"][1], np.full(3, total))
        np.testing.assert_array_equal(c["mean"][0], total / world * v)
        np.testing.assert_array_equal(c["mean"][1], np.ones(3))
        np.testing.assert_array_equal(c["gather"][0], np.concatenate([(k + 1) * v
                                                                      for k in range(world)]))
        np.testing.assert_array_equal(c["gather"][1], world * np.arange(3 * rank, 3 * rank + 3))
        np.testing.assert_array_equal(c["broadcast"][0], world * v)
        np.testing.assert_array_equal(c["broadcast"][1],
                                      np.full(3, total if rank == world - 1 else 0.0))
        np.testing.assert_array_equal(c["replicate"][1], 2 * total * v)
        np.testing.assert_array_equal(c["max"], world * v)
        np.testing.assert_array_equal(c["replicated_sum"], np.ones(3))


def test_mesh_size_rules():
    """tests/test_parallel/test_mesh.py's rules, on 8 ranks."""
    assert _mesh_sizes(8, ("chains",), None) == [8]
    assert _mesh_sizes(8, ("chains", "data"), None) == [8, 1]
    assert _mesh_sizes(8, ("chains", "data"), (2, 4)) == [2, 4]
    assert _mesh_sizes(8, ("chains", "data"), (-1, 2)) == [4, 2]
    with pytest.raises(ValueError, match="axis names"):
        _mesh_sizes(8, ("a", "b"), (8,))
    with pytest.raises(ValueError, match="-1"):
        _mesh_sizes(8, ("a", "b"), (-1, -1))
    with pytest.raises(ValueError, match="devices"):
        _mesh_sizes(8, ("a", "b"), (3, 3))
    with pytest.raises(ValueError, match="divide"):
        _mesh_sizes(8, ("a", "b"), (-1, 3))


def test_make_mesh_needs_a_group_and_the_card():
    from tinygp_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
