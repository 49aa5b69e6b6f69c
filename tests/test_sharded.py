"""Multi-chip sharding tests on the virtual 8-device CPU mesh (conftest).

Validates: sharded PF ll matches the single-device filter statistically,
shard-count invariance of the resampling positions, and chain-parallel PMMH.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from composablestatespacemodels_tpu import (kalman_filter, linear,
                                            log_likelihood, poisson,
                                            simulate_regular)
from composablestatespacemodels_tpu.models import (brownian_motion,
                                                   brownian_params, leaf,
                                                   ou_params, ou_process,
                                                   param_node, parameters,
                                                   perturb, seasonal, branch)
from composablestatespacemodels_tpu.parallel import (
    CHAIN_AXIS, PARTICLE_AXIS, make_mesh, particle_mesh,
    sharded_log_likelihood, sharded_pmmh)


@pytest.fixture(scope="module")
def lg_case():
    model = linear(brownian_motion(1))
    params = parameters(jnp.log(0.5), brownian_params(0.2, 0.25, 0.3))
    sim = simulate_regular(model, params, jax.random.PRNGKey(0), 60, dt=0.5)
    return model, params, sim.to_timeseries()


def test_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_ll_matches_kalman(lg_case, key):
    model, params, data, = lg_case
    mesh = particle_mesh()
    kf = kalman_filter(model, params, data)
    lls = [float(sharded_log_likelihood(model, params, data, 2048,
                                        jax.random.fold_in(key, i), mesh)[0])
           for i in range(5)]
    np.testing.assert_allclose(np.mean(lls), float(kf.ll), rtol=0.03)


def test_sharded_ll_composed_model(key):
    model = poisson(ou_process(1)) + seasonal(24, 2, ou_process(4))
    params = branch(
        leaf(param_node(None, ou_params(1.0, 0.2, 0.3, 1.0, 0.3))),
        leaf(param_node(None, ou_params(0.2, 0.2, 0.3, 0.2, 0.2))))
    sim = simulate_regular(model, params, key, 50, dt=1.0)
    data = sim.to_timeseries()
    mesh = particle_mesh()
    ll, ll_hist, ess, xf = sharded_log_likelihood(model, params, data, 1024,
                                                  key, mesh)
    assert np.isfinite(float(ll))
    assert ll_hist.shape == (50,)
    assert xf.shape == (1024, 5)
    # compare against single-device filter (statistically)
    lls_single = [float(log_likelihood(model, params, data, 1024,
                                       jax.random.fold_in(key, i)))
                  for i in range(4)]
    lls_shard = [float(sharded_log_likelihood(
        model, params, data, 1024, jax.random.fold_in(key, 10 + i), mesh)[0])
        for i in range(4)]
    assert abs(np.mean(lls_single) - np.mean(lls_shard)) < 3.0


def test_sharded_ess_bounds(lg_case, key):
    model, params, data = lg_case
    mesh = particle_mesh()
    _, _, ess, _ = sharded_log_likelihood(model, params, data, 512, key, mesh)
    assert bool((ess >= 1).all()) and bool((ess <= 512).all())


def test_mesh_shapes():
    m = make_mesh(2, 4)
    assert m.shape[CHAIN_AXIS] == 2
    assert m.shape[PARTICLE_AXIS] == 4
    with pytest.raises(ValueError):
        make_mesh(3, 3)


def test_sharded_pmmh_chains(lg_case, key):
    model, params, data = lg_case
    mesh = make_mesh(2, 4)
    res = sharded_pmmh(model, params, data, 256, key, 50, mesh,
                       proposal=perturb(0.01))
    assert res.lls.shape == (2, 50)
    assert res.accepted.shape == (2, 50)
    assert bool(jnp.isfinite(res.lls).all())
    # chains evolve independently
    assert float(jnp.abs(res.lls[0] - res.lls[1]).max()) > 0
    rates = np.asarray(res.acceptance_rate())
    assert (rates > 0).all()


def test_sharded_pf_not_divisible_raises(lg_case, key):
    model, params, data = lg_case
    mesh = particle_mesh()
    with pytest.raises(ValueError):
        sharded_log_likelihood(model, params, data, 1000 + 3, key, mesh)


# ---------------------------------------------------------------------------
# distributed (no-all-gather) systematic resampling -- SURVEY 5.8 option ii
# ---------------------------------------------------------------------------

from jax import shard_map
from jax.sharding import PartitionSpec as P

from composablestatespacemodels_tpu.inference.resampling import (
    systematic_indices)
from composablestatespacemodels_tpu.parallel import (
    distributed_systematic_resample, sharded_bootstrap_filter)
from composablestatespacemodels_tpu.parallel.sharded_filter import (
    _kth_smallest_sharded)


def _run_distributed(x, w, key, mesh):
    fn = shard_map(
        lambda xs, ws: distributed_systematic_resample(
            xs, ws, key, PARTICLE_AXIS),
        mesh=mesh,
        in_specs=(P(PARTICLE_AXIS), P(PARTICLE_AXIS)),
        out_specs=P(PARTICLE_AXIS),
        check_vma=False)
    return fn(x, w)


def _dyadic_weights(key, n, pow2_total=True):
    """Weights that are exact in float32 under ANY summation order: small
    integer multiples of 1/256, adjusted so the total is a power of two
    (making the normalisation division exact too) -- any fp discrepancy
    between the single-device scan and the shard-hierarchical scan would
    change the counts, so the bit-exact comparisons below are meaningful."""
    ints = jax.random.randint(key, (n,), 1, 200)  # headroom so the final
    # adjustment below stays positive for any n
    target = 1 << (int(np.ceil(np.log2(n * 128))))
    ints = ints.at[-1].add(target - jnp.sum(ints))
    assert int(jnp.sum(ints)) == target and int(jnp.min(ints)) > 0
    return ints.astype(jnp.float32) / 256.0


def test_distributed_resample_bit_exact_vs_single_device(key):
    mesh = particle_mesh()
    n, d = 1024, 3
    w = _dyadic_weights(key, n)
    x = jax.random.normal(jax.random.fold_in(key, 1), (n, d))
    got = _run_distributed(x, w, key, mesh)
    want = x[systematic_indices(key, w)]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_distributed_resample_degenerate_multi_hop(key):
    """All offspring concentrated on one shard forces the ppermute ring to
    run multiple hops; every placement must still match single-device."""
    mesh = particle_mesh()
    n, d = 512, 2
    x = jax.random.normal(key, (n, d))
    for j in [0, 5, n // 2 + 3, n - 1]:   # incl. first and last shard
        w = jnp.zeros((n,), jnp.float32).at[j].set(1.0)
        got = _run_distributed(x, w, key, mesh)
        want = x[systematic_indices(key, w)]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # two owners on distant shards
    w = jnp.zeros((n,), jnp.float32).at[3].set(0.5).at[n - 7].set(0.5)
    got = _run_distributed(x, w, key, mesh)
    want = x[systematic_indices(key, w)]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_distributed_resample_uniform_weights_is_identity(key):
    """Uniform weights + systematic resampling keep every particle once;
    the common fast case should finish on the first hop (all local)."""
    mesh = particle_mesh()
    n, d = 256, 4
    x = jax.random.normal(key, (n, d))
    w = jnp.full((n,), 1.0 / n)
    got = _run_distributed(x, w, key, mesh)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(x))


def test_no_particle_all_gather_in_distributed_hot_path(lg_case, key):
    """The compiled distributed filter must contain no all-gather of the
    [N, d] particle block: the only all-gather operand allowed is the
    [n_shards] vector of per-shard weight sums."""
    model, params, data = lg_case
    mesh = particle_mesh()
    from composablestatespacemodels_tpu.parallel.sharded_filter import (
        _sharded_filter_impl)
    n = 2048
    t0v = data.ts[0]
    lowered = _sharded_filter_impl.lower(
        model, params, data, n, key, None, t0v, mesh, PARTICLE_AXIS,
        "ll", None, 0.975, "distributed", False)
    hlo = lowered.as_text()
    import re
    for m in re.finditer(r'"?all-gather"?[^\n]*', hlo):
        line = m.group(0)
        # operand shapes appear as f32[<elems>] on the all-gather line;
        # anything particle-sized means the cloud is being gathered
        for shape in re.findall(r"f32\[([0-9,]+)\]", line):
            elems = int(np.prod([int(s) for s in shape.split(",")]))
            assert elems <= 64, f"particle-sized all-gather found: {line}"


def test_kth_smallest_sharded_matches_sort(key):
    mesh = particle_mesh()
    c, n = 5, 2048
    vals = jax.random.normal(key, (c, n)) * 10.0   # includes negatives
    ks = jax.random.randint(jax.random.fold_in(key, 1), (c, 2), 0, n)
    fn = shard_map(
        lambda v, k: _kth_smallest_sharded(v, k, PARTICLE_AXIS),
        mesh=mesh,
        in_specs=(P(None, PARTICLE_AXIS), P()),
        out_specs=P(),
        check_vma=False)
    got = fn(vals, ks)
    srt = np.sort(np.asarray(vals), axis=1)
    want = np.take_along_axis(srt, np.asarray(ks), axis=1)
    np.testing.assert_array_equal(np.asarray(got), want)


# ---------------------------------------------------------------------------
# sharded filter feature parity with the single-device API
# ---------------------------------------------------------------------------


def test_sharded_filter_store_summary_matches_single_device(lg_case, key):
    """Sharded summaries (distributed order statistics) vs the single-device
    sort-based summaries: same model/data, independent RNG -> statistical
    agreement of the filtering means and interval widths."""
    from composablestatespacemodels_tpu import bootstrap_filter

    model, params, data = lg_case
    mesh = particle_mesh()
    n = 4096
    res_s = bootstrap_filter(model, params, data, n, key, store="summary")
    res_m = bootstrap_filter(model, params, data, n,
                             jax.random.fold_in(key, 1), store="summary",
                             mesh=mesh)
    assert res_m.summary is not None
    a, b = res_s.summary, res_m.summary
    np.testing.assert_allclose(np.asarray(a.state_mean),
                               np.asarray(b.state_mean), atol=0.12)
    np.testing.assert_allclose(np.asarray(a.eta_mean),
                               np.asarray(b.eta_mean), atol=0.12)
    # interval bounds bracket the mean and agree statistically
    assert bool((b.state_lower <= b.state_mean).all())
    assert bool((b.state_mean <= b.state_upper).all())
    np.testing.assert_allclose(np.asarray(a.state_upper),
                               np.asarray(b.state_upper), atol=0.3)
    np.testing.assert_allclose(np.asarray(a.state_lower),
                               np.asarray(b.state_lower), atol=0.3)


def test_sharded_filter_store_path_and_initial_state(lg_case, key):
    from composablestatespacemodels_tpu import bootstrap_filter

    model, params, data = lg_case
    mesh = particle_mesh()
    T = data.ts.shape[0]
    # FilterInit: fixed [d] start (ParticleFilter.scala:252-271)
    res = bootstrap_filter(model, params, data, 512, key, store="path",
                           initial_state=jnp.asarray([0.3]), mesh=mesh)
    assert res.sampled_path.shape == (T, 1)
    assert bool(jnp.isfinite(res.sampled_path).all())
    assert bool(jnp.isfinite(res.ll))
    # full [N, d] initial cloud, sharded over the mesh
    cloud = jax.random.normal(key, (512, 1)) * 0.1
    res2 = bootstrap_filter(model, params, data, 512, key, store="ll",
                            initial_state=cloud, mesh=mesh)
    assert bool(jnp.isfinite(res2.ll))


def test_sharded_filter_ess_threshold(lg_case, key):
    from composablestatespacemodels_tpu import bootstrap_filter

    model, params, data = lg_case
    mesh = particle_mesh()
    n = 2048
    res = bootstrap_filter(model, params, data, n, key, store="ll",
                           ess_threshold=0.5, mesh=mesh)
    res_always = bootstrap_filter(model, params, data, n,
                                  jax.random.fold_in(key, 1), store="ll",
                                  mesh=mesh)
    # the trigger must actually skip resamples, and the ll stays unbiased
    assert int(jnp.max(res.ess)) > n // 2
    assert abs(float(res.ll) - float(res_always.ll)) < 3.0
    # single-device with the same trigger agrees statistically
    res_1dev = bootstrap_filter(model, params, data, n,
                                jax.random.fold_in(key, 2), store="ll",
                                ess_threshold=0.5)
    assert abs(float(res.ll) - float(res_1dev.ll)) < 3.0


def test_sharded_distributed_matches_allgather(lg_case, key):
    """The distributed ring resampler and the round-1 all-gather baseline
    implement the same global systematic scheme."""
    model, params, data = lg_case
    mesh = particle_mesh()
    lls_d = [float(sharded_log_likelihood(
        model, params, data, 1024, jax.random.fold_in(key, i), mesh,
        resample_comm="distributed")[0]) for i in range(4)]
    lls_a = [float(sharded_log_likelihood(
        model, params, data, 1024, jax.random.fold_in(key, 10 + i), mesh,
        resample_comm="allgather")[0]) for i in range(4)]
    assert abs(np.mean(lls_d) - np.mean(lls_a)) < 2.0


def test_mesh_front_door_requires_systematic(lg_case, key):
    from composablestatespacemodels_tpu import bootstrap_filter

    model, params, data = lg_case
    mesh = particle_mesh()
    with pytest.raises(ValueError, match="systematic"):
        bootstrap_filter(model, params, data, 512, key,
                         resample="stratified", mesh=mesh)


# ---------------------------------------------------------------------------
# transposed [d, local_n] sharded layout
# ---------------------------------------------------------------------------

from composablestatespacemodels_tpu.parallel.sharded_filter import (
    distributed_systematic_resample_t)


def _run_distributed_t(x_t, w, key, mesh):
    fn = shard_map(
        lambda xs, ws: distributed_systematic_resample_t(
            xs, ws, key, PARTICLE_AXIS),
        mesh=mesh,
        in_specs=(P(None, PARTICLE_AXIS), P(PARTICLE_AXIS)),
        out_specs=P(None, PARTICLE_AXIS),
        check_vma=False)
    return fn(x_t, w)


def test_distributed_resample_t_bit_exact(key):
    """Transposed ring resampler (searchsorted fill) vs single-device."""
    mesh = particle_mesh()
    n, d = 1024, 3
    w = _dyadic_weights(key, n)
    x = jax.random.normal(jax.random.fold_in(key, 1), (n, d))
    got = _run_distributed_t(x.T, w, key, mesh)
    want = x[systematic_indices(key, w)]
    np.testing.assert_array_equal(np.asarray(got.T), np.asarray(want))


def test_sharded_filter_transposed_matches_flat(lg_case, key):
    """The transposed sharded scan must reproduce the flat sharded scan
    exactly on a d=1 model (identical noise layouts for d=1)."""
    model, params, data = lg_case
    mesh = particle_mesh()
    n = 2048
    flat = sharded_bootstrap_filter(model, params, data, n, key, mesh,
                                    store="ll", transposed=False)
    tr = sharded_bootstrap_filter(model, params, data, n, key, mesh,
                                  store="ll", transposed=True)
    np.testing.assert_allclose(float(tr.ll), float(flat.ll), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(tr.ess), np.asarray(flat.ess))
    np.testing.assert_array_equal(np.asarray(tr.final_particles),
                                  np.asarray(flat.final_particles))


def test_sharded_filter_transposed_summary_and_path(lg_case, key):
    model, params, data = lg_case
    mesh = particle_mesh()
    n = 2048
    flat = sharded_bootstrap_filter(model, params, data, n, key, mesh,
                                    store="summary", transposed=False)
    tr = sharded_bootstrap_filter(model, params, data, n, key, mesh,
                                  store="summary", transposed=True)
    np.testing.assert_array_equal(np.asarray(tr.summary.state_lower),
                                  np.asarray(flat.summary.state_lower))
    np.testing.assert_array_equal(np.asarray(tr.summary.eta_upper),
                                  np.asarray(flat.summary.eta_upper))
    np.testing.assert_allclose(np.asarray(tr.summary.state_mean),
                               np.asarray(flat.summary.state_mean),
                               rtol=2e-5, atol=1e-6)
    p = sharded_bootstrap_filter(model, params, data, n, key, mesh,
                                 store="path", transposed=True)
    assert p.sampled_path.shape == (data.ts.shape[0], model.dim)
    assert np.isfinite(np.asarray(p.sampled_path)).all()


def test_forecast_from_sharded_cloud(lg_case, key):
    """The sharded filter's final cloud feeds the forecasting API directly
    (the arrays keep their device sharding; XLA inserts the collectives)."""
    from composablestatespacemodels_tpu.inference.filter import (forecast,
                                                                 forecast_times)

    model, params, data = lg_case
    mesh = particle_mesh()
    res = sharded_bootstrap_filter(model, params, data, 1024, key, mesh,
                                   store="ll")
    t_last = float(data.ts[-1])
    f = forecast(model, params, res.final_particles, t_last, t_last + 1.0,
                 key)
    assert np.isfinite(float(f.obs_mean))
    assert float(f.state_lower[0]) <= float(f.state_upper[0])
    fs = forecast_times(model, params, res.final_particles, t_last,
                        jnp.arange(1.0, 4.0) + t_last, key)
    assert fs.obs_mean.shape == (3,)
    assert np.isfinite(np.asarray(fs.obs_mean)).all()


def test_allgather_resample_heavy_tail_matches_indices(key):
    """The all-gather cross-check baseline must apply the same monotone
    guard as every other count-based path (review finding)."""
    from composablestatespacemodels_tpu.parallel.sharded_filter import (
        _all_gather_systematic_resample)

    mesh = particle_mesh()
    n, d = 1024, 2
    w = jax.random.exponential(key, (n,)) ** 4
    x = jax.random.normal(key, (n, d))
    fn = shard_map(
        lambda xs, ws: _all_gather_systematic_resample(
            xs, ws, key, PARTICLE_AXIS),
        mesh=mesh,
        in_specs=(P(PARTICLE_AXIS), P(PARTICLE_AXIS)),
        out_specs=P(PARTICLE_AXIS),
        check_vma=False)
    got = fn(x, w)
    want = x[systematic_indices(key, w)]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sharded_pmmh_transposed(lg_case, key):
    """Chain-parallel PMMH with the transposed per-chain filter."""
    model, params, data = lg_case
    mesh = make_mesh(2, 4)
    res = sharded_pmmh(model, params, data, 256, key, 20, mesh,
                       proposal=perturb(0.01), transposed=True)
    assert res.lls.shape == (2, 20)
    assert bool(jnp.isfinite(res.lls).all())
    rates = np.asarray(res.acceptance_rate())
    assert (rates > 0).all()


def test_sharded_pmmh_approx(lg_case, key):
    """ApproxPMMH over the mesh (PMMH.scala:128-153): the current
    parameters' ll is refreshed every iteration, so accepted lls change
    even on rejections (doubly-stochastic chain)."""
    from composablestatespacemodels_tpu.parallel import sharded_pmmh

    model, params, data = lg_case
    mesh = make_mesh(2, 4)
    res = sharded_pmmh(model, params, data, 256, key, 40, mesh,
                       proposal=perturb(0.01), approx=True)
    assert res.lls.shape == (2, 40)
    assert bool(jnp.isfinite(res.lls).all())
    # in approx mode consecutive lls differ even without acceptance
    # (refreshed estimate): with a tiny proposal some iterations reject,
    # yet no two consecutive lls should be bit-identical
    lls = np.asarray(res.lls)
    assert (np.abs(np.diff(lls, axis=1)) > 0).mean() > 0.9


def test_sharded_pmmh_resume_matches_monitored(tmp_path, lg_case, key):
    """Chunked mesh chains with checkpoint/resume return the FULL
    [n_chains, n_iters] chain, bit-consistent across the resume seam
    (mesh tier of utils.streaming.pmmh_monitored)."""
    from composablestatespacemodels_tpu.parallel import (
        sharded_pmmh_monitored)

    model, params, data = lg_case
    mesh = make_mesh(2, 4)
    path = str(tmp_path / "mesh_chain.npz")
    res1 = sharded_pmmh_monitored(key, model, params, data, 256, 40, mesh,
                                  proposal=perturb(0.01), chunk_size=20,
                                  checkpoint_path=path, log_every=False)
    assert res1.lls.shape == (2, 40)
    res2 = sharded_pmmh_monitored(key, model, params, data, 256, 60, mesh,
                                  proposal=perturb(0.01), chunk_size=20,
                                  checkpoint_path=path, log_every=False)
    assert res2.lls.shape == (2, 60)
    np.testing.assert_allclose(np.asarray(res2.lls[:, :40]),
                               np.asarray(res1.lls), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(res2.accepted[:, :40]),
                                  np.asarray(res1.accepted))
    # cumulative acceptance nondecreasing across the seam, per chain
    assert np.all(np.diff(np.asarray(res2.accepted), axis=1) >= 0)


def test_sharded_adaptive_pmmh_recovers(lg_case, key):
    """Adaptive two-phase mesh PMMH drives the observation-noise scale
    to its posterior (8-device CPU mesh; VERDICT r3 #8 'done' gate)."""
    from composablestatespacemodels_tpu.parallel import (
        sharded_adaptive_pmmh)

    model, params, data = lg_case
    mesh = make_mesh(2, 4)
    res, pilot = sharded_adaptive_pmmh(
        model, params, data, 256, key, 120, mesh,
        pilot_iters=80, pilot_delta=0.05, return_pilot=True)
    assert pilot.lls.shape == (2, 80)
    assert res.lls.shape == (2, 120)
    assert bool(jnp.isfinite(res.lls).all())
    # main chains move (nonzero acceptance with the adapted proposal)
    rates = np.asarray(res.acceptance_rate())
    assert (rates > 0).all(), rates
    # posterior recovery: the (log) observation scale stays near truth
    kept = res.thin(burn_in=40)
    v = np.asarray(jax.tree_util.tree_leaves(kept.params)[0])
    truth = float(jnp.log(0.5))
    assert abs(np.mean(v) - truth) < 0.5, (np.mean(v), truth)


def test_sharded_pmmh_store_state_joint_draws(lg_case, key):
    """store_state on the mesh tier: each chain carries one latent state
    sampled from the final GLOBAL resampled cloud (psum-gathered across
    particle shards), and the paired (params, state) draws feed
    forecast_from_posterior (VERDICT r4 #4 'done' gate; reference
    MetropState PMMH.scala:26 / SimulateData.forecast Data.scala:202-217).
    """
    from composablestatespacemodels_tpu import forecast_from_posterior

    model, params, data = lg_case
    mesh = make_mesh(2, 4)
    res = sharded_pmmh(model, params, data, 256, key, 40, mesh,
                       proposal=perturb(0.02), store_state=True)
    assert res.states.shape == (2, 40, model.dim)
    assert bool(jnp.isfinite(res.states).all())
    # states move with the chain (not stuck at the zeros seed)
    assert float(jnp.abs(jnp.diff(res.states[:, :, 0], axis=1)).max()) > 0
    # plausible filtering states for this series
    lo, hi = float(data.ys.min()) - 3.0, float(data.ys.max()) + 3.0
    assert float(res.states.min()) > lo and float(res.states.max()) < hi

    # joint-pairing consumption: one chain's draws drive the forecast
    kept = res.thin(burn_in=10)
    chain0 = jax.tree_util.tree_map(lambda x: x[0], kept.params)
    t_last = float(data.ts[-1])
    fc = forecast_from_posterior(model, chain0, key, t_last,
                                 [t_last + 0.5, t_last + 1.0], 16,
                                 state_samples=kept.states[0])
    assert fc.obs_mean.shape == (2,)
    assert bool(jnp.isfinite(fc.obs_mean).all())
    assert bool((fc.state_lower <= fc.state_upper).all())


def test_sharded_pmmh_monitored_store_state_resume(tmp_path, lg_case, key):
    """Chunked mesh chains checkpoint the latent carry too: a resumed run
    reproduces the uninterrupted chain's states bit-for-bit."""
    from composablestatespacemodels_tpu.parallel import (
        sharded_pmmh_monitored)

    model, params, data = lg_case
    mesh = make_mesh(2, 4)
    ckpt = str(tmp_path / "mesh_state")
    res1 = sharded_pmmh_monitored(key, model, params, data, 256, 40, mesh,
                                  proposal=perturb(0.02), chunk_size=20,
                                  store_state=True, log_every=False)
    res2 = sharded_pmmh_monitored(key, model, params, data, 256, 20, mesh,
                                  proposal=perturb(0.02), chunk_size=20,
                                  store_state=True, log_every=False,
                                  checkpoint_path=ckpt)
    res3 = sharded_pmmh_monitored(key, model, params, data, 256, 40, mesh,
                                  proposal=perturb(0.02), chunk_size=20,
                                  store_state=True, log_every=False,
                                  checkpoint_path=ckpt)
    assert res3.states.shape == (2, 40, model.dim)
    np.testing.assert_array_equal(np.asarray(res3.states),
                                  np.asarray(res1.states))
    np.testing.assert_array_equal(np.asarray(res3.lls), np.asarray(res1.lls))
    np.testing.assert_array_equal(np.asarray(res3.states[:, :20]),
                                  np.asarray(res2.states))


def test_sharded_store_state_checkpoint_resumed_without_flag(lg_case, key):
    """A mesh store_state checkpoint resumed with the flag off drops the
    latent carry instead of dying in a tree_map TypeError (round-5
    review finding)."""
    model, params, data = lg_case
    mesh = make_mesh(2, 4)
    res, fin = sharded_pmmh(model, params, data, 256, key, 10, mesh,
                            proposal=perturb(0.02), store_state=True,
                            return_state=True)
    assert res.states.shape == (2, 10, model.dim)
    cont = sharded_pmmh(model, params, data, 256, key, 5, mesh,
                        proposal=perturb(0.02), init_state=fin)
    assert cont.states is None
    assert bool(jnp.isfinite(cont.lls).all())
