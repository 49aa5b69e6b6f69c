"""Bootstrap particle filter: Kalman cross-checks (the BASELINE.json
correctness gates), missing-data handling, irregular times, composed models."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from composablestatespacemodels_tpu import (
    TimeSeries, bootstrap_filter, kalman_filter, linear, log_likelihood,
    poisson, seasonal, simulate, simulate_regular)
from composablestatespacemodels_tpu.models import (
    branch, brownian_motion, brownian_params, leaf, ou_params, ou_process,
    param_node, parameters)


@pytest.fixture(scope="module")
def lg_case():
    """Linear-Gaussian model + simulated data + exact Kalman answer."""
    model = linear(brownian_motion(1))
    params = parameters(jnp.log(0.7), brownian_params(0.5, 0.25, 0.3))
    sim = simulate_regular(model, params, jax.random.PRNGKey(0), 120, dt=0.5)
    data = sim.to_timeseries()
    kf = kalman_filter(model, params, data)
    return model, params, data, kf


def test_pf_loglik_matches_kalman(lg_case):
    model, params, data, kf = lg_case
    keys = jax.random.split(jax.random.PRNGKey(7), 8)
    lls = jnp.stack([
        log_likelihood(model, params, data, 2000, k) for k in keys])
    # PF estimate unbiased: mean within a few MC standard errors
    assert abs(float(jnp.mean(lls) - kf.ll)) < 3.0 * float(jnp.std(lls)) + 0.5
    # and tight in relative terms
    np.testing.assert_allclose(jnp.mean(lls), kf.ll, rtol=0.02)


def test_pf_filtering_mean_matches_kalman(lg_case):
    model, params, data, kf = lg_case
    res = bootstrap_filter(model, params, data, 4000, jax.random.PRNGKey(3),
                           store="summary")
    pf_means = res.summary.state_mean[:, 0]
    kf_means = kf.means[:, 0]
    err = np.abs(np.asarray(pf_means - kf_means))
    kf_sd = np.sqrt(np.asarray(kf.covs[:, 0, 0]))
    # filtering means within a fraction of the posterior sd, on average
    assert (err / kf_sd).mean() < 0.15
    # credible intervals bracket the Kalman mean almost everywhere
    inside = ((np.asarray(res.summary.state_lower[:, 0]) <= kf_means)
              & (kf_means <= np.asarray(res.summary.state_upper[:, 0])))
    assert inside.mean() > 0.95


def test_missing_observations_propagate_only(lg_case):
    model, params, data, _ = lg_case
    data_missing = data.knock_out(20.0, 35.0)
    n_missing = int((~np.asarray(data_missing.mask)).sum())
    assert n_missing > 0
    res = bootstrap_filter(model, params, data_missing, 500,
                           jax.random.PRNGKey(1), store="summary")
    kf = kalman_filter(model, params, data_missing)
    np.testing.assert_allclose(res.ll, kf.ll, rtol=0.05)
    # intervals should widen during the gap
    width = (np.asarray(res.summary.state_upper[:, 0])
             - np.asarray(res.summary.state_lower[:, 0]))
    gap = ~np.asarray(data_missing.mask)
    assert width[gap].mean() > width[~gap].mean()


def test_irregular_times(key):
    model = linear(brownian_motion(1))
    params = parameters(jnp.log(0.5), brownian_params(0.0, 1.0, 0.4))
    ts = jnp.cumsum(jax.random.uniform(key, (80,), minval=0.05, maxval=1.5))
    sim = simulate(model, params, key, ts)
    data = sim.to_timeseries()
    kf = kalman_filter(model, params, data)
    lls = jnp.stack([
        log_likelihood(model, params, data, 2000, k)
        for k in jax.random.split(key, 6)])
    np.testing.assert_allclose(jnp.mean(lls), kf.ll, rtol=0.03)


def test_composed_seasonal_kalman_crosscheck(key):
    """Composed linear+seasonal (OU latent) vs exact Kalman -- the composed
    correctness gate from BASELINE.json."""
    model = linear(ou_process(1)) + seasonal(24, 2, ou_process(4))
    params = branch(
        leaf(param_node(jnp.log(0.5), ou_params(0.1, 0.5, 0.2, 0.5, 0.3))),
        leaf(param_node(None, ou_params(0.1, 0.5, 0.3, 0.2, 0.25))))
    sim = simulate_regular(model, params, key, 100, dt=1.0)
    data = sim.to_timeseries()
    kf = kalman_filter(model, params, data)
    lls = jnp.stack([
        log_likelihood(model, params, data, 3000, k)
        for k in jax.random.split(key, 6)])
    np.testing.assert_allclose(jnp.mean(lls), kf.ll, rtol=0.03)
    res = bootstrap_filter(model, params, data, 3000, key, store="summary")
    err = np.abs(np.asarray(res.summary.state_mean - kf.means))
    sd = np.sqrt(np.asarray(jnp.diagonal(kf.covs, axis1=1, axis2=2)))
    assert (err / sd).mean() < 0.25


def test_poisson_filter_runs(key):
    model = poisson(ou_process(1))
    params = parameters(None, ou_params(1.0, 0.5, 0.3, 1.0, 0.3))
    sim = simulate_regular(model, params, key, 200, dt=0.5)
    res = bootstrap_filter(model, params, sim.to_timeseries(), 1000, key,
                           store="summary")
    assert np.isfinite(float(res.ll))
    assert res.ess.shape == (200,)
    assert bool((res.ess >= 1).all())
    # filtering eta should track the true eta reasonably
    corr = np.corrcoef(np.asarray(res.summary.eta_mean),
                       np.asarray(sim.etas))[0, 1]
    assert corr > 0.5


def test_fixed_initial_state(key):
    model = linear(brownian_motion(1))
    params = parameters(jnp.log(0.5), brownian_params(0.0, 1.0, 0.4))
    sim = simulate_regular(model, params, key, 50)
    x0 = jnp.asarray([0.3])
    res = bootstrap_filter(model, params, sim.to_timeseries(), 200, key,
                           initial_state=x0, store="ll")
    assert np.isfinite(float(res.ll))


def test_store_path(key):
    model = linear(brownian_motion(1))
    params = parameters(jnp.log(0.5), brownian_params(0.0, 1.0, 0.4))
    sim = simulate_regular(model, params, key, 50)
    res = bootstrap_filter(model, params, sim.to_timeseries(), 100, key,
                           store="path")
    assert res.sampled_path.shape == (50, 1)


def test_resampling_schemes_agree(key):
    model = linear(brownian_motion(1))
    params = parameters(jnp.log(0.5), brownian_params(0.0, 1.0, 0.4))
    sim = simulate_regular(model, params, key, 60)
    data = sim.to_timeseries()
    kf = kalman_filter(model, params, data)
    for scheme in ["systematic", "stratified", "multinomial", "residual"]:
        lls = jnp.stack([
            log_likelihood(model, params, data, 1500, k, resample=scheme)
            for k in jax.random.split(jax.random.fold_in(key, hash(scheme) % 100), 4)])
        np.testing.assert_allclose(jnp.mean(lls), kf.ll, rtol=0.05)


def test_ess_threshold_adaptive(key):
    model = linear(brownian_motion(1))
    params = parameters(jnp.log(0.5), brownian_params(0.0, 1.0, 0.4))
    sim = simulate_regular(model, params, key, 60)
    data = sim.to_timeseries()
    kf = kalman_filter(model, params, data)
    lls = jnp.stack([
        log_likelihood(model, params, data, 2000, k, ess_threshold=0.5)
        for k in jax.random.split(key, 6)])
    np.testing.assert_allclose(jnp.mean(lls), kf.ll, rtol=0.05)


def test_ll_reproducible(key):
    model = linear(brownian_motion(1))
    params = parameters(jnp.log(0.5), brownian_params(0.0, 1.0, 0.4))
    sim = simulate_regular(model, params, key, 30)
    data = sim.to_timeseries()
    ll1 = log_likelihood(model, params, data, 300, key)
    ll2 = log_likelihood(model, params, data, 300, key)
    assert float(ll1) == float(ll2)


def test_filter_under_x64(key):
    """The filter runs under 64-bit mode (tolerance-critical workflows)."""
    from jax import enable_x64

    from composablestatespacemodels_tpu import (kalman_filter, linear,
                                                log_likelihood,
                                                simulate_regular)
    from composablestatespacemodels_tpu.models import (brownian_motion,
                                                       brownian_params,
                                                       parameters)

    with enable_x64():
        model = linear(brownian_motion(1))
        params = parameters(jnp.log(0.5), brownian_params(0.0, 1.0, 0.4))
        sim = simulate_regular(model, params, key, 40)
        data = sim.to_timeseries()
        kf = kalman_filter(model, params, data)
        ll = log_likelihood(model, params, data, 1000, key)
        assert ll.dtype == jnp.float64
        np.testing.assert_allclose(float(ll), float(kf.ll), rtol=0.05)


def test_ess_threshold_summary_unbiased(lg_case):
    """With ess_threshold, skipped resamples leave carried weights
    non-uniform; summaries must weight the cloud or they are biased
    (VERDICT r3 weak #1).  The weighted summary path must match Kalman
    filtering means as closely as the always-resample path does."""
    model, params, data, kf = lg_case
    res = bootstrap_filter(model, params, data, 4000, jax.random.PRNGKey(3),
                           store="summary", ess_threshold=0.5)
    # resampling must actually have been skipped for this test to bite
    assert int((np.asarray(res.ess) >= 0.5 * 4000).sum()) > 5
    pf_means = res.summary.state_mean[:, 0]
    kf_means = kf.means[:, 0]
    err = np.abs(np.asarray(pf_means - kf_means))
    kf_sd = np.sqrt(np.asarray(kf.covs[:, 0, 0]))
    assert (err / kf_sd).mean() < 0.15
    inside = ((np.asarray(res.summary.state_lower[:, 0]) <= kf_means)
              & (kf_means <= np.asarray(res.summary.state_upper[:, 0])))
    assert inside.mean() > 0.95


def test_ess_threshold_path_weighted(lg_case):
    """store='path' under ess_threshold samples the kept particle by
    weight (unweighted uniform sampling is biased off the filtering
    distribution when resamples are skipped)."""
    model, params, data, kf = lg_case
    paths = []
    for k in jax.random.split(jax.random.PRNGKey(11), 12):
        res = bootstrap_filter(model, params, data, 1500, k,
                               store="path", ess_threshold=0.5)
        paths.append(np.asarray(res.sampled_path[:, 0]))
    mean_path = np.mean(paths, axis=0)
    kf_means = np.asarray(kf.means[:, 0])
    kf_sd = np.sqrt(np.asarray(kf.covs[:, 0, 0]))
    # smoothed-path mean tracks the filtering mean loosely (sampled paths
    # have posterior spread; check no gross bias)
    assert (np.abs(mean_path - kf_means) / kf_sd).mean() < 1.0


def test_weighted_quantile_matches_unweighted_for_uniform(key):
    """weighted_quantile_bits with uniform weights reproduces
    kth_smallest_bits' order statistics at the equivalent levels, up to
    the documented float32 mass-sum rounding: the cumulative sum of j
    copies of 1/n can round across the j/n threshold, shifting the
    answer by at most ONE rank.  Assert within-one-rank, and exact rank
    recovery when the masses are exactly representable (n a power of 2)."""
    from composablestatespacemodels_tpu.inference.filter import (
        _interval_levels, _weighted_quantile_sorted)
    from composablestatespacemodels_tpu.ops.selection import (
        kth_smallest_bits, weighted_quantile_bits)

    def ranks_of(got, srt):
        # index of each returned value in the sorted row
        return np.asarray([[int(np.searchsorted(srt[c], got[c, q]))
                            for q in range(got.shape[1])]
                           for c in range(got.shape[0])])

    for n, exact in ((1024, True), (1000, False)):
        vals = jax.random.normal(key, (3, n), jnp.float32)
        wn = jnp.full((n,), 1.0 / n, jnp.float32)
        ps_s, ps_e = _interval_levels(n, 0.975)
        ps = jnp.asarray([list(ps_s)] * 2 + [list(ps_e)], jnp.float32)
        idx = int(n * 0.975)
        ks = np.asarray([[(n - idx - 1) % n, (idx - 1) % n]] * 2
                        + [[(n - idx) % n, min(idx, n - 1)]])
        srt = np.sort(np.asarray(vals), axis=1)
        for got in (np.asarray(weighted_quantile_bits(vals, wn, ps)),
                    np.asarray(_weighted_quantile_sorted(
                        vals, wn, [list(ps_s)] * 2 + [list(ps_e)]))):
            dr = ranks_of(got, srt) - ks
            if exact:
                # 1/1024 and its partial sums are exact in float32
                np.testing.assert_array_equal(dr, 0)
                np.testing.assert_array_equal(
                    got, np.asarray(kth_smallest_bits(
                        vals, jnp.asarray(ks, jnp.int32))))
            else:
                assert np.abs(dr).max() <= 1, dr


def test_weighted_quantile_nonuniform_exact(key):
    """Weighted quantiles against a numpy oracle on non-uniform weights,
    including zero weights and the p=1.0 edge."""
    from composablestatespacemodels_tpu.ops.selection import (
        weighted_quantile_bits)

    n = 257
    vals = jax.random.normal(key, (1, n), jnp.float32)
    w = jax.random.uniform(jax.random.fold_in(key, 1), (n,), jnp.float32)
    w = w.at[jnp.argmax(vals[0])].set(0.0)     # zero-weight maximum
    w = w / jnp.sum(w)
    ps = jnp.asarray([[0.25, 0.5, 0.9, 1.0]], jnp.float32)

    v = np.asarray(vals[0], np.float64)
    wn = np.asarray(w, np.float64)
    order = np.argsort(v)
    cum = np.cumsum(wn[order])
    got = np.asarray(weighted_quantile_bits(vals, w, ps))[0]
    for j, p in enumerate([0.25, 0.5, 0.9, 1.0]):
        i = int(np.searchsorted(cum, p * cum[-1] * (1 - 1e-9)))
        i = min(i, n - 1)
        want = v[order][i]
        assert abs(got[j] - want) < 1e-5, (p, got[j], want)
    # p=1.0 with a zero-weight max: largest positive-weight value
    pos = v[order][wn[order] > 0]
    assert got[3] == np.float32(pos[-1])


@pytest.mark.parametrize("store", ["summary", "path", "ll"])
@pytest.mark.parametrize("scheme", ["systematic", "stratified",
                                    "multinomial", "residual"])
def test_scheme_and_store_match_kalman(lg_case, scheme, store):
    """Every resampling scheme under every store mode agrees with the
    exact Kalman filter: the log-likelihood within 3 MC sd (sd of one
    estimate over 4 seeds), plus the store's own output."""
    model, params, data, kf = lg_case
    keys = jax.random.split(jax.random.PRNGKey(11), 4)
    res = jax.vmap(lambda k: bootstrap_filter(
        model, params, data, 2000, k, resample=scheme, store=store))(keys)
    lls = np.asarray(res.ll)
    assert abs(lls.mean() - float(kf.ll)) < 3.0 * lls.std(ddof=1) + 0.05
    kf_mean = np.asarray(kf.means[:, 0])
    kf_sd = np.sqrt(np.asarray(kf.covs[:, 0, 0]))
    if store == "summary":
        err = np.abs(np.asarray(res.summary.state_mean[0, :, 0]) - kf_mean)
        assert (err / kf_sd).mean() < 0.15
    elif store == "path":
        # one particle per step from the filtering distribution: about
        # E|N(0, 1)| = 0.8 posterior sd from the Kalman mean on average
        z = np.abs(np.asarray(res.sampled_path[:, :, 0]) - kf_mean) / kf_sd
        assert res.sampled_path.shape == (4, data.ts.shape[0], 1)
        assert 0.4 < z.mean() < 1.3, z.mean()
    else:
        assert res.summary is None and res.sampled_path is None


# the scheme names of the retired kernel tier, e.g. 'systematic-' + 'pallas'
_RETIRED = [f"{s}-{k}" for s, k in (("systematic", "pallas"),
                                    ("stratified", "pallas"),
                                    ("systematic", "pallas-fused"))]


@pytest.mark.parametrize("entry", ["bootstrap_filter", "mesh", "lgcp"])
@pytest.mark.parametrize("name", _RETIRED)
def test_removed_scheme_names_raise(lg_case, name, entry):
    """Scheme names of the retired kernel tier are unknown names: the
    ValueError lists the valid schemes."""
    from composablestatespacemodels_tpu import lgcp_filter
    from composablestatespacemodels_tpu.parallel import particle_mesh

    model, params, data, _ = lg_case
    with pytest.raises(ValueError, match="choose from") as err:
        if entry == "lgcp":
            lgcp_filter(model, params, data, 64, jax.random.PRNGKey(0),
                        resample=name)
        else:
            bootstrap_filter(model, params, data, 64, jax.random.PRNGKey(0),
                             resample=name,
                             mesh=particle_mesh() if entry == "mesh" else None)
    for valid in ("systematic", "stratified", "multinomial", "residual"):
        assert valid in str(err.value)
