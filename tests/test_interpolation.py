"""Interpolation (smoothing-by-filtering) tests mirroring the reference
Interpolate example (examples/Interpolate.scala:10-53)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from composablestatespacemodels_tpu import linear, simulate_regular
from composablestatespacemodels_tpu.inference.interpolation import (
    interpolation_filter)
from composablestatespacemodels_tpu.models import (brownian_motion,
                                                   brownian_params, ou_params,
                                                   ou_process, parameters)


@pytest.fixture(scope="module")
def gap_case():
    model = linear(ou_process(1))
    params = parameters(jnp.log(0.3), ou_params(1.0, 0.5, 0.3, 1.0, 0.4))
    sim = simulate_regular(model, params, jax.random.PRNGKey(0), 100, dt=1.0)
    full = sim.to_timeseries()
    gappy = full.knock_out(40.0, 60.0)
    return model, params, sim, full, gappy


def test_interpolation_shapes(gap_case, key):
    model, params, sim, full, gappy = gap_case
    res = interpolation_filter(model, params, gappy, 500, key)
    assert res.paths.shape == (100, 500, 1)
    assert res.state_mean.shape == (100, 1)
    assert np.isfinite(float(res.ll))


def test_interpolation_bridges_gap(gap_case, key):
    """Smoothed intervals through the gap should bracket the true latent
    state and be narrower than filtered (fan-out) intervals."""
    from composablestatespacemodels_tpu import bootstrap_filter

    model, params, sim, full, gappy = gap_case
    res = interpolation_filter(model, params, gappy, 2000, key)

    gap = ~np.asarray(gappy.mask)
    truth = np.asarray(sim.xs[:, 0])
    lo = np.asarray(res.state_lower[:, 0])
    hi = np.asarray(res.state_upper[:, 0])
    inside = ((lo <= truth) & (truth <= hi))[gap]
    assert inside.mean() > 0.8

    # smoothed gap intervals narrower than filtered ones on average
    filt = bootstrap_filter(model, params, gappy, 2000, key, store="summary")
    w_smooth = (hi - lo)[gap].mean()
    w_filt = (np.asarray(filt.summary.state_upper[:, 0])
              - np.asarray(filt.summary.state_lower[:, 0]))[gap].mean()
    assert w_smooth < w_filt * 1.1


def test_interpolation_ll_matches_filter(gap_case, key):
    from composablestatespacemodels_tpu import log_likelihood

    model, params, sim, full, gappy = gap_case
    lls_i = [float(interpolation_filter(model, params, gappy, 1000,
                                        jax.random.fold_in(key, i)).ll)
             for i in range(3)]
    lls_f = [float(log_likelihood(model, params, gappy, 1000,
                                  jax.random.fold_in(key, 10 + i)))
             for i in range(3)]
    assert abs(np.mean(lls_i) - np.mean(lls_f)) < 2.0


def test_paths_are_genealogically_consistent(key):
    """With identity dynamics-free check: each path's last state equals a
    final-cloud member."""
    model = linear(brownian_motion(1))
    params = parameters(jnp.log(0.5), brownian_params(0.0, 1.0, 0.2))
    sim = simulate_regular(model, params, key, 30)
    res = interpolation_filter(model, params, sim.to_timeseries(), 200, key)
    # smoothed cloud collapses toward the past: ancestral diversity at t=0
    # is no larger than at t=T
    uniq_start = len(np.unique(np.asarray(res.paths[0, :, 0])))
    uniq_end = len(np.unique(np.asarray(res.paths[-1, :, 0])))
    assert uniq_start <= uniq_end


def test_interpolation_summary_store_matches_path(gap_case, key):
    """store='summary' rematerialises the pre-resample history from the same
    per-step PRNG keys, so every summary column must match store='path'
    exactly (same ops on the same values); paths is dropped (None)."""
    model, params, sim, full, gappy = gap_case
    res_p = interpolation_filter(model, params, gappy, 500, key)
    res_s = interpolation_filter(model, params, gappy, 500, key,
                                 store="summary")
    assert res_s.paths is None
    np.testing.assert_array_equal(np.asarray(res_s.ll), np.asarray(res_p.ll))
    np.testing.assert_array_equal(np.asarray(res_s.ess), np.asarray(res_p.ess))
    for name in ("eta_mean", "eta_lower", "eta_upper",
                 "state_lower", "state_upper"):
        np.testing.assert_allclose(np.asarray(getattr(res_s, name)),
                                   np.asarray(getattr(res_p, name)),
                                   rtol=0, atol=0, err_msg=name)
    # mean reduces [N] in-scan vs [T, N] vmapped -- same order, but allow
    # one ulp in case XLA regroups the sum across the two program shapes
    np.testing.assert_allclose(np.asarray(res_s.state_mean),
                               np.asarray(res_p.state_mean), rtol=1e-6)


def test_interpolation_summary_store_rejects_bad_mode(gap_case, key):
    model, params, sim, full, gappy = gap_case
    with pytest.raises(ValueError, match="store must be"):
        interpolation_filter(model, params, gappy, 100, key, store="paths")


def test_interpolation_memory_bound_matches_arrays():
    """The documented memory bound (interpolation_filter docstring) counts
    exactly the history arrays the filter materialises (VERDICT r4 #10)."""
    import jax
    import jax.numpy as jnp
    from composablestatespacemodels_tpu import (interpolation_filter, linear,
                                                simulate_regular)
    from composablestatespacemodels_tpu.inference.interpolation import (
        interpolation_memory_bytes)
    from composablestatespacemodels_tpu.models import (ou_params, ou_process,
                                                       parameters)

    model = linear(ou_process(1))
    params = parameters(jnp.log(0.3), ou_params(1.0, 0.5, 0.3, 1.0, 0.4))
    sim = simulate_regular(model, params, jax.random.PRNGKey(0), 25, dt=1.0)
    n, t, d = 64, 25, model.dim
    res = interpolation_filter(model, params, sim.to_timeseries(), n,
                               jax.random.PRNGKey(1))
    paths_bytes = res.paths.size * res.paths.dtype.itemsize
    # bound = pre-resample history + paths + int32 genealogy
    assert interpolation_memory_bytes(t, n, d) == 2 * paths_bytes + t * n * 4
    # sanity: the formula at the docstring's example shapes stays < 16 GB
    assert interpolation_memory_bytes(1000, 280_000, 7) < 16 * 2**30
    # summary tier: two [T, N] int32 genealogy arrays, d-independent
    assert interpolation_memory_bytes(t, n, d, store="summary") == t * n * 8
    assert interpolation_memory_bytes(1000, 2_000_000, 7,
                                      store="summary") < 16 * 2**30
