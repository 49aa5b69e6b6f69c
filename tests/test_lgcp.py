"""LGCP simulation (thinning) + fine-grid filter (BASELINE.json config 5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from composablestatespacemodels_tpu import lgcp, simulate_lgcp
from composablestatespacemodels_tpu.inference.lgcp import lgcp_filter
from composablestatespacemodels_tpu.models import (brownian_motion,
                                                   brownian_params,
                                                   gen_brownian_motion,
                                                   gen_brownian_params, leaf,
                                                   param_node, parameters)
from composablestatespacemodels_tpu.utils.data import TimeSeries


@pytest.fixture(scope="module")
def lgcp_model():
    model = lgcp(brownian_motion(1))
    params = parameters(None, brownian_params(1.0, 0.05, 0.05))
    return model, params


def test_simulate_lgcp_produces_events(lgcp_model):
    model, params = lgcp_model
    events, grid = simulate_lgcp(model, params, jax.random.PRNGKey(2),
                                 0.0, 5.0, precision=2)
    assert len(events) > 0
    ts = np.asarray(events.ts)
    assert (ts >= 0).all() and (ts <= 5.0).all()
    assert (np.diff(ts) > 0).all()  # strictly increasing event times
    assert np.asarray(events.ys).min() == 1.0
    # grid covers [0, 5] at step 0.01
    assert abs(float(grid.ts[0])) < 1e-6
    assert len(grid) >= 500


def test_lgcp_event_rate_tracks_intensity():
    """Higher latent intensity => more events."""
    model = lgcp(brownian_motion(1))
    lo = parameters(None, brownian_params(0.0, 0.01, 0.01))
    hi = parameters(None, brownian_params(2.0, 0.01, 0.01))
    ev_lo, _ = simulate_lgcp(model, lo, jax.random.PRNGKey(3), 0.0, 10.0, 2)
    ev_hi, _ = simulate_lgcp(model, hi, jax.random.PRNGKey(3), 0.0, 10.0, 2)
    # rates ~ exp(0)=1/unit vs exp(2)~7.4/unit
    assert len(ev_hi) > len(ev_lo)


def test_lgcp_filter_runs(lgcp_model, key):
    model, params = lgcp_model
    events, _ = simulate_lgcp(model, params, key, 0.0, 4.0, precision=2)
    if len(events) < 3:
        pytest.skip("too few events simulated")
    data = TimeSeries(events.ts, events.ys,
                      jnp.ones(events.ts.shape, dtype=bool))
    res = lgcp_filter(model, params, data, 300, key, precision=1)
    assert np.isfinite(float(res.ll))
    assert res.ess.shape == (len(events),)
    assert bool((res.ess >= 1).all())
    assert res.eta_mean.shape == (len(events),)
    assert bool((res.eta_mean > 0).all())
    # state credible intervals (getIntervals, ParticleFilter.scala:415-424)
    t, d = len(events), model.dim
    assert res.state_lower.shape == (t, d)
    assert res.state_upper.shape == (t, d)
    assert bool((res.state_lower <= res.state_upper).all())
    assert bool((res.state_lower <= res.state_mean).all())
    assert bool((res.state_mean <= res.state_upper).all())


def test_lgcp_filter_discriminates_parameters(key):
    """The filter's ll should prefer parameters near the generating ones."""
    model = lgcp(gen_brownian_motion(1))
    true_p = parameters(None, gen_brownian_params(1.5, 0.01, 0.0, 0.01))
    events, _ = simulate_lgcp(model, true_p, key, 0.0, 8.0, precision=2)
    if len(events) < 5:
        pytest.skip("too few events")
    data = TimeSeries(events.ts, events.ys,
                      jnp.ones(events.ts.shape, dtype=bool))
    far_p = parameters(None, gen_brownian_params(-2.0, 0.01, 0.0, 0.01))
    lls_true = [float(lgcp_filter(model, true_p, data, 200,
                                  jax.random.fold_in(key, i)).ll)
                for i in range(3)]
    lls_far = [float(lgcp_filter(model, far_p, data, 200,
                                 jax.random.fold_in(key, 10 + i)).ll)
               for i in range(3)]
    assert np.mean(lls_true) > np.mean(lls_far)


def test_lgcp_filter_zero_dt_step(lgcp_model, key):
    model, params = lgcp_model
    ts = jnp.asarray([0.5, 0.5, 1.0])  # repeated time => dt == 0 path
    data = TimeSeries(ts, jnp.ones_like(ts), jnp.ones(ts.shape, dtype=bool))
    res = lgcp_filter(model, params, data, 100, key, precision=1)
    assert np.isfinite(float(res.ll))


def test_fine_grid_cost_is_sum_of_gaps_not_max():
    """The flat union grid sizes work as O(sum gaps / h): one 10x outlier
    gap must not multiply every segment's cost (the round-2 design padded
    every observation to the LARGEST gap's substep count)."""
    from composablestatespacemodels_tpu.inference.lgcp import _build_fine_grid

    ts = np.concatenate([np.arange(0.0, 10.0, 0.5),      # 20 obs, gaps 0.5
                         [20.0]])                        # one 10.5 outlier
    grid = _build_fine_grid(ts, precision=1)
    k = grid[0].shape[0]
    # sum of gaps/h: first slot + 19 gaps x 5 substeps + outlier's 105
    assert k == 1 + 19 * 5 + 105, k
    # the padded design would have cost T * max_substeps = 21 * 105
    assert k < 21 * 105 / 8
    # exactly one obs slot per observation, indices consistent
    oflag = np.asarray(grid[3])
    obs_idx = np.asarray(grid[6])
    assert oflag.sum() == len(ts)
    assert bool(oflag[obs_idx].all())


def test_fine_grid_flags():
    from composablestatespacemodels_tpu.inference.lgcp import _build_fine_grid

    ts = np.asarray([1.0, 1.0, 1.25])  # first slot, duplicate, 0.25 gap
    t_eval, hflag, aflag, oflag, t_obs, zflag, obs_idx = map(
        np.asarray, _build_fine_grid(ts, precision=1))
    # segments: [zero-dt slot][zero-dt slot][ceil(0.25/0.1)=3 substeps]
    assert t_eval.shape[0] == 1 + 1 + 3
    np.testing.assert_array_equal(zflag, [True, True, False, False, False])
    np.testing.assert_array_equal(hflag, [False, False, True, True, True])
    # advance after all but each segment's last substep
    np.testing.assert_array_equal(aflag, [False, False, True, True, False])
    np.testing.assert_array_equal(oflag, [True, True, False, False, True])
    np.testing.assert_allclose(t_eval[2:], [1.0, 1.1, 1.2], rtol=1e-6)
    np.testing.assert_array_equal(obs_idx, [0, 1, 4])


def test_lgcp_filter_matches_old_padded_semantics(lgcp_model, key):
    """Statistical regression: ll on a gappy series is stable and finite
    across seeds (guards the flat-scan rewrite's hazard bookkeeping)."""
    model, params = lgcp_model
    ts = jnp.asarray([0.0, 0.3, 0.35, 1.9, 2.0, 5.0])   # mixed gap sizes
    data = TimeSeries(ts, jnp.ones_like(ts), jnp.ones(ts.shape, dtype=bool))
    lls = [float(lgcp_filter(model, params, data, 400,
                             jax.random.fold_in(key, i), precision=1).ll)
           for i in range(4)]
    assert all(np.isfinite(v) for v in lls)
    assert np.std(lls) < 0.5, lls


def test_lgcp_filter_mesh_matches_single_device(lgcp_model, key):
    """mesh= LGCP filter agrees with the single-device filter to MC error
    (different per-shard propagation key streams, same semantics)."""
    from composablestatespacemodels_tpu.parallel import particle_mesh

    model, params = lgcp_model
    ts = jnp.asarray([0.0, 0.3, 0.35, 1.9, 2.0, 3.1])
    data = TimeSeries(ts, jnp.ones_like(ts), jnp.ones(ts.shape, dtype=bool))
    single = [float(lgcp_filter(model, params, data, 512,
                                jax.random.fold_in(key, i), precision=1).ll)
              for i in range(4)]
    mesh = particle_mesh()
    res = lgcp_filter(model, params, data, 512, key, precision=1, mesh=mesh)
    assert np.isfinite(float(res.ll))
    tol = 6 * max(np.std(single), 0.05)
    assert abs(float(res.ll) - np.mean(single)) < tol, (res.ll, single)
    # per-observation invariants
    n_obs = ts.shape[0]
    assert res.ess.shape == (n_obs,)
    assert bool((res.ess >= 1).all()) and bool((res.ess <= 512).all())
    assert bool((res.eta_lower <= res.eta_upper).all())
    assert res.final_particles.shape == (512, model.dim)
    assert np.isfinite(np.asarray(res.state_mean)).all()
    assert res.state_lower.shape == (n_obs, model.dim)
    assert bool((res.state_lower <= res.state_upper).all())


def test_lgcp_filter_one_shard_mesh(lgcp_model, key):
    """A 1-wide particle mesh exercises the n_shards==1 specialization
    (identity scalar collectives, local bisection selector, local
    resampler shortcut) and must agree with single-device runs to MC
    error."""
    from jax.sharding import Mesh

    from composablestatespacemodels_tpu.parallel.mesh import PARTICLE_AXIS

    model, params = lgcp_model
    ts = jnp.asarray([0.0, 0.3, 0.35, 1.9, 2.0, 3.1])
    data = TimeSeries(ts, jnp.ones_like(ts), jnp.ones(ts.shape, dtype=bool))
    mesh = Mesh(np.asarray(jax.devices()[:1]), (PARTICLE_AXIS,))
    res = lgcp_filter(model, params, data, 512, key, precision=1, mesh=mesh)
    single = [float(lgcp_filter(model, params, data, 512,
                                jax.random.fold_in(key, i), precision=1).ll)
              for i in range(4)]
    tol = 6 * max(np.std(single), 0.05)
    assert abs(float(res.ll) - np.mean(single)) < tol, (res.ll, single)
    assert bool((res.state_lower <= res.state_upper).all())
    assert bool((res.eta_lower <= res.eta_upper).all())


def test_lgcp_filter_mesh_validates(lgcp_model, key):
    from composablestatespacemodels_tpu.parallel import particle_mesh

    model, params = lgcp_model
    ts = jnp.asarray([0.0, 0.5, 1.0])
    data = TimeSeries(ts, jnp.ones_like(ts), jnp.ones(ts.shape, dtype=bool))
    mesh = particle_mesh()
    with pytest.raises(ValueError, match="systematic"):
        lgcp_filter(model, params, data, 512, key, mesh=mesh,
                    resample="multinomial")
    with pytest.raises(ValueError, match="divisible"):
        lgcp_filter(model, params, data, 100, key, mesh=mesh)
