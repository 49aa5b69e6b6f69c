"""PMMH: exact-target validation on a conjugate case, acceptance behavior,
chains, diagnostics (BASELINE.json config 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from composablestatespacemodels_tpu import (TimeSeries, linear,
                                            simulate_regular)
from composablestatespacemodels_tpu.inference import pmmh as pm
from composablestatespacemodels_tpu.models import (brownian_motion,
                                                   brownian_params, leaf,
                                                   param_node, parameters,
                                                   perturb)


@pytest.fixture(scope="module")
def lg_setup():
    model = linear(brownian_motion(1))
    true_params = parameters(jnp.log(0.5), brownian_params(0.2, 0.25, 0.3))
    sim = simulate_regular(model, true_params, jax.random.PRNGKey(0), 80,
                           dt=0.5)
    return model, true_params, sim.to_timeseries()


def test_pmmh_runs_and_accepts(lg_setup, key):
    model, p0, data = lg_setup
    pf_ll = pm.make_pf_loglik(model, data, 100)
    res = pm.pmmh(key, p0, pf_ll, perturb(0.01), 300)
    rate = float(res.acceptance_rate())
    assert 0.01 < rate < 0.95
    assert res.lls.shape == (300,)
    assert bool(jnp.isfinite(res.lls[-1]))
    # first proposal always accepted (init ll = -1e30, PMMH.scala:121)
    assert int(res.accepted[0]) == 1


def test_pmmh_posterior_concentrates_near_truth(lg_setup, key):
    """Posterior mean of the observation log-sd should be near the truth."""
    model, p0, data = lg_setup
    pf_ll = pm.make_pf_loglik(model, data, 200)
    # start away from the truth
    start = parameters(jnp.log(2.0), brownian_params(0.2, 0.25, 0.3))
    res = pm.pmmh(key, start, pf_ll, perturb(0.02), 1500)
    kept = res.thin(burn_in=500, thin=2)
    scales = kept.params.value.scale  # stacked leaf: [iters]
    post_mean = float(jnp.mean(scales))
    post_sd = float(jnp.std(scales))
    # truth log(0.5); generous MC bound
    assert abs(post_mean - float(jnp.log(0.5))) < max(4 * post_sd, 0.5)


def test_pmmh_chains_vmap(lg_setup, key):
    model, p0, data = lg_setup
    pf_ll = pm.make_pf_loglik(model, data, 100)
    res = pm.pmmh_chains(key, p0, pf_ll, perturb(0.01), 200, 4)
    assert res.lls.shape == (4, 200)
    assert res.accepted.shape == (4, 200)
    rates = np.asarray(res.acceptance_rate())
    assert rates.shape == (4,)
    assert (rates > 0).all()
    # chains differ
    assert float(jnp.std(res.lls[:, -1])) > 0


def test_pmmh_chains_isolated(lg_setup, key):
    """Chain i of the vmapped runner must BIT-match a single `pmmh` run
    with the same per-chain key: any batch-axis contamination inside the
    vmapped filter (e.g. a pallas kernel whose cross-block carry leaks
    across the batch) breaks this equality silently everywhere else."""
    model, p0, data = lg_setup
    pf_ll = pm.make_pf_loglik(model, data, 100)
    res = pm.pmmh_chains(key, p0, pf_ll, perturb(0.01), 50, 3)
    keys = jax.random.split(key, 3)
    for i in range(3):
        solo = pm.pmmh(keys[i], p0, pf_ll, perturb(0.01), 50)
        np.testing.assert_array_equal(np.asarray(res.lls[i]),
                                      np.asarray(solo.lls),
                                      err_msg=f"chain {i} lls diverge")
        np.testing.assert_array_equal(np.asarray(res.accepted[i]),
                                      np.asarray(solo.accepted))


def test_approx_pmmh_runs(lg_setup, key):
    model, p0, data = lg_setup
    pf_ll = pm.make_pf_loglik(model, data, 100)
    res = pm.pmmh(key, p0, pf_ll, perturb(0.01), 100, approx=True)
    assert bool(jnp.isfinite(res.lls[-1]))


def test_prior_influences_acceptance(lg_setup, key):
    model, p0, data = lg_setup
    pf_ll = pm.make_pf_loglik(model, data, 100)

    def tight_prior(params):
        # extremely tight prior on the scale at an implausible value
        return -1e4 * (params.value.scale - 5.0) ** 2

    res_flat = pm.pmmh(key, p0, pf_ll, perturb(0.01), 200)
    res_tight = pm.pmmh(key, p0, pf_ll, perturb(0.01), 200,
                        prior=tight_prior)
    # the tight prior at a far-away mode should reject nearly everything
    assert int(res_tight.accepted[-1]) <= int(res_flat.accepted[-1])


def test_pilot_run(lg_setup, key):
    model, p0, data = lg_setup
    out = pm.pilot_run(model, p0, data, key, particle_counts=(50, 200),
                       n_reps=20)
    assert len(out) == 2
    (n1, m1, v1), (n2, m2, v2) = out
    assert n1 == 50 and n2 == 200
    # more particles -> lower ll variance
    assert v2 < v1
    assert abs(m1 - m2) < 3.0


def test_gelman_rubin_converged_vs_not(key):
    k1, k2 = jax.random.split(key)
    same = jax.random.normal(k1, (4, 500))
    rhat_ok = float(pm.gelman_rubin(same))
    assert rhat_ok < 1.1
    apart = same + jnp.arange(4.0)[:, None] * 5
    assert float(pm.gelman_rubin(apart)) > 1.5


def test_effective_chain_size(key):
    iid = jax.random.normal(key, (1000,))
    ess = pm.effective_chain_size(iid)
    assert ess > 300
    corr = jnp.cumsum(iid) / 10  # highly autocorrelated
    assert pm.effective_chain_size(corr) < ess


def test_thin_shapes(lg_setup, key):
    model, p0, data = lg_setup
    pf_ll = pm.make_pf_loglik(model, data, 50)
    res = pm.pmmh(key, p0, pf_ll, perturb(0.01), 100)
    kept = res.thin(burn_in=20, thin=4)
    assert kept.lls.shape == (20,)
    assert kept.params.value.scale.shape[0] == 20


def test_pmmh_composed_seasonal_poisson_recovery(key):
    """BASELINE config 4: PMMH on the composed seasonal-Poisson model.

    With all parameters but one pinned, the posterior over the Poisson
    component's OU mean should concentrate near the generating value.
    """
    from composablestatespacemodels_tpu import (poisson, seasonal,
                                                simulate_regular)
    from composablestatespacemodels_tpu.models import (Branch, Leaf, branch,
                                                       leaf, ou_params,
                                                       ou_process, param_node)

    model = poisson(ou_process(1)) + seasonal(24, 2, ou_process(4))
    true_mu = 1.5
    right = leaf(param_node(None, ou_params(0.2, 0.1, 0.3, 0.2, 0.15)))

    def with_mu(mu):
        return branch(
            leaf(param_node(None, ou_params(true_mu, 0.1, 0.5, mu, 0.2))),
            right)

    true_params = with_mu(true_mu)
    sim = simulate_regular(model, true_params, jax.random.PRNGKey(2), 120,
                           dt=1.0)
    data = sim.to_timeseries()
    pf_ll = pm.make_pf_loglik(model, data, 150)

    # propose only on the left OU mu: custom proposal keeps others fixed
    def proposal(k, p):
        delta = 0.05 * jax.random.normal(k, ())
        left = p.left.value
        new_sde = left.sde.__class__(left.sde.m0, left.sde.c0, left.sde.phi,
                                     left.sde.mu + delta, left.sde.sigma)
        from composablestatespacemodels_tpu.models import ParamNode
        return Branch(Leaf(ParamNode(left.scale, new_sde)), p.right)

    start = with_mu(0.0)  # start away from the truth
    res = pm.pmmh(key, start, pf_ll, proposal, 800)
    kept = res.thin(burn_in=300, thin=2)
    mus = np.asarray(kept.params.left.value.sde.mu[:, 0])
    post_mean, post_sd = mus.mean(), mus.std()
    # posterior concentrates near the generating value
    assert abs(post_mean - true_mu) < max(4 * post_sd, 0.5), (
        f"posterior mean {post_mean:.3f} sd {post_sd:.3f} vs truth {true_mu}")
    # and has clearly moved from the start
    assert abs(post_mean - 0.0) > abs(post_mean - true_mu)


def test_adaptive_pmmh_recovers_posterior(lg_setup, key):
    """Two-phase adaptive PMMH (pilot RW -> covariance -> MVN-eigen main
    chain) recovers the observation log-sd, and the adapted chain mixes."""
    model, p0, data = lg_setup
    pf_ll = pm.make_pf_loglik(model, data, 200)
    start = parameters(jnp.log(2.0), brownian_params(0.2, 0.25, 0.3))
    res, pilot = pm.adaptive_pmmh(key, start, pf_ll, 1200,
                                  pilot_iters=600, pilot_delta=0.02,
                                  return_pilot=True)
    assert pilot.lls.shape == (600,)
    kept = res.thin(burn_in=300, thin=2)
    scales = kept.params.value.scale
    post_mean = float(jnp.mean(scales))
    post_sd = float(jnp.std(scales))
    assert abs(post_mean - float(jnp.log(0.5))) < max(4 * post_sd, 0.5)
    # the adapted proposal must actually move (nugget guards degeneracy)
    rate = float(res.acceptance_rate())
    assert 0.01 < rate < 0.95, rate
    assert post_sd > 1e-4


def test_adaptive_pmmh_degenerate_pilot_does_not_freeze(lg_setup, key):
    """A pilot that accepts (almost) nothing must still yield a proposal
    that moves the main chain (diagonal nugget)."""
    model, p0, data = lg_setup
    pf_ll = pm.make_pf_loglik(model, data, 100)
    # absurd pilot step size => ~zero acceptances => near-zero covariance
    res = pm.adaptive_pmmh(key, p0, pf_ll, 200, pilot_iters=50,
                           pilot_delta=500.0)
    flat = np.asarray(res.params.value.scale)
    assert np.std(flat) >= 0  # runs; and proposals are not all identical:
    assert np.isfinite(res.lls).all()


def test_pmmh_store_state_joint_draws(lg_setup, key):
    """store_state carries one sampled latent final state per iteration
    (MetropState.state, PMMH.scala:26 fed by filterLlState,
    ParticleFilter.scala:346-357): shapes, finiteness, and the state only
    changes when a proposal is accepted."""
    model, p0, data = lg_setup
    pf_ll = pm.make_pf_loglik(model, data, 100, store_state=True)
    res = pm.pmmh(key, p0, pf_ll, perturb(0.02), 300, store_state=True)
    assert res.states.shape == (300, model.dim)
    assert bool(jnp.isfinite(res.states).all())
    inc = np.diff(np.asarray(res.accepted))
    same = (np.asarray(res.states[1:]) == np.asarray(res.states[:-1])).all(1)
    # rejected iterations carry the state unchanged; accepted draw a new one
    np.testing.assert_array_equal(same, inc == 0)
    # plain pf_ll without store_state is unchanged
    res2 = pm.pmmh(key, p0, pm.make_pf_loglik(model, data, 100),
                   perturb(0.02), 50)
    assert res2.states is None


def test_pmmh_store_state_chains(lg_setup, key):
    model, p0, data = lg_setup
    pf_ll = pm.make_pf_loglik(model, data, 100, store_state=True)
    res = pm.pmmh_chains(key, p0, pf_ll, perturb(0.02), 60, 3,
                         store_state=True)
    assert res.states.shape == (3, 60, model.dim)
    kept = res.thin(burn_in=20, thin=2)
    assert kept.states.shape == (3, 20, model.dim)


def test_pmmh_store_state_posterior_matches_kalman(lg_setup, key):
    """The carried latent states are draws from the filtering distribution
    at the last observation time: their posterior mean must match the
    Kalman filtering mean there (the joint-posterior forecast input,
    Data.scala:202-217)."""
    from composablestatespacemodels_tpu import kalman_filter

    model, p0, data = lg_setup
    kf = kalman_filter(model, p0, data)
    pf_ll = pm.make_pf_loglik(model, data, 300, store_state=True)
    # fixed params (zero-width proposal would never accept; tiny instead)
    res = pm.pmmh(key, p0, pf_ll, perturb(1e-4), 400, store_state=True)
    states = np.asarray(res.states[50:, 0])
    kf_mean = float(kf.means[-1, 0])
    kf_sd = float(np.sqrt(kf.covs[-1, 0, 0]))
    # states only refresh on acceptance -> effective sample size is the
    # number of acceptances; bound generously
    n_eff = max(int(res.accepted[-1]), 1)
    assert abs(states.mean() - kf_mean) < 5 * kf_sd / np.sqrt(n_eff) + 0.3
    assert 0.3 * kf_sd < states.std() < 3.0 * kf_sd


def test_metrop_states_json_roundtrip(tmp_path, lg_setup, key):
    from composablestatespacemodels_tpu.utils.io import (
        read_metrop_states_json, write_metrop_states_json)

    model, p0, data = lg_setup
    pf_ll = pm.make_pf_loglik(model, data, 50, store_state=True)
    res = pm.pmmh(key, p0, pf_ll, perturb(0.02), 20, store_state=True)
    path = str(tmp_path / "metrop.json")
    t_last = float(data.ts[-1])
    write_metrop_states_json(path, res, t_last)
    stacked, lls, t_back, states, accs = read_metrop_states_json(path)
    assert t_back == t_last
    np.testing.assert_allclose(np.asarray(lls), np.asarray(res.lls),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(states), np.asarray(res.states),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(accs), np.asarray(res.accepted))
    np.testing.assert_allclose(
        np.asarray(stacked.value.scale), np.asarray(res.params.value.scale),
        rtol=1e-6)


def test_store_state_requires_state_evaluator(key):
    """store_state=True with an evaluator that returns a bare ll must
    raise a clear ValueError (round-5 review finding), on both the
    single-chain and vmapped-chains tiers."""
    import composablestatespacemodels_tpu as cssm
    from composablestatespacemodels_tpu.models import (brownian_motion,
                                                       brownian_params,
                                                       parameters, perturb)

    model = cssm.linear(brownian_motion(1))
    p0 = parameters(jnp.log(0.5), brownian_params(0.2, 0.25, 0.3))
    sim = cssm.simulate_regular(model, p0, jax.random.PRNGKey(0), 8, dt=0.5)
    data = sim.to_timeseries()
    pf_ll = cssm.make_pf_loglik(model, data, 32)          # no store_state
    with pytest.raises(ValueError, match="store_state"):
        cssm.pmmh(key, p0, pf_ll, perturb(0.02), 3, store_state=True)
    with pytest.raises(ValueError, match="store_state"):
        cssm.pmmh_chains(key, p0, pf_ll, perturb(0.02), 3, 8,
                         store_state=True)


def test_store_state_checkpoint_resumed_without_flag(key):
    """A store_state PmmhState resumed with the flag off drops the latent
    carry instead of dying in a tree_map TypeError (round-5 review
    finding)."""
    import composablestatespacemodels_tpu as cssm
    from composablestatespacemodels_tpu.models import (brownian_motion,
                                                       brownian_params,
                                                       parameters, perturb)

    model = cssm.linear(brownian_motion(1))
    p0 = parameters(jnp.log(0.5), brownian_params(0.2, 0.25, 0.3))
    sim = cssm.simulate_regular(model, p0, jax.random.PRNGKey(0), 8, dt=0.5)
    data = sim.to_timeseries()
    pf_ll = cssm.make_pf_loglik(model, data, 32, store_state=True)
    res, fin = cssm.pmmh(key, p0, pf_ll, perturb(0.02), 4,
                         store_state=True, return_state=True)
    assert res.states.shape == (4, model.dim)
    pf_plain = cssm.make_pf_loglik(model, data, 32)
    cont = cssm.pmmh(key, p0, pf_plain, perturb(0.02), 3, init_state=fin)
    assert cont.states is None
    assert bool(jnp.isfinite(cont.lls).all())


def _family_case(family):
    import composablestatespacemodels_tpu as cssm

    sde = brownian_motion(1)
    if family == "gaussian":
        model = cssm.linear(sde)
        p0 = parameters(jnp.log(0.5), brownian_params(0.2, 0.25, 0.3))
    elif family == "poisson":
        model = cssm.poisson(sde)
        p0 = parameters(None, brownian_params(0.5, 0.2, 0.2))
    else:
        model = cssm.negative_binomial(sde)
        p0 = parameters(jnp.log(3.0), brownian_params(0.5, 0.2, 0.2))
    sim = simulate_regular(model, p0, jax.random.PRNGKey(1), 24, dt=0.5)
    # masked steps: a block of missing observations mid-series
    data = sim.to_timeseries().knock_out(4.0, 6.0)
    return model, p0, data


@pytest.mark.parametrize("family", ["gaussian", "poisson",
                                    "negative_binomial"])
@pytest.mark.parametrize("n_particles", [100, 256, 300, 512])
def test_pmmh_chains_match_looped_pmmh(family, n_particles, key):
    """pmmh_chains (one vmapped program) reproduces the same chains run
    one at a time with pmmh under the per-chain keys it splits."""
    model, p0, data = _family_case(family)
    assert not bool(jnp.all(data.mask))
    pf_ll = pm.make_pf_loglik(model, data, n_particles)
    n_chains, n_iters = 2, 6
    res = pm.pmmh_chains(key, p0, pf_ll, perturb(0.02), n_iters, n_chains)
    for c, k in enumerate(jax.random.split(key, n_chains)):
        one = pm.pmmh(k, p0, pf_ll, perturb(0.02), n_iters)
        np.testing.assert_array_equal(np.asarray(res.accepted[c]),
                                      np.asarray(one.accepted))
        np.testing.assert_allclose(np.asarray(res.lls[c]),
                                   np.asarray(one.lls), rtol=1e-5)
    assert bool(jnp.isfinite(res.lls).all())
