"""Observation families: log-densities vs scipy, sampler moments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st

from composablestatespacemodels_tpu.models import observation as obs


def gammaize(x):
    return jnp.asarray(x, dtype=jnp.float32)


def test_gaussian_logpdf_vs_scipy():
    fam = obs.Gaussian()
    gamma, y, sd = 1.2, 0.7, 2.0
    got = fam.log_density(gammaize(gamma), gammaize(y), gammaize(sd))
    want = st.norm.logpdf(y, loc=gamma, scale=sd)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_poisson_logpmf_vs_scipy():
    fam = obs.Poisson()
    gamma = 1.5
    for y in [0.0, 1.0, 7.0]:
        got = fam.log_density(gammaize(gamma), gammaize(y), None)
        want = st.poisson.logpmf(int(y), np.exp(gamma))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_negative_binomial_logpmf_vs_scipy():
    fam = obs.NegativeBinomial()
    gamma, size = 1.0, 3.0
    mu = np.exp(gamma)
    p = size / (mu + size)  # scipy nbinom: n failures, success prob
    for y in [0.0, 2.0, 10.0]:
        got = fam.log_density(gammaize(gamma), gammaize(y), gammaize(size))
        want = st.nbinom.logpmf(int(y), size, p)
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_zip_logpmf():
    fam = obs.ZeroInflatedPoisson()
    gamma, p_zero = 0.8, 0.3
    lam = np.exp(gamma)
    got0 = fam.log_density(gammaize(gamma), gammaize(0.0), gammaize(p_zero))
    want0 = np.log(p_zero + (1 - p_zero) * np.exp(-lam))
    np.testing.assert_allclose(got0, want0, rtol=1e-5)
    got3 = fam.log_density(gammaize(gamma), gammaize(3.0), gammaize(p_zero))
    want3 = np.log(1 - p_zero) + st.poisson.logpmf(3, lam)
    np.testing.assert_allclose(got3, want3, rtol=1e-5)


def test_students_t_logpdf_vs_scipy():
    fam = obs.StudentsT(df=5)
    gamma, y, v = 0.5, 2.0, 1.5
    got = fam.log_density(gammaize(gamma), gammaize(y), gammaize(v))
    want = st.t.logpdf(y, 5, loc=gamma, scale=v)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_bernoulli_logpmf():
    fam = obs.Bernoulli()
    gamma = 0.7
    p = 1 / (1 + np.exp(-gamma))
    np.testing.assert_allclose(
        fam.log_density(gammaize(gamma), gammaize(1.0), None), np.log(p),
        rtol=1e-5)
    np.testing.assert_allclose(
        fam.log_density(gammaize(gamma), gammaize(0.0), None), np.log(1 - p),
        rtol=1e-5)
    # clamped link floors the log-likelihood (Model.scala:318-334); the floor
    # is finite so float32 weight updates stay NaN-free
    lo = float(fam.log_density(gammaize(10.0), gammaize(0.0), None))
    hi = float(fam.log_density(gammaize(-10.0), gammaize(1.0), None))
    assert lo <= -1e29 and np.isfinite(lo)
    assert hi <= -1e29 and np.isfinite(hi)


def test_beta_logpdf_vs_scipy():
    fam = obs.Beta()
    gamma, y, b = -0.5, 0.4, 2.0
    a = np.exp(-gamma)
    got = fam.log_density(gammaize(gamma), gammaize(y), gammaize(b))
    want = st.beta.logpdf(y, a, b)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("fam,gamma,scale,mean,var", [
    (obs.Gaussian(), 1.0, 0.5, 1.0, 0.25),
    (obs.Poisson(), 1.0, None, np.e, np.e),
    (obs.Bernoulli(), 0.0, None, 0.5, 0.25),
])
def test_sampler_moments(key, fam, gamma, scale, mean, var):
    g = jnp.full((40000,), gamma, dtype=jnp.float32)
    s = None if scale is None else jnp.asarray(scale, jnp.float32)
    ys = fam.sample(key, g, s)
    np.testing.assert_allclose(jnp.mean(ys), mean, rtol=0.05)
    np.testing.assert_allclose(jnp.var(ys), var, rtol=0.1)


def test_negbin_sampler_moments(key):
    fam = obs.NegativeBinomial()
    gamma, size = 1.0, 4.0
    mu = np.exp(gamma)
    g = jnp.full((60000,), gamma, dtype=jnp.float32)
    ys = fam.sample(key, g, jnp.asarray(size, jnp.float32))
    np.testing.assert_allclose(jnp.mean(ys), mu, rtol=0.05)
    np.testing.assert_allclose(jnp.var(ys), mu + mu * mu / size, rtol=0.1)


def test_zip_sampler_moments(key):
    fam = obs.ZeroInflatedPoisson()
    gamma, p_zero = 1.0, 0.3
    lam = np.exp(gamma)
    g = jnp.full((60000,), gamma, dtype=jnp.float32)
    ys = fam.sample(key, g, jnp.asarray(p_zero, jnp.float32))
    np.testing.assert_allclose(jnp.mean(ys), (1 - p_zero) * lam, rtol=0.05)
    frac_zero = float(jnp.mean(ys == 0))
    want_zero = p_zero + (1 - p_zero) * np.exp(-lam)
    np.testing.assert_allclose(frac_zero, want_zero, rtol=0.05)


def test_students_t_sampler_moments(key):
    fam = obs.StudentsT(df=10)
    g = jnp.full((60000,), 2.0, dtype=jnp.float32)
    ys = fam.sample(key, g, jnp.asarray(0.5, jnp.float32))
    np.testing.assert_allclose(jnp.mean(ys), 2.0, atol=0.02)
    # var = v^2 * df/(df-2)
    np.testing.assert_allclose(jnp.var(ys), 0.25 * 10 / 8, rtol=0.1)


def test_beta_sampler_moments(key):
    fam = obs.Beta()
    gamma, b = -np.log(2.0), 3.0  # alpha = 2
    g = jnp.full((60000,), gamma, dtype=jnp.float32)
    ys = fam.sample(key, g, jnp.asarray(b, jnp.float32))
    np.testing.assert_allclose(jnp.mean(ys), 2.0 / 5.0, rtol=0.03)


def test_lgcp_raises():
    fam = obs.LogGaussianCox()
    with pytest.raises(NotImplementedError):
        fam.log_density(gammaize(0.0), gammaize(1.0), None)
