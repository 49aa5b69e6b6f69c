"""Observation families: link functions, log-densities and samplers.

The nine reference observation distributions (Model.scala:144-369) as pure,
vectorised JAX functions.  Each family provides

* ``link(gamma)``            -- the linking function g (Model.scala:23);
* ``log_density(gamma, y, scale)`` -- log pi(y | eta) with eta = g(gamma);
* ``sample(key, gamma, scale)``    -- a draw from pi(. | eta);
* ``constrain_scale(raw)``   -- bijector from the unconstrained stored
  observation-scale to its natural value (exp for positive scales, logistic
  for the zero-inflation probability).

All functions broadcast over arbitrary leading axes: the particle filter
evaluates ``log_density`` on ``[N]`` particle blocks in one fused pass.
Scales arrive *unconstrained* exactly as the reference stores them
(Model.scala:146-147 et al. exp the stored value).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from .bijectors import logistic

_HALF_LOG_2PI = 0.9189385332046727  # 0.5 * log(2*pi)
# Hard log-likelihood floor for impossible observations.  The reference uses
# -1e99 (Model.scala:332-334); -1e30 keeps the floor finite in float32 so the
# max-shift/exp weight update never produces NaNs.
_NEG_INF_LL = -1e30


class ObservationFamily:
    """Base class; families are frozen dataclasses usable as static metadata."""

    needs_scale: bool = True

    def constrain_scale(self, raw):
        """Default: positive scale stored on the log scale."""
        return jnp.exp(raw)

    def link(self, gamma):
        return gamma

    def log_density(self, gamma, y, scale):
        raise NotImplementedError

    def sample(self, key, gamma, scale):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Gaussian(ObservationFamily):
    """y ~ N(gamma, v^2), v = exp(scale).  Reference: LinearModel,
    Model.scala:241-259 (breeze ``Gaussian(mean, sd)``)."""

    def log_density(self, gamma, y, scale):
        z = (y - gamma) / scale
        return -_HALF_LOG_2PI - jnp.log(scale) - 0.5 * z * z

    def sample(self, key, gamma, scale):
        return gamma + scale * jax.random.normal(key, jnp.shape(gamma))


@dataclasses.dataclass(frozen=True)
class Poisson(ObservationFamily):
    """y ~ Poisson(exp(gamma)).  Reference: PoissonModel, Model.scala:266-274."""

    needs_scale = False

    def link(self, gamma):
        return jnp.exp(gamma)

    def log_density(self, gamma, y, scale):
        # y * log(lambda) - lambda - log(y!)  with log(lambda) = gamma
        return y * gamma - jnp.exp(gamma) - gammaln(y + 1.0)

    def sample(self, key, gamma, scale):
        return jax.random.poisson(key, self.link(gamma)).astype(
            jnp.result_type(float))


@dataclasses.dataclass(frozen=True)
class ZeroInflatedPoisson(ObservationFamily):
    """Excess-zero counts: with prob p = logistic(scale) emit 0, else
    Poisson(exp(gamma)).  Reference: ZeroInflatedPoisson, Model.scala:281-309."""

    def constrain_scale(self, raw):
        return logistic(raw)

    def link(self, gamma):
        return jnp.exp(gamma)

    def log_density(self, gamma, y, scale):
        lam = jnp.exp(gamma)
        # log(p + (1-p) e^-lam) computed stably as logaddexp
        log_p = jnp.log(scale)
        log_1mp = jnp.log1p(-scale)
        ll_zero = jnp.logaddexp(log_p, log_1mp - lam)
        ll_pos = log_1mp + y * gamma - lam - gammaln(y + 1.0)
        return jnp.where(y == 0, ll_zero, ll_pos)

    def sample(self, key, gamma, scale):
        ku, kp = jax.random.split(key)
        u = jax.random.uniform(ku, jnp.shape(gamma))
        pois = jax.random.poisson(kp, self.link(gamma)).astype(
            jnp.result_type(float))
        return jnp.where(u < scale, 0.0, pois)


@dataclasses.dataclass(frozen=True)
class NegativeBinomial(ObservationFamily):
    """Overdispersed counts: mean mu = exp(gamma), size r = exp(scale),
    variance mu + mu^2/r.  Gamma-Poisson mixture.  Reference:
    NegativeBinomialModel, Model.scala:168-196."""

    def link(self, gamma):
        return jnp.exp(gamma)

    def log_density(self, gamma, y, scale):
        size = scale
        mu = jnp.exp(gamma)
        return (gammaln(size + y) - gammaln(y + 1.0) - gammaln(size)
                + size * jnp.log(size / (mu + size))
                + y * jnp.log(mu / (mu + size)))

    def sample(self, key, gamma, scale):
        kg, kp = jax.random.split(key)
        size = scale
        mu = self.link(gamma)
        # lambda ~ Gamma(shape=size, scale=mu/size)  => E[y] = mu
        lam = jax.random.gamma(kg, size, jnp.shape(gamma)) * (mu / size)
        return jax.random.poisson(kp, lam).astype(jnp.result_type(float))


@dataclasses.dataclass(frozen=True)
class Bernoulli(ObservationFamily):
    """y in {0,1} with p = clamped-logistic(gamma).  Reference:
    BernoulliModel, Model.scala:315-337 (clamps the link at |gamma| > 6)."""

    needs_scale = False

    def link(self, gamma):
        p = logistic(gamma)
        return jnp.where(gamma > 6.0, 1.0, jnp.where(gamma < -6.0, 0.0, p))

    def log_density(self, gamma, y, scale):
        p = self.link(gamma)
        ll1 = jnp.where(p == 0.0, _NEG_INF_LL, jnp.log(jnp.maximum(p, 1e-300)))
        ll0 = jnp.where(p == 1.0, _NEG_INF_LL,
                        jnp.log(jnp.maximum(1.0 - p, 1e-300)))
        return jnp.where(y == 1.0, ll1, ll0)

    def sample(self, key, gamma, scale):
        u = jax.random.uniform(key, jnp.shape(gamma))
        return jnp.where(u < self.link(gamma), 1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class StudentsT(ObservationFamily):
    """y = gamma + v * t_df, v = exp(scale).  Reference: StudentsTModel,
    Model.scala:144-162.

    Deviation from reference: Model.scala:158 computes
    ``(1/v) * logPdf((y-eta)/v)`` which *multiplies the log-density* by 1/v;
    the correct change-of-variables is ``logPdf((y-eta)/v) - log(v)``, used
    here.
    """

    df: int = 4

    def log_density(self, gamma, y, scale):
        nu = float(self.df)
        z = (y - gamma) / scale
        lognorm = (gammaln((nu + 1.0) / 2.0) - gammaln(nu / 2.0)
                   - 0.5 * jnp.log(nu * jnp.pi))
        return lognorm - (nu + 1.0) / 2.0 * jnp.log1p(z * z / nu) - jnp.log(scale)

    def sample(self, key, gamma, scale):
        t = jax.random.t(key, float(self.df), jnp.shape(gamma))
        return gamma + scale * t


@dataclasses.dataclass(frozen=True)
class Beta(ObservationFamily):
    """y ~ Beta(alpha=exp(-gamma), beta=exp(scale)).

    The reference's link is ``exp(-x)`` (Model.scala:345); kept for parity.
    Deviation: the reference's ``dataLikelihood`` ignores the stored shape and
    evaluates Beta(link, 1) (Model.scala:349-353); here sampling and density
    use the same Beta(alpha, beta) law.
    """

    def link(self, gamma):
        return jnp.exp(-gamma)

    def log_density(self, gamma, y, scale):
        a = self.link(gamma)
        b = scale
        return ((a - 1.0) * jnp.log(y) + (b - 1.0) * jnp.log1p(-y)
                + gammaln(a + b) - gammaln(a) - gammaln(b))

    def sample(self, key, gamma, scale):
        a = self.link(gamma)
        b = jnp.broadcast_to(scale, jnp.shape(a))
        return jax.random.beta(key, a, b)


@dataclasses.dataclass(frozen=True)
class LogGaussianCox(ObservationFamily):
    """Log-Gaussian Cox process: events arrive with hazard exp(gamma(t)).

    As in the reference (Model.scala:363-369 leaves observation /
    dataLikelihood unimplemented), this family is only usable through the
    dedicated LGCP filter (fine-grid cumulative hazard,
    ParticleFilter.scala:169-227) and thinning simulator (Data.scala:110-149).
    """

    needs_scale = False

    def link(self, gamma):
        return jnp.exp(gamma)

    def log_density(self, gamma, y, scale):
        raise NotImplementedError(
            "LogGaussianCox has no pointwise likelihood; use "
            "inference.lgcp.lgcp_filter")

    def sample(self, key, gamma, scale):
        raise NotImplementedError(
            "LogGaussianCox is simulated by thinning; use "
            "utils.data.simulate_lgcp")
