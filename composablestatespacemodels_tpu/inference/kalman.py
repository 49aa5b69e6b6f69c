"""Exact Kalman filter for linear-Gaussian composed models.

The reference has no exact-inference oracle (SURVEY.md section 4 lists this as
a test gap).  Every reference SDE family has an exact diagonal Gaussian
transition and the Gaussian observation families observe ``y = F(t) . x + eps``
with ``eps ~ N(0, v^2)``, so the linear/seasonal models admit an exact Kalman
filter.  Used by the test-suite to cross-check the particle filter's log
marginal likelihood and filtering means.

One ``lax.scan`` over time; the state covariance is a full [d, d] matrix
(the scalar observation couples dimensions through F(t)).  Every product
runs at full float32 precision (``Precision.HIGHEST``): an oracle must not
inherit a GPU's TF32 default for float32 matmuls.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..models.model import Model
from ..models.observation import Gaussian
from ..models.tree import Tree
from ..utils.data import TimeSeries

_HALF_LOG_2PI = 0.9189385332046727
_HIGHEST = jax.lax.Precision.HIGHEST


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class KalmanResult:
    ll: jnp.ndarray           # scalar log marginal likelihood
    means: jnp.ndarray        # [T, d] filtered means (post-update)
    covs: jnp.ndarray         # [T, d, d] filtered covariances
    pred_obs: jnp.ndarray     # [T] predictive observation means
    pred_obs_var: jnp.ndarray # [T] predictive observation variances

    def tree_flatten(self):
        return ((self.ll, self.means, self.covs, self.pred_obs,
                 self.pred_obs_var), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@partial(jax.jit, static_argnames=("model",))
def _kalman_impl(model: Model, params: Tree, data: TimeSeries, t0):
    sde = model.sde
    sp = model.sde_params(params)
    v = model.obs_scale(params)  # observation sd
    r = v * v

    m0, c0 = sde.initial_moments(sp)
    d = m0.shape[0]

    def step(carry, inp):
        m, P, t_prev, ll = carry
        t, y, mask = inp

        a, b, q = sde.transition_coeffs(sp, t - t_prev)
        m_pred = a * m + b
        P_pred = a[:, None] * P * a[None, :] + jnp.diag(q)

        h = model.design_vector(t)
        y_hat = jnp.dot(h, m_pred, precision=_HIGHEST)
        ph = jnp.dot(P_pred, h, precision=_HIGHEST)
        s = jnp.dot(h, ph, precision=_HIGHEST) + r

        k = ph / s
        innov = y - y_hat
        m_upd = m_pred + k * innov
        P_upd = P_pred - jnp.outer(k, ph)
        ll_inc = -_HALF_LOG_2PI - 0.5 * jnp.log(s) - 0.5 * innov * innov / s

        m1 = jnp.where(mask, m_upd, m_pred)
        P1 = jnp.where(mask, P_upd, P_pred)
        ll1 = ll + jnp.where(mask, ll_inc, 0.0)
        return (m1, P1, t, ll1), (m1, P1, y_hat, s)

    t_start = data.ts[0] if t0 is None else jnp.asarray(t0, m0.dtype)
    init = (m0, jnp.diag(c0), t_start, jnp.asarray(0.0, m0.dtype))
    (_, _, _, ll), (means, covs, pred, pred_var) = jax.lax.scan(
        step, init, (data.ts, data.ys, data.mask))
    return KalmanResult(ll, means, covs, pred, pred_var)


def kalman_filter(model: Model, params: Tree, data: TimeSeries,
                  t0=None) -> KalmanResult:
    """Exact filtering for a linear-Gaussian (linear/seasonal) model."""
    model.validate_params(params)
    if not isinstance(model.obs, Gaussian):
        raise TypeError(
            "Kalman filtering requires a Gaussian observation model "
            f"(got {type(model.obs).__name__})")
    return _kalman_impl(model, params, data, t0)
