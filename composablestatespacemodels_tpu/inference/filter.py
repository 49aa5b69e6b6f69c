"""Bootstrap particle filter as a single ``lax.scan`` over time.

The reference's Akka ``Flow.scan(stepFilter)`` (ParticleFilter.scala:116-166)
becomes one jitted scan:

* particle propagation, weighting and the log-sum-exp update are fused
  ``[N]``-wide vector ops (the weights through one design-vector
  contraction);
* resampling is a cumulative sum + closed-form position counts (see
  :mod:`.resampling`), executed under a scalar ``lax.cond`` so
  missing-observation steps skip the gather entirely;
* irregular observation times and missing observations are *data*
  (``dt = t_i - t_{i-1}`` and a boolean mask), not control flow, so the whole
  filter compiles once for a given (model, N, T) shape.

Semantic invariants preserved from the reference (ParticleFilter.scala):

* resample at **every** observation (:129 -- the default; an optional
  ESS-threshold trigger generalises this without changing the default path);
* ``ll += max + log(mean(exp(w - max)))`` (:124-127);
* ESS = floor(1 / sum(w_hat^2)) (:431-434);
* missing observation => propagate only, ll/ESS unchanged (:120-121);
* a fixed-init variant (FilterInit, :252-271).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..models.model import Model
from ..models.tree import Tree
from ..utils.data import TimeSeries
from . import resampling as rs


# ---------------------------------------------------------------------------
# summaries
# ---------------------------------------------------------------------------


def credible_interval_eta(samples, interval: float = 0.975):
    """Order-statistic interval, eta flavour.

    Reference: ParticleFilter.getOrderStatistic (:455-460):
    lower = sorted[n - idx], upper = sorted[idx], idx = floor(n * interval).
    """
    n = samples.shape[0]
    idx = math.floor(n * interval)
    s = jnp.sort(samples, axis=0)
    return s[n - idx], s[min(idx, n - 1)]


def credible_interval_state(samples, interval: float = 0.975):
    """Order-statistic interval, state flavour (off-by-one as in reference).

    Reference: ParticleFilter.getCredibleInterval (:488-502):
    lower = sorted[n - idx - 1], upper = sorted[idx - 1].
    Works on [N] or [N, d] (per-column).
    """
    n = samples.shape[0]
    idx = math.floor(n * interval)
    s = jnp.sort(samples, axis=0)
    return s[n - idx - 1], s[idx - 1]


def _interval_levels(n: int, interval: float):
    """Weighted-CDF levels equivalent to the unweighted order-statistic
    indices of :func:`credible_interval_state` / :func:`credible_interval_eta`.

    For uniform weights, "smallest x with weighted CDF >= (j+1)/n" is
    ``sorted[j]``, so these levels reproduce the reference's indices
    (ParticleFilter.scala:455-460, 488-502) exactly -- including the
    index wrap mod n that the transposed path mirrors for edge intervals.
    Returns ``(state_levels, eta_levels)``, each a 2-tuple (lower, upper).
    """
    idx = math.floor(n * interval)
    j_s = ((n - idx - 1) % n, (idx - 1) % n)        # state flavour
    j_e = ((n - idx) % n, min(idx, n - 1))          # eta flavour
    return (tuple((j + 1) / n for j in j_s),
            tuple((j + 1) / n for j in j_e))


def _weighted_quantile_sorted(cols, wn, ps):
    """Sort-based weighted quantiles, any dtype: per row c of ``cols``
    [c, n], the smallest value with weighted CDF >= ps[c][q] (the XLA
    fallback twin of :func:`..ops.selection.weighted_quantile_bits`).

    Used by the ``ess_threshold`` summary paths where skipped resamples
    leave carried weights non-uniform (the reference always resamples,
    ParticleFilter.scala:129, so it has no weighted flavour to mirror).
    """
    order = jnp.argsort(cols, axis=1)
    s = jnp.take_along_axis(cols, order, axis=1)
    w = jnp.take_along_axis(
        jnp.broadcast_to(wn[None, :].astype(cols.dtype), cols.shape),
        order, axis=1)
    cum = jnp.cumsum(w, axis=1)                      # [c, n] inclusive CDF
    total = cum[:, -1]                               # [c]
    th = jnp.asarray(ps, cols.dtype) * total[:, None]          # [c, q]
    i = jnp.sum((cum[:, :, None] < th[:, None, :]), axis=1)    # [c, q]
    i = jnp.clip(i, 0, cols.shape[1] - 1)
    return jnp.take_along_axis(s, i, axis=1)         # [c, q]


def _weighted_pick(x, wn, key):
    """One particle sampled with probability proportional to ``wn``
    (inverse-CDF on a single uniform): the weighted generalisation of the
    reference's uniform ``sampleOne`` used by ``store='path'`` when
    ``ess_threshold`` leaves carried weights non-uniform."""
    u = jax.random.uniform(key, (), wn.dtype) * jnp.sum(wn)
    j = jnp.clip(jnp.searchsorted(jnp.cumsum(wn), u), 0, wn.shape[0] - 1)
    return j


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class PfSummary:
    """Per-step filtering summaries (the reference ``PfOut``,
    ParticleFilter.scala:53-59 + getIntervals :415-424)."""

    ts: jnp.ndarray           # [T]
    eta_mean: jnp.ndarray     # [T]     link(f(mean state, t))
    eta_lower: jnp.ndarray    # [T]
    eta_upper: jnp.ndarray    # [T]
    state_mean: jnp.ndarray   # [T, d]
    state_lower: jnp.ndarray  # [T, d]
    state_upper: jnp.ndarray  # [T, d]

    def tree_flatten(self):
        return ((self.ts, self.eta_mean, self.eta_lower, self.eta_upper,
                 self.state_mean, self.state_lower, self.state_upper), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class FilterResult:
    """Output of :func:`bootstrap_filter`.

    ``ll`` is the log marginal-likelihood estimate; ``ll_history`` its
    cumulative trajectory; ``ess`` the per-step effective sample size
    (reference ``PfState``, ParticleFilter.scala:32-37).
    """

    ll: jnp.ndarray                       # scalar
    ll_history: jnp.ndarray               # [T]
    ess: jnp.ndarray                      # [T] int32
    final_particles: jnp.ndarray          # [N, d]
    summary: Optional[PfSummary]          # store='summary'
    sampled_path: Optional[jnp.ndarray]   # [T, d] when store='path'

    def tree_flatten(self):
        return ((self.ll, self.ll_history, self.ess, self.final_particles,
                 self.summary, self.sampled_path), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


# ---------------------------------------------------------------------------
# the filter
# ---------------------------------------------------------------------------


def _make_save_fn(model: Model, store, interval: float,
                  weighted: bool = False):
    """Save functions take ``(t, particles, wn, key)``; ``wn`` are the
    carried normalised weights after the step.  With ``weighted`` (set iff
    an ``ess_threshold`` can skip resamples, leaving ``wn`` non-uniform),
    summaries/paths are weight-aware; otherwise ``wn`` is uniform at every
    save point and the unweighted reference semantics apply bit-for-bit
    (ParticleFilter.scala:415-424)."""
    if store == "ll" or store is None:
        return lambda t, particles, wn, key: ()
    if store == "path":
        if weighted:
            def save(t, particles, wn, key):
                return particles[_weighted_pick(particles, wn, key)]
        else:
            # one uniformly sampled particle per step (reference filter(),
            # ParticleFilter.scala:152-158 + Resampling.sampleOne)
            def save(t, particles, wn, key):
                i = jax.random.randint(key, (), 0, particles.shape[0])
                return particles[i]
        return save
    if store == "summary":
        if weighted:
            def save(t, particles, wn, key):
                n, d = particles.shape
                mean = jnp.sum(wn[:, None] * particles, axis=0) / jnp.sum(wn)
                etas = model.link(model.f(particles, t))
                eta_mean = model.link(model.f(mean, t))
                ps_s, ps_e = _interval_levels(n, interval)
                cols = jnp.concatenate(
                    [particles.T, etas[None].astype(particles.dtype)], axis=0)
                sel = _weighted_quantile_sorted(
                    cols, wn, [list(ps_s)] * d + [list(ps_e)])   # [d+1, 2]
                return (eta_mean, sel[d, 0], sel[d, 1],
                        mean, sel[:d, 0], sel[:d, 1])
        else:
            def save(t, particles, wn, key):
                mean = jnp.mean(particles, axis=0)
                s_lo, s_hi = credible_interval_state(particles, interval)
                etas = model.link(model.f(particles, t))
                eta_mean = model.link(model.f(mean, t))
                e_lo, e_hi = credible_interval_eta(etas, interval)
                return (eta_mean, e_lo, e_hi, mean, s_lo, s_hi)
        return save
    if callable(store):
        # documented custom contract stays (t, particles, key); the cloud
        # is post-step, weights available only to the built-in modes
        return lambda t, particles, wn, key: store(t, particles, key)
    raise ValueError(f"unknown store mode {store!r}")


@partial(jax.jit,
         static_argnames=("model", "n_particles", "resample", "store",
                          "ess_threshold", "interval", "unroll"))
def _filter_impl(model: Model, params: Tree, data: TimeSeries,
                 n_particles: int, key, t0, x_init,
                 resample: str, store, ess_threshold, interval: float,
                 unroll: int = 1):
    """``unroll``: forwarded to the per-step ``lax.scan``.  At reference
    PMMH shapes (N=100) the scan's fixed per-step cost is most of the
    work, and unrolling can amortise it."""
    resample_fn = rs.get_scheme(resample)
    save_fn = _make_save_fn(model, store, interval,
                            weighted=ess_threshold is not None)

    k_init, k_scan = jax.random.split(key)
    if x_init is None:
        particles = model.initial_state(params, k_init, (n_particles,))
    else:
        x_init = jnp.asarray(x_init)
        if x_init.ndim == 1:
            # FilterInit: every particle starts at the supplied state
            # (ParticleFilter.scala:252-271)
            particles = jnp.broadcast_to(x_init, (n_particles,) + x_init.shape)
        else:
            particles = x_init

    dtype = particles.dtype
    n = particles.shape[0]
    # carried normalised weights; uniform under always-resample, general
    # under an ESS-threshold trigger
    wn0 = jnp.full((n,), 1.0 / n, dtype=dtype)

    def step(carry, inp):
        particles, wn, t_prev, ll, ess = carry
        t, y, mask, k = inp
        k_prop, k_res, k_save = jax.random.split(k, 3)

        dt = t - t_prev
        x1 = model.step(params, k_prop, particles, dt)

        # -- weights (masked: a missing observation contributes nothing) ----
        y_safe = jnp.where(mask, y, 0.0)
        gamma = model.f(x1, t)
        logw = model.log_density(params, gamma, y_safe)
        logw = jnp.where(mask, logw, 0.0)

        maxw = jnp.max(logw)
        u = wn * jnp.exp(logw - maxw)           # unnormalised updated weights
        total = jnp.sum(u)
        ll_inc = jnp.where(mask, maxw + jnp.log(total), 0.0)
        wn1 = u / total

        ess1 = jnp.where(
            mask,
            jnp.floor(1.0 / jnp.sum(wn1 * wn1)).astype(jnp.int32),
            ess)

        if ess_threshold is None:
            do_resample = mask
        else:
            do_resample = mask & (ess1 < ess_threshold * n)

        def yes(args):
            x, w = args
            idx = resample_fn(k_res, w)
            return x[idx], jnp.full((n,), 1.0 / n, dtype=dtype)

        def no(args):
            return args

        x2, wn2 = jax.lax.cond(do_resample, yes, no, (x1, wn1))

        ll1 = ll + ll_inc
        out = (save_fn(t, x2, wn2, k_save), ll1, ess1)
        return (x2, wn2, t, ll1, ess1), out

    t_start = data.ts[0] if t0 is None else jnp.asarray(t0, dtype)
    keys = jax.random.split(k_scan, data.ts.shape[0])
    init = (particles, wn0, t_start, jnp.asarray(0.0, dtype),
            jnp.asarray(n, jnp.int32))
    (final_particles, _, _, ll, _), (saved, ll_hist, ess_hist) = jax.lax.scan(
        step, init, (data.ts, data.ys, data.mask, keys), unroll=unroll)

    summary = None
    path = None
    if store == "summary":
        eta_mean, e_lo, e_hi, s_mean, s_lo, s_hi = saved
        summary = PfSummary(data.ts, eta_mean, e_lo, e_hi, s_mean, s_lo, s_hi)
    elif store == "path":
        path = saved

    return FilterResult(ll, ll_hist, ess_hist, final_particles, summary, path)


def bootstrap_filter(model: Model, params: Tree, data: TimeSeries,
                     n_particles: int, key, *,
                     resample: str = "systematic",
                     t0: Optional[float] = None,
                     initial_state=None,
                     store="summary",
                     ess_threshold: Optional[float] = None,
                     interval: float = 0.975,
                     unroll: int = 1,
                     mesh=None, **mesh_kwargs) -> FilterResult:
    """Run the bootstrap particle filter over a time series.

    Args:
      model: a (possibly composed) model spec.
      params: parameter tree matching the model composition.
      data: observations (irregular times and missing values supported).
      n_particles: N.
      key: PRNG key.
      resample: 'systematic' | 'stratified' | 'multinomial' | 'residual' |
        'identity' or a custom ``(key, weights) -> indices`` kernel.
      t0: filter start time (default: time of the first observation, as the
        reference ``llFilter``/``filter``, ParticleFilter.scala:137-158).
      initial_state: optional fixed initial state ``[d]`` (FilterInit) or a
        full initial particle cloud ``[N, d]``.
      store: 'summary' (PfOut-style per-step summaries), 'path' (one sampled
        trajectory), 'll' (log-likelihood and ESS only -- the PMMH fast
        path), or a callable ``(t, particles, key) -> pytree``.
      ess_threshold: if set, resample only when ESS < threshold * N
        (the reference always resamples at an observation; this generalises).
      interval: credible-interval level for summaries.
      unroll: per-step ``lax.scan`` unroll factor (single-device paths
        only).  At reference PMMH shapes (N~100) the scan's fixed
        per-step overhead dominates, and unrolling amortises it; at
        large N it only bloats compile time.  Default 1.
      mesh: optional ``jax.sharding.Mesh`` with a
        :data:`~..parallel.mesh.PARTICLE_AXIS` axis: shard the particle
        cloud over it and run the multi-device filter (distributed
        systematic resampling; see :mod:`..parallel.sharded_filter`).
        Only ``resample='systematic'`` is supported on a mesh.
    """
    rs.get_scheme(resample)   # an unknown name raises, listing the schemes
    if mesh is not None:
        from ..parallel.sharded_filter import sharded_bootstrap_filter

        if unroll != 1:
            raise ValueError("unroll is single-device only (got mesh=)")
        if resample != "systematic":
            raise ValueError(
                f"mesh= requires resample='systematic' (got {resample!r}); "
                "distributed resampling shares one uniform across shards")
        return sharded_bootstrap_filter(
            model, params, data, n_particles, key, mesh, t0=t0,
            initial_state=initial_state, store=store,
            ess_threshold=ess_threshold, interval=interval, **mesh_kwargs)
    if mesh_kwargs:
        raise TypeError(
            f"unexpected arguments {sorted(mesh_kwargs)} (only valid with "
            "mesh=)")
    model.validate_params(params)
    return _filter_impl(model=model, params=params, data=data,
                        n_particles=n_particles, key=key, t0=t0,
                        x_init=initial_state, resample=resample, store=store,
                        ess_threshold=ess_threshold, interval=interval,
                        unroll=unroll)


def log_likelihood(model: Model, params: Tree, data: TimeSeries,
                   n_particles: int, key, *,
                   resample: str = "systematic",
                   **kwargs) -> jnp.ndarray:
    """Log marginal-likelihood estimate only (reference ``llFilter``,
    ParticleFilter.scala:137-140)."""
    return bootstrap_filter(model, params, data, n_particles, key,
                            resample=resample, store="ll", **kwargs).ll


# ---------------------------------------------------------------------------
# forecasting (reference: ParticleFilter.scala:368-410)
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Forecast:
    """Reference ``ForecastOut`` (ParticleFilter.scala:71-78)."""

    t: jnp.ndarray
    obs_mean: jnp.ndarray
    obs_lower: jnp.ndarray
    obs_upper: jnp.ndarray
    eta_mean: jnp.ndarray
    eta_lower: jnp.ndarray
    eta_upper: jnp.ndarray
    state_mean: jnp.ndarray
    state_lower: jnp.ndarray
    state_upper: jnp.ndarray

    def tree_flatten(self):
        return ((self.t, self.obs_mean, self.obs_lower, self.obs_upper,
                 self.eta_mean, self.eta_lower, self.eta_upper,
                 self.state_mean, self.state_lower, self.state_upper), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ForecastCloud:
    """Per-particle predictive draws at one future time.

    The reference ``getForecast`` returns the full per-particle
    ``Vector[ObservationWithState]`` (sdeState, gamma, eta and a sampled
    observation per particle -- ParticleFilter.scala:368-390);
    :class:`Forecast` is its pooled ``getMeanForecast`` flavour
    (:368-410).  ``summarise`` reproduces the pooled view exactly.
    """

    t: jnp.ndarray      # scalar forecast time
    state: jnp.ndarray  # [N, d] propagated latent states (sdeState)
    gamma: jnp.ndarray  # [N] linear predictor f(x, t)
    eta: jnp.ndarray    # [N] link(gamma)
    obs: jnp.ndarray    # [N] sampled observations

    def tree_flatten(self):
        return ((self.t, self.state, self.gamma, self.eta, self.obs), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def summarise(self, interval: float = 0.995) -> Forecast:
        """Pool the cloud into the :class:`Forecast` summary (the
        reference ``getMeanForecast``, ParticleFilter.scala:392-410)."""
        s_lo, s_hi = credible_interval_state(self.state, interval)
        e_lo, e_hi = credible_interval_eta(self.eta, interval)
        o_lo, o_hi = credible_interval_eta(self.obs, interval)
        return Forecast(self.t, jnp.mean(self.obs), o_lo, o_hi,
                        jnp.mean(self.eta), e_lo, e_hi,
                        jnp.mean(self.state, axis=0), s_lo, s_hi)


@partial(jax.jit, static_argnames=("model",))
def forecast_cloud(model: Model, params: Tree, particles, t_prev, t,
                   key) -> ForecastCloud:
    """Advance a filtering particle cloud to time ``t`` and return the
    per-particle predictive draws (reference ``getForecast``,
    ParticleFilter.scala:368-390).  ``particles`` should be an
    (exchangeable) post-resampling cloud, e.g.
    ``FilterResult.final_particles``."""
    k_step, k_obs = jax.random.split(key)
    x1 = model.step(params, k_step, particles, t - t_prev)
    gamma = model.f(x1, t)
    return ForecastCloud(jnp.asarray(t), x1, gamma, model.link(gamma),
                         model.sample_obs(k_obs, params, gamma))


@partial(jax.jit, static_argnames=("model", "interval"))
def forecast(model: Model, params: Tree, particles, t_prev, t, key,
             interval: float = 0.995) -> Forecast:
    """Advance a filtering particle cloud to time ``t`` and summarise the
    predictive distribution (reference getForecast/getMeanForecast,
    ParticleFilter.scala:368-410).  For the per-particle cloud itself use
    :func:`forecast_cloud` (same key -> identical draws)."""
    return forecast_cloud(model, params, particles, t_prev, t,
                          key).summarise(interval)


def forecast_times(model: Model, params: Tree, particles, t_prev, ts, key,
                   interval: float = 0.995) -> Forecast:
    """Iterated forecast over a sequence of future times via ``lax.scan``."""
    ts = jnp.asarray(ts)

    def body(carry, inp):
        x, tp = carry
        t, k = inp
        k_step, k_obs = jax.random.split(k)
        x1 = model.step(params, k_step, x, t - tp)
        gamma = model.f(x1, t)
        eta = model.link(gamma)
        obs = model.sample_obs(k_obs, params, gamma)
        s_lo, s_hi = credible_interval_state(x1, interval)
        e_lo, e_hi = credible_interval_eta(eta, interval)
        o_lo, o_hi = credible_interval_eta(obs, interval)
        out = Forecast(t, jnp.mean(obs), o_lo, o_hi, jnp.mean(eta), e_lo,
                       e_hi, jnp.mean(x1, axis=0), s_lo, s_hi)
        return (x1, t), out

    keys = jax.random.split(key, ts.shape[0])
    _, out = jax.lax.scan(body, (particles, jnp.asarray(t_prev)), (ts, keys))
    return out


def forecast_from_posterior(model: Model, stacked_params, key, t0, ts,
                            n_samples: int, state_samples=None,
                            interval: float = 0.995) -> Forecast:
    """Forecast driven by posterior parameter (and optionally state) draws.

    The reference version resamples (params, state) pairs from the JOINT
    posterior and simulates each forward (SimulateData.forecast,
    Data.scala:202-231).  Here each posterior draw gets its own latent
    trajectory via one vmapped scan; summaries pool over draws.

    Args:
      model: model spec.
      stacked_params: parameter pytree with a leading sample axis (e.g. a
        thinned ``PmmhResult.params``).
      key: PRNG key.
      t0: forecast start time.
      ts: future times [T].
      n_samples: number of posterior draws to propagate.
      state_samples: optional [k, d] initial latent states.  When ``k``
        equals the number of parameter draws, row ``i`` is treated as the
        JOINT posterior partner of parameter draw ``i`` (e.g. a
        ``pmmh(store_state=True)`` result) and the pairing is preserved
        through the resampling, matching the reference's
        ``Rand[(Parameters, State)]`` draws (Data.scala:202-217).
        Otherwise (an exchangeable filtering cloud of any size) states are
        sampled uniformly and independently of the parameter draws.
        Default: fresh draws from each parameter set's initial
        distribution.
    """
    ts = jnp.asarray(ts)
    leaves = jax.tree_util.tree_leaves(stacked_params)
    n_avail = leaves[0].shape[0]
    k_pick, k_init, k_scan = jax.random.split(key, 3)
    idx = jax.random.randint(k_pick, (n_samples,), 0, n_avail)
    picked = jax.tree_util.tree_map(lambda x: x[idx], stacked_params)

    def init_one(k, p):
        return model.initial_state(p, k)

    if state_samples is None:
        x0 = jax.vmap(init_one)(jax.random.split(k_init, n_samples), picked)
    else:
        state_samples = jnp.asarray(state_samples)
        if state_samples.shape[0] == n_avail:
            # joint posterior draws: keep the (params, state) pairing
            x0 = state_samples[idx]
        else:
            # exchangeable cloud: independent uniform draws
            j = jax.random.randint(k_init, (n_samples,), 0,
                                   state_samples.shape[0])
            x0 = state_samples[j]

    def sim_one(k, p, x):
        def body(carry, inp):
            xc, tp = carry
            t, kk = inp
            k1, k2 = jax.random.split(kk)
            x1 = model.step(p, k1, xc, t - tp)
            gamma = model.f(x1, t)
            y = model.sample_obs(k2, p, gamma)
            return (x1, t), (x1, model.link(gamma), y)

        keys = jax.random.split(k, ts.shape[0])
        _, out = jax.lax.scan(body, (x, jnp.asarray(t0, x.dtype)), (ts, keys))
        return out

    xs, etas, obs = jax.vmap(sim_one)(
        jax.random.split(k_scan, n_samples), picked, x0)
    # pool over draws per future time: [T] summaries
    sw = lambda a: jnp.swapaxes(a, 0, 1)
    xs, etas, obs = sw(xs), sw(etas), sw(obs)

    s_lo, s_hi = jax.vmap(lambda x: credible_interval_state(x, interval))(xs)
    e_lo, e_hi = jax.vmap(lambda e: credible_interval_eta(e, interval))(etas)
    o_lo, o_hi = jax.vmap(lambda o: credible_interval_eta(o, interval))(obs)
    return Forecast(ts, jnp.mean(obs, axis=1), o_lo, o_hi,
                    jnp.mean(etas, axis=1), e_lo, e_hi,
                    jnp.mean(xs, axis=1), s_lo, s_hi)
