"""Particle-marginal Metropolis-Hastings (PMMH).

The reference drives PMMH through a lazy breeze MarkovChain wrapped in an Akka
Source (PMMH.scala:85-98).  Here the whole chain is one ``lax.scan`` whose
body inlines a full particle-filter sweep -- iterations never leave the
device, and independent chains vectorise with ``vmap`` (and shard across
devices over a mesh axis, see :mod:`..parallel`).

Semantic invariants preserved (PMMH.scala):

* acceptance log-ratio
  ``ll' + q(prop -> cur) + prior(prop) - q(cur -> prop) - ll - prior(cur)``
  (:72-73);
* the cached-likelihood variant reuses the previous PF estimate
  (ParticleMetropolisHastings, :114-123); the ``approx`` variant re-runs the
  filter for the current parameters every iteration (ApproxPMMH, :128-153);
* initial ll = -1e99 so the first proposal is always accepted (:121)
  (clamped to -1e30 here: finite in float32).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..models.model import Model
from ..models.tree import Tree
from ..utils.data import TimeSeries
from .filter import bootstrap_filter

_INIT_LL = -1e30


def flat_prior(params) -> jnp.ndarray:
    """Improper flat prior (the reference examples' default,
    DetermineParameters.scala:73)."""
    return jnp.asarray(0.0)


def symmetric_transition(frm, to) -> jnp.ndarray:
    """q(a -> b) = q(b -> a): cancels in the acceptance ratio."""
    return jnp.asarray(0.0)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class PmmhResult:
    """Stacked chain output (leading axis = iteration).

    Reference: ParamsState/MetropState, PMMH.scala:17-26.  With
    ``store_state`` the chain also carries each iteration's sampled latent
    final state (the reference ``MetropState.state: StateSpace`` fed by
    ``filterLlState``, PMMH.scala:26 / ParticleFilter.scala:346-357), so
    ``(params[i], states[i])`` are JOINT posterior draws -- the input
    :func:`~.filter.forecast_from_posterior` pairs.
    """

    params: object          # pytree stacked [iters, ...]
    lls: jnp.ndarray        # [iters]
    accepted: jnp.ndarray   # [iters] cumulative accepted count (int32)
    states: object = None   # [iters, d] sampled latent states (store_state)

    def tree_flatten(self):
        return ((self.params, self.lls, self.accepted, self.states), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n_iters(self) -> int:
        return int(self.lls.shape[-1])

    def acceptance_rate(self):
        """Mean per-iteration acceptance.

        Computed from the cumulative count's increments (clipped to 0/1):
        exact for fresh and chunk-stitched chains, and bounded by 1/n error
        for a chain resumed from an ``init_state`` carrying a prior count
        (where ``accepted[-1]/n`` could exceed 1).
        """
        inc = jnp.diff(self.accepted, axis=-1,
                       prepend=jnp.zeros_like(self.accepted[..., :1]))
        return jnp.mean(jnp.clip(inc, 0, 1), axis=-1)

    def thin(self, burn_in: int = 0, thin: int = 1) -> "PmmhResult":
        """Burn-in + thinning (reference Streaming.readPosterior,
        Streaming.scala:113-140).  The iteration axis is the last axis of
        ``lls`` (axis 0 single-chain, axis 1 for stacked chains)."""
        axis = self.lls.ndim - 1

        def take(x):
            return jax.lax.slice_in_dim(x, burn_in, x.shape[axis],
                                        stride=thin, axis=axis)

        return PmmhResult(jax.tree_util.tree_map(take, self.params),
                          take(self.lls), take(self.accepted),
                          None if self.states is None
                          else jax.tree_util.tree_map(take, self.states))


def make_pf_loglik(model: Model, data: TimeSeries, n_particles: int,
                   resample: str = "systematic",
                   store_state: bool = False,
                   unroll: int = 1) -> Callable:
    """Bundle a model + data into ``(key, params) -> ll``: the reference
    ``BootstrapFilter`` Reader (package.scala:23-24,
    ParticleFilter.filterLlState :346-348).

    With ``store_state`` the callable returns ``(ll, state)`` where
    ``state`` is ONE particle sampled uniformly from the final (resampled,
    hence uniformly weighted) cloud -- a draw from the filtering
    distribution at ``data.ts[-1]``, the reference ``filterLlState``'s
    sampled latent state (ParticleFilter.scala:346-357) that
    :func:`pmmh(store_state=True) <pmmh>` carries through the chain.

    ``unroll`` forwards to the filter scan -- at the reference's N~100
    the scan's fixed per-step cost dominates PMMH throughput.
    """
    def pf_ll(key, params):
        return bootstrap_filter(model, params, data, n_particles, key,
                                resample=resample, store="ll",
                                unroll=unroll).ll

    def pf_ll_state(key, params):
        k_pf, k_pick = jax.random.split(key)
        res = bootstrap_filter(model, params, data, n_particles, k_pf,
                               resample=resample, store="ll", unroll=unroll)
        i = jax.random.randint(k_pick, (), 0, n_particles)
        return res.ll, res.final_particles[i]

    return pf_ll_state if store_state else pf_ll


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class PmmhState:
    """Resumable chain state (the reference ``MetropState``, PMMH.scala:26).

    ``state`` is the carried sampled latent state under ``store_state``
    (the reference ``MetropState.state: StateSpace``); ``()`` otherwise.
    """

    params: object
    ll: jnp.ndarray
    accepted: jnp.ndarray
    state: object = ()

    def tree_flatten(self):
        return ((self.params, self.ll, self.accepted, self.state), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def initial_state(params: Tree) -> PmmhState:
    """ll = -1e30 so the first proposal is always accepted (PMMH.scala:121)."""
    return PmmhState(params, jnp.asarray(_INIT_LL, jnp.result_type(float)),
                     jnp.asarray(0, jnp.int32))


def _mh_scan(key, init: PmmhState, pf_ll, proposal, prior,
             log_transition, n_iters: int, approx: bool,
             store_state: bool = False):

    def eval_ll(k, p):
        out = pf_ll(k, p)
        return out if store_state else (out, ())

    def mh_step(carry, k):
        params, ll, state, accepted = carry
        k_prop, k_pf, k_pf_old, k_u = jax.random.split(k, 4)

        prop = proposal(k_prop, params)
        ll_prop, s_prop = eval_ll(k_pf, prop)
        if approx:
            # doubly-stochastic: refresh the current params' estimate too
            # (ApproxPMMH, PMMH.scala:138-152); the refreshed state stays
            # paired with the refreshed ll
            ll_cur, s_cur = eval_ll(k_pf_old, params)
        else:
            ll_cur, s_cur = ll, state

        a = (ll_prop + log_transition(prop, params) + prior(prop)
             - log_transition(params, prop) - ll_cur - prior(params))
        accept = jnp.log(jax.random.uniform(k_u, (), jnp.result_type(float))) < a

        new_params = jax.tree_util.tree_map(
            lambda p, q: jnp.where(accept, q, p), params, prop)
        new_ll = jnp.where(accept, ll_prop, ll_cur)
        new_state = jax.tree_util.tree_map(
            lambda c, q: jnp.where(accept, q, c), s_cur, s_prop)
        new_acc = accepted + accept.astype(jnp.int32)
        carry1 = (new_params, new_ll, new_state, new_acc)
        return carry1, carry1

    keys = jax.random.split(key, n_iters)
    carry, (ps, lls, states, accs) = jax.lax.scan(
        mh_step, (init.params, init.ll, init.state, init.accepted), keys)
    final = PmmhState(carry[0], carry[1], carry[3], carry[2])
    return PmmhResult(ps, lls, accs, states if store_state else None), final


@partial(jax.jit, static_argnames=("pf_ll", "proposal", "prior",
                                   "log_transition", "n_iters", "approx",
                                   "store_state"))
def _pmmh_jit(key, init, pf_ll, proposal, prior, log_transition,
              n_iters, approx, store_state):
    return _mh_scan(key, init, pf_ll, proposal, prior, log_transition,
                    n_iters, approx, store_state)


def _seed_latent(init: PmmhState, pf_ll, key, store_state: bool) -> PmmhState:
    """Give a fresh chain a latent-state carry of the right shape.

    The zeros never reach the output: the first proposal is always
    accepted (initial ll = -1e30), which overwrites the carry with the
    first PF's sampled state.
    """
    fresh = isinstance(init.state, tuple) and init.state == ()
    if not store_state:
        # a store_state checkpoint resumed with the flag off: drop the
        # latent carry rather than tree_map an array against ()
        return init if fresh else dataclasses.replace(init, state=())
    if not fresh:
        return init
    shape = jax.eval_shape(lambda k, p: pf_ll(k, p), key, init.params)
    if not (isinstance(shape, tuple) and len(shape) == 2):
        raise ValueError(
            "store_state=True requires an evaluator returning (ll, state) "
            "-- build it with make_pf_loglik(..., store_state=True)")
    zeros = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), shape[1])
    return dataclasses.replace(init, state=zeros)


def pmmh(key, init_params: Tree, pf_ll: Callable, proposal: Callable,
         n_iters: int, *,
         prior: Callable = flat_prior,
         log_transition: Callable = symmetric_transition,
         approx: bool = False,
         store_state: bool = False,
         init_state: Optional["PmmhState"] = None,
         return_state: bool = False):
    """Run one PMMH chain.

    Args:
      key: PRNG key.
      init_params: starting parameter tree.
      pf_ll: ``(key, params) -> log-likelihood`` (see :func:`make_pf_loglik`).
      proposal: ``(key, params) -> params`` (e.g. ``models.params.perturb``).
      n_iters: chain length.
      prior: ``params -> log-prior`` (default flat).
      log_transition: ``(from, to) -> log q(to | from)`` (default symmetric).
      approx: re-evaluate the current parameters' likelihood each iteration
        (the reference ApproxPMMH).
      store_state: carry each iteration's sampled latent state through the
        chain (the reference ``MetropState.state``, PMMH.scala:26); requires
        ``pf_ll`` built with ``make_pf_loglik(..., store_state=True)`` (it
        must return ``(ll, state)``).  The result's ``states[i]`` is then a
        JOINT posterior draw with ``params[i]`` -- feed both to
        :func:`~.filter.forecast_from_posterior`.

      init_state: resume from a previous :class:`PmmhState` (checkpointed
        chains); overrides ``init_params``.
      return_state: also return the final :class:`PmmhState`.

    Reference call stack: DeterminePosterior, DetermineParameters.scala:55-85.
    """
    init = initial_state(init_params) if init_state is None else init_state
    init = _seed_latent(init, pf_ll, key, store_state)
    result, final = _pmmh_jit(key, init, pf_ll, proposal, prior,
                              log_transition, n_iters, approx, store_state)
    return (result, final) if return_state else result


def pmmh_chains(key, init_params: Tree, pf_ll: Callable, proposal: Callable,
                n_iters: int, n_chains: int, *,
                prior: Callable = flat_prior,
                log_transition: Callable = symmetric_transition,
                approx: bool = False,
                store_state: bool = False) -> PmmhResult:
    """Run several independent chains with ``vmap`` (the replacement for
    the reference's ``mapAsync(2)`` thread parallelism,
    DetermineParameters.scala:68-69).  Outputs gain a leading chain axis.
    """
    keys = jax.random.split(key, n_chains)

    @partial(jax.jit, static_argnames=())
    def run_all(keys, init_params):
        def one(k):
            init = _seed_latent(initial_state(init_params), pf_ll, k,
                                store_state)
            return _mh_scan(k, init, pf_ll, proposal, prior, log_transition,
                            n_iters, approx, store_state)[0]

        return jax.vmap(one)(keys)

    return run_all(keys, init_params)


def adaptive_pmmh(key, init_params: Tree, pf_ll: Callable, n_iters: int, *,
                  pilot_iters: int = 1000,
                  pilot_delta: float = 0.05,
                  burn_in: Optional[int] = None,
                  thin: int = 2,
                  scale: Optional[float] = None,
                  nugget: Optional[float] = None,
                  prior: Callable = flat_prior,
                  log_transition: Callable = symmetric_transition,
                  approx: bool = False,
                  return_pilot: bool = False):
    """Two-phase adaptive PMMH.

    Phase 1 runs a pilot chain with an iid Gaussian random walk
    (``perturb(pilot_delta)``); its thinned posterior sample estimates the
    parameter covariance (``covariance_params``), and phase 2 runs the main
    chain with the correlated ``perturb_mvn_eigen(scale * cov)`` proposal
    starting from the pilot's final state -- the workflow the reference's
    proposal machinery implies (Parameters.scala:111-123 adaptive MVN
    proposals fed by Utilities.scala:11-18 sample moments) but never
    packages.

    Args:
      key: PRNG key.
      init_params: pilot chain start.
      pf_ll: ``(key, params) -> ll`` (see :func:`make_pf_loglik`).
      n_iters: main-chain length.
      pilot_iters: pilot-chain length.
      pilot_delta: pilot random-walk variance per entry.
      burn_in: pilot burn-in before estimating moments (default: half).
      thin: pilot thinning for the moment estimate.
      scale: covariance multiplier; default the optimal random-walk scaling
        ``2.38^2 / dim`` (Roberts & Rosenthal).
      nugget: diagonal jitter added to the pilot covariance so a
        degenerate pilot (few acceptances) cannot freeze the main chain;
        default ``1e-6 * pilot_delta``.
      return_pilot: also return the pilot :class:`PmmhResult`.

    Returns the main chain's :class:`PmmhResult` (and the pilot's when
    ``return_pilot``).
    """
    from ..models.params import covariance_params, perturb, perturb_mvn_eigen

    k_pilot, k_main = jax.random.split(key)
    pilot = pmmh(k_pilot, init_params, pf_ll, perturb(pilot_delta),
                 pilot_iters, prior=prior, log_transition=log_transition,
                 approx=approx)
    b = pilot_iters // 2 if burn_in is None else burn_in
    kept = pilot.thin(burn_in=b, thin=thin)
    cov = jnp.atleast_2d(covariance_params(kept.params))
    dim = cov.shape[0]
    if scale is None:
        scale = 2.38 ** 2 / dim
    if nugget is None:
        nugget = 1e-6 * pilot_delta
    cov = scale * cov + nugget * jnp.eye(dim, dtype=cov.dtype)

    last = jax.tree_util.tree_map(lambda x: x[-1], pilot.params)
    result = pmmh(k_main, last, pf_ll, perturb_mvn_eigen(cov), n_iters,
                  prior=prior, log_transition=log_transition, approx=approx)
    return (result, pilot) if return_pilot else result


# ---------------------------------------------------------------------------
# diagnostics (reference Streaming.scala:19-105)
# ---------------------------------------------------------------------------


def pilot_run(model: Model, params: Tree, data: TimeSeries, key,
              particle_counts=(100, 200, 500, 1000, 2000), n_reps: int = 100,
              resample: str = "systematic"):
    """Variance of the PF log-likelihood estimate at several particle counts.

    Used to choose N for PMMH (aim: ll variance around 1).  The reference
    fans repetitions over 4 threads (Streaming.pilotRun, :19-40); here each
    count's repetitions are one ``vmap``.

    Each particle count is a distinct static shape, so the filter
    compiles once per count: a one-off cost of fixed-shape XLA programs.

    Returns a list of ``(n_particles, mean_ll, var_ll)``.
    """
    out = []
    for i, n in enumerate(particle_counts):
        k_n = jax.random.fold_in(key, i)
        pf_ll = make_pf_loglik(model, data, int(n), resample)
        keys = jax.random.split(k_n, n_reps)
        lls = jax.jit(jax.vmap(lambda k: pf_ll(k, params)))(keys)
        out.append((int(n), float(jnp.mean(lls)), float(jnp.var(lls))))
    return out


def gelman_rubin(chain_values: jnp.ndarray) -> jnp.ndarray:
    """Potential scale reduction factor R-hat over [n_chains, n_iters].

    The reference delegates convergence diagnostics to R/coda
    (R/Plots.R:97-107); provided natively here.
    """
    m, n = chain_values.shape
    if m < 2:
        raise ValueError(
            f"gelman_rubin needs at least 2 chains, got {m} (shape "
            f"[n_chains, n_iters])")
    chain_means = jnp.mean(chain_values, axis=1)
    grand = jnp.mean(chain_means)
    b = n / (m - 1) * jnp.sum((chain_means - grand) ** 2)
    w = jnp.mean(jnp.var(chain_values, axis=1, ddof=1))
    var_hat = (n - 1) / n * w + b / n
    return jnp.sqrt(var_hat / w)


def effective_chain_size(values: jnp.ndarray, max_lag: int = 200) -> float:
    """MCMC effective sample size via initial-positive-sequence autocorr.

    All lags at once via one FFT-based autocorrelation (a Python loop of
    per-lag reductions traced ~200 separate O(n) ops).
    """
    x = values - jnp.mean(values)
    n = x.shape[0]
    var = jnp.var(values)
    max_lag = min(max_lag, n - 1)
    f = jnp.fft.rfft(x, 2 * n)
    full = jnp.fft.irfft(f * jnp.conj(f), 2 * n)[:n]  # sum x[:n-lag]*x[lag:]
    acf = full[1:max_lag + 1] / (n * var)
    positive = jnp.cumprod(acf > 0)
    tau = 1.0 + 2.0 * jnp.sum(acf * positive)
    return float(n / jnp.maximum(tau, 1.0))
