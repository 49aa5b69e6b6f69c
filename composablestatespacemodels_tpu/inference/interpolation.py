"""Path-storing particle filter for interpolation / missing-data smoothing.

The reference ``FilterInterpolate`` (ParticleFilter.scala:273-311) carries a
``Vector[List[State]]`` of full ancestral paths and resamples entire paths at
every observation -- memory-hostile copying (SURVEY.md section 7 step 8).

Design: store the *pre-resample* states ``[T, N, d]`` and the per-step
resampling indices ``[T, N]`` during one forward ``lax.scan``, then
reconstruct the surviving ancestral paths with a backward index scan -- the
standard genealogy trick.  Total memory O(T*N*d) with zero path copying
inside the filter loop.  ``store='summary'`` goes further: only the
``[T, N]`` int32 genealogy is stored and a second scan rematerialises each
step's cloud from the same PRNG keys (O(T*N) memory, one extra propagate
pass) -- counter-based ``jax.random`` makes replay free of state.
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


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class InterpolationResult:
    """Smoothed (ancestral-path) particle clouds at every observation time.

    ``paths[t, j]`` is the state at time ``ts[t]`` of the j-th surviving
    particle lineage -- the reference's reversed path particles
    (ParticleFilter.scala:303-310).
    """

    ll: jnp.ndarray
    ess: jnp.ndarray           # [T]
    paths: jnp.ndarray         # [T, N, d] smoothed clouds
    ts: jnp.ndarray            # [T]
    eta_mean: jnp.ndarray      # [T]
    eta_lower: jnp.ndarray     # [T]
    eta_upper: jnp.ndarray     # [T]
    state_mean: jnp.ndarray    # [T, d]
    state_lower: jnp.ndarray   # [T, d]
    state_upper: jnp.ndarray   # [T, d]

    def tree_flatten(self):
        return ((self.ll, self.ess, self.paths, self.ts, self.eta_mean,
                 self.eta_lower, self.eta_upper, self.state_mean,
                 self.state_lower, self.state_upper), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@partial(jax.jit, static_argnames=("model", "n_particles", "resample",
                                   "interval", "store"))
def _interp_impl(model: Model, params: Tree, data: TimeSeries,
                 n_particles: int, key, t0, resample: str, interval: float,
                 store: str = "path"):
    from .filter import credible_interval_eta, credible_interval_state

    resample_fn = rs.get_scheme(resample)
    k_init, k_scan = jax.random.split(key)
    particles = model.initial_state(params, k_init, (n_particles,))
    dtype = particles.dtype
    n = n_particles

    def step(carry, inp):
        x, t_prev, ll, ess = carry
        t, y, mask, k = inp
        k_prop, k_res = jax.random.split(k)

        x1 = model.step(params, k_prop, x, t - t_prev)

        y_safe = jnp.where(mask, y, 0.0)
        logw = model.log_density(params, model.f(x1, t), y_safe)
        logw = jnp.where(mask, logw, 0.0)
        maxw = jnp.max(logw)
        w = jnp.exp(logw - maxw)
        ll1 = ll + jnp.where(mask, maxw + jnp.log(jnp.mean(w)), 0.0)
        wn = w / jnp.sum(w)
        # missing observation => ESS unchanged (ParticleFilter.scala:120-121,
        # as filter._filter_impl), not reset to n
        ess1 = jnp.where(
            mask, jnp.floor(1.0 / jnp.sum(wn * wn)).astype(jnp.int32), ess)

        idx = jnp.where(mask, resample_fn(k_res, w), jnp.arange(n))
        x2 = x1[idx]
        # store pre-resample states + the genealogy indices ('path');
        # 'summary' stores the genealogy only and replays the states
        out = (x1, idx, ll1, ess1) if store == "path" else (idx, ll1, ess1)
        return (x2, t, ll1, ess1), out

    keys = jax.random.split(k_scan, data.ts.shape[0])
    t_start = data.ts[0] if t0 is None else jnp.asarray(t0, dtype)
    init = (particles, t_start, jnp.asarray(0.0, dtype),
            jnp.asarray(n, jnp.int32))
    if store == "path":
        (_, _, ll, _), (xs_pre, anc, ll_hist, ess_hist) = jax.lax.scan(
            step, init, (data.ts, data.ys, data.mask, keys))
    else:
        (_, _, ll, _), (anc, ll_hist, ess_hist) = jax.lax.scan(
            step, init, (data.ts, data.ys, data.mask, keys))

    # -- backward genealogy reconstruction -------------------------------
    # surviving slot j at the end; its pre-resample index at step k is
    # p_k = anc[k][j_k] and its parent slot is j_{k-1} = p_k.
    def back(j, a):
        p = a[j]
        return p, p

    _, ps = jax.lax.scan(back, jnp.arange(n), anc, reverse=True)

    if store == "path":
        paths = jnp.take_along_axis(xs_pre, ps[:, :, None], axis=1)

        etas = jax.vmap(lambda x, t: model.link(model.f(x, t)))(paths, data.ts)
        e_lo, e_hi = jax.vmap(
            lambda e: credible_interval_eta(e, interval))(etas)
        s_lo, s_hi = jax.vmap(
            lambda x: credible_interval_state(x, interval))(paths)
        return InterpolationResult(
            ll, ess_hist, paths, data.ts,
            jnp.mean(etas, axis=1), e_lo, e_hi,
            jnp.mean(paths, axis=1), s_lo, s_hi)

    # -- store == 'summary': rematerializing replay ----------------------
    # Re-run the propagation with the SAME per-step keys (k_prop is the
    # first split of each stored key, exactly as in `step`), gather the
    # smoothed cloud x1[ps[t]] and reduce it to summaries in place.  Only
    # the [T, N] int32 genealogy (anc + ps) ever lives in device memory -- the
    # [T, N, d] pre-resample history is never materialised.
    def intervals(cloud, eta):
        # Two per-step [N] sorts dominate the replay at large N; 32-round
        # bit-bisection selection (ops/selection.py) returns the SAME order
        # statistics bit-identically without sorting (one [d+1, 2]
        # selection per step).  Fall back to the sort path off f32 or for
        # non-scalar eta.
        if (cloud.dtype == jnp.float32 and eta.dtype == jnp.float32
                and eta.ndim == 1):
            from ..ops.selection import kth_smallest_bits
            d = cloud.shape[1]
            idx = math.floor(n * interval)
            ks_state = ((n - idx - 1) % n, (idx - 1) % n)
            ks_eta = ((n - idx) % n, min(idx, n - 1))
            ks = jnp.asarray([ks_state] * d + [ks_eta], jnp.int32)  # [d+1, 2]
            vals = jnp.concatenate([cloud.T, eta[None, :]], axis=0)
            sel = kth_smallest_bits(vals, ks)
            return sel[d, 0], sel[d, 1], sel[:d, 0], sel[:d, 1]
        e_lo, e_hi = credible_interval_eta(eta, interval)
        s_lo, s_hi = credible_interval_state(cloud, interval)
        return e_lo, e_hi, s_lo, s_hi

    def replay(carry, inp):
        x, t_prev = carry
        t, k, idx, p = inp
        k_prop, _ = jax.random.split(k)
        x1 = model.step(params, k_prop, x, t - t_prev)
        cloud = x1[p]                              # [N, d] smoothed
        eta = model.link(model.f(cloud, t))
        e_lo, e_hi, s_lo, s_hi = intervals(cloud, eta)
        return (x1[idx], t), (jnp.mean(eta), e_lo, e_hi,
                              jnp.mean(cloud, axis=0), s_lo, s_hi)

    _, (e_mean, e_lo, e_hi, s_mean, s_lo, s_hi) = jax.lax.scan(
        replay, (particles, t_start), (data.ts, keys, anc, ps))
    return InterpolationResult(
        ll, ess_hist, None, data.ts, e_mean, e_lo, e_hi, s_mean, s_lo, s_hi)


def interpolation_memory_bytes(n_steps: int, n_particles: int,
                               dim: int, itemsize: int = 4,
                               store: str = "path") -> int:
    """Peak device-memory footprint of :func:`interpolation_filter`'s
    history arrays.

    ``store='path'``: the pre-resample states ``[T, N, d]``, the
    reconstructed paths ``[T, N, d]`` (live simultaneously during the
    backward gather) and the genealogy ``[T, N]`` int32 indices.

    ``store='summary'``: only the two ``[T, N]`` int32 genealogy arrays
    (``anc`` + the backward-scan ``ps``) -- the state history is
    rematerialised step-by-step by the replay scan, never stored.
    """
    if store == "summary":
        return n_steps * n_particles * 8
    return n_steps * n_particles * (2 * dim * itemsize + 4)


def interpolation_filter(model: Model, params: Tree, data: TimeSeries,
                         n_particles: int, key, *,
                         t0: Optional[float] = None,
                         resample: str = "systematic",
                         interval: float = 0.975,
                         store: str = "path") -> InterpolationResult:
    """Smoothing-by-filtering: reconstruct the latent path through gaps of
    missing observations (reference Interpolate example,
    examples/Interpolate.scala:10-53).

    Knock out observations with :meth:`TimeSeries.knock_out`; the returned
    per-time clouds are *smoothed* (conditioned on all observations), so the
    credible intervals bridge the gap rather than fanning out.

    Memory bound: with ``store='path'`` (default) this filter holds the FULL
    ``[T, N, d]`` pre-resample history plus the reconstructed ``[T, N, d]``
    paths in device memory -- :func:`interpolation_memory_bytes` gives the
    footprint: ``T * N * (8d + 4)`` bytes, about 63 GB at ``T=1000, d=7,
    N=2^20`` (the reference shapes, N ~ 1e3, are three orders of magnitude
    inside any device).

    ``store='summary'`` drops ``paths`` (``None`` in the result) and keeps
    every summary column: the forward scan stores only the ``[T, N]`` int32
    genealogy, then a second scan REPLAYS the propagation deterministically
    from the same per-step PRNG keys, gathers each step's smoothed cloud and
    reduces it to mean/interval in place.  Peak history footprint falls to
    ``2 * T * N * 4`` bytes (7.5x smaller at d=7: 8.4 GB at T=1000,
    N=2^20) for one extra propagation pass -- cheap, since
    ``model.step`` is a tiny fraction of the filter's cost.
    """
    if store not in ("path", "summary"):
        raise ValueError(
            f"store must be 'path' or 'summary', got {store!r}")
    model.validate_params(params)
    return _interp_impl(model, params, data, n_particles, key, t0, resample,
                        interval, store)
