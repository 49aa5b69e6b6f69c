"""Particle-sharded bootstrap filter over a device mesh (``shard_map``).

Per time step the only global synchronisation is:

* ``pmax`` of the local weight maxima and ``psum`` of the weight sums
  (the log-sum-exp update and ESS -- a handful of scalars);
* at resample steps, a **distributed systematic resampler**
  (:func:`distributed_systematic_resample`): an exclusive scan of per-shard
  weight sums (n_shards scalars) gives every shard its global count window
  closed-form, and particles move between shards via a data-adaptive
  ``ppermute`` ring -- the loop exits as soon as every shard has its
  ancestors (one hop in the common near-uniform-weights case).  No shard
  ever materialises the global ``[N, d]`` cloud, so multi-chip N is bounded
  by *aggregate* device memory, not one device's, and per-step traffic is
  O(local_n * d * hops_needed) instead of O(N * d).

The global resampling positions use a *shared* uniform (same key on every
shard), so the resampled system is statistically identical to the
single-device filter given the same global weight vector -- shard-count only
changes which device holds which slice (and the propagation RNG streams,
which are folded per shard).

Summaries (``store='summary'``) compute exact global order statistics
without gathering: a 32-round bit-bisection selection
(:func:`_kth_smallest_sharded`) -- each round is one ``psum`` of a few
counters -- returns credible-interval bounds bit-identical to sorting the
gathered cloud.

Design per SURVEY.md section 2.3 / 5.8 (option ii); there is no reference
equivalent (the reference is a single-JVM library; resampling semantics
match Resampling.scala:63-72).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..models.model import Model
from ..models.tree import Tree
from ..utils.data import TimeSeries
from .mesh import PARTICLE_AXIS


# ---------------------------------------------------------------------------
# distributed systematic resampling (SURVEY 5.8 option ii)
# ---------------------------------------------------------------------------


def distributed_systematic_resample(x_local, w_local, key, axis: str,
                                    sync_axes=None):
    """Exact global systematic resampling, no all-gather of the particle
    block.  Call inside ``shard_map`` on every shard of ``axis``.

    Args:
      x_local: [local_n, d] this shard's particle block (global slice
        ``[idx*local_n, (idx+1)*local_n)``).
      w_local: [local_n] this shard's unnormalised linear weights.
      key: PRNG key, **identical on every shard** (the shared uniform).
      axis: mesh axis name.
      sync_axes: ALL mesh axes of the enclosing ``shard_map`` (default
        ``(axis,)``).  The adaptive ring loop contains collectives, so its
        trip count must agree across the whole mesh, not just ``axis`` --
        e.g. chain-parallel PMMH must pass ``(CHAIN_AXIS, PARTICLE_AXIS)``
        or rows that finish early abort the others' ppermute rendezvous.

    Returns:
      [local_n, d] -- global output slots ``[idx*local_n, (idx+1)*local_n)``
      of the globally systematic sample (semantics of
      ``resampling.systematic_indices`` / Resampling.scala:63-72).

    Mechanics: per-shard weight sums are all-gathered (n_shards scalars),
    the exclusive scan gives each shard its weight offset, and the global
    cumulative position count at every local particle follows closed-form
    (``clip(ceil(N*cdf - u), 0, N)`` -- the same search-free trick as the
    single-device scheme).  Each shard therefore knows, locally, the
    contiguous global output-slot window its particles parent:
    ``[c_prev, counts[-1])`` where ``c_prev`` is the previous shard's last
    count (exchanged as one int via ``ppermute``, so windows tile [0, N)
    exactly, immune to float rounding).  Blocks then circulate a ring:
    at hop r a shard holds shard (idx-r)'s block and fills any of its
    output slots whose ancestor lives there; a ``psum`` of unfilled counts
    ends the loop globally as soon as every slot is filled.
    """
    idx = jax.lax.axis_index(axis)
    local_n = w_local.shape[0]
    if jax.lax.axis_size(axis) == 1:
        # 1-wide particle axis (every single-host user with a trivial
        # mesh): the global sample IS the local systematic sample -- skip
        # the ring machinery (the expensive part) but keep the SAME
        # window-count producer, so the shortcut is bit-identical to the
        # general path by construction (it normalises the cdf as
        # cumsum(w)/cumsum(w)[-1], which differs from systematic_counts'
        # cumsum(w/sum(w)) by f32 rounding on non-dyadic weights)
        from ..inference.resampling import _ancestors_from_counts
        counts, _ = _systematic_window_counts(w_local, key, axis)
        return x_local[_ancestors_from_counts(counts, local_n)]
    counts, c_prev = _systematic_window_counts(w_local, key, axis)
    slots = idx * local_n + jnp.arange(local_n)                  # my outputs

    def fill(out, filled, xb, cb, cp):
        """Take ancestors from the visiting block (window [cp, cb[-1]))."""
        i = jnp.searchsorted(cb, slots, side="right")
        valid = (slots >= cp) & (slots < cb[-1])
        cand = xb[jnp.clip(i, 0, local_n - 1)]
        out = jnp.where((valid & ~filled)[:, None], cand, out)
        return out, filled | valid

    return _ring_exchange_fill(fill, x_local, counts, c_prev, local_n,
                               axis, sync_axes)


def _ring_exchange_fill(fill, x_block, counts, c_prev, local_n, axis,
                        sync_axes):
    """Shared ring driver of the distributed resamplers.

    Circulates ``(x_block, counts, c_prev)`` around the ``axis`` ring and
    applies ``fill(out, filled, xb, cb, cp) -> (out, filled)`` per hop (the
    layout-specific local gather); a ``psum`` of unfilled counts over
    ``sync_axes`` exits as soon as every shard holds its ancestors.
    """
    n_shards = jax.lax.axis_size(axis)
    sync_axes = (axis,) if sync_axes is None else tuple(sync_axes)
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]

    out, filled = fill(jnp.zeros_like(x_block),
                       jnp.zeros((local_n,), bool),
                       x_block, counts, c_prev)

    def missing(filled):
        return jax.lax.psum(jnp.sum(jnp.logical_not(filled)
                                    .astype(jnp.int32)), sync_axes)

    def cond(carry):
        _, _, _, _, _, r, miss = carry
        return (miss > 0) & (r < n_shards)

    def body(carry):
        out, filled, xb, cb, cp, r, _ = carry
        xb = jax.lax.ppermute(xb, axis, fwd)
        cb = jax.lax.ppermute(cb, axis, fwd)
        cp = jax.lax.ppermute(cp, axis, fwd)
        out, filled = fill(out, filled, xb, cb, cp)
        return out, filled, xb, cb, cp, r + 1, missing(filled)

    init = (out, filled, x_block, counts, c_prev,
            jnp.asarray(1, jnp.int32), missing(filled))
    out, _, _, _, _, _, _ = jax.lax.while_loop(cond, body, init)
    return out


def _systematic_window_counts(w_local, key, axis: str):
    """Shared window machinery of the distributed systematic resampler.

    Returns ``(counts, c_prev)``: this shard's global cumulative position
    counts (monotonised int32, window ``[c_prev, counts[-1])``) and the
    previous shard's closing count (exchanged as an int so windows tile
    ``[0, N)`` exactly).  See :func:`distributed_systematic_resample`.
    """
    from ..inference.resampling import _cumsum, _monotone_counts

    idx = jax.lax.axis_index(axis)
    n_shards = jax.lax.axis_size(axis)
    local_n = w_local.shape[0]
    n_total = local_n * n_shards

    local_cdf = _cumsum(w_local)                                 # [local_n]
    s_all = jax.lax.all_gather(local_cdf[-1], axis)              # [n_shards]
    total = jnp.sum(s_all)
    shard_ids = jnp.arange(n_shards)
    offset = jnp.sum(jnp.where(shard_ids < idx, s_all, 0.0))

    u = jax.random.uniform(key, (), w_local.dtype)               # shared
    cdf = (offset + local_cdf) / total
    counts = jnp.clip(jnp.ceil(n_total * cdf - u), 0,
                      n_total).astype(jnp.int32)
    is_last = idx == n_shards - 1
    counts = jnp.where(
        is_last & (jnp.arange(local_n) == local_n - 1), n_total, counts)
    counts = _monotone_counts(counts)

    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    c_prev = jax.lax.ppermute(counts[-1], axis, fwd)
    c_prev = jnp.where(idx == 0, 0, c_prev)
    return counts, c_prev


def distributed_systematic_resample_t(x_t_local, w_local, key, axis: str,
                                      sync_axes=None):
    """Transposed-layout distributed systematic resampling.

    Same window/ring mechanics as :func:`distributed_systematic_resample`
    but particle blocks travel as ``[d, local_n]`` columns.

    Args:
      x_t_local: [d, local_n] this shard's particle columns.
      w_local: [local_n] unnormalised linear weights.
      key: PRNG key, identical on every shard.
      axis: particle mesh axis.
      sync_axes: all mesh axes of the enclosing shard_map (see
        :func:`distributed_systematic_resample`).
    """
    idx = jax.lax.axis_index(axis)
    local_n = x_t_local.shape[1]

    if jax.lax.axis_size(axis) == 1:
        # 1-wide axis: bit-identical local systematic sample, no ring
        # (same window-count producer as the general path; see
        # distributed_systematic_resample)
        from ..inference.resampling import _ancestors_from_counts
        counts1, _ = _systematic_window_counts(w_local, key, axis)
        return x_t_local[:, _ancestors_from_counts(counts1, local_n)]

    counts, c_prev = _systematic_window_counts(w_local, key, axis)
    slots = idx * local_n + jnp.arange(local_n)                  # my outputs

    def fill(out, filled, xb_t, cb, cp):
        i = jnp.searchsorted(cb, slots, side="right")
        valid = (slots >= cp) & (slots < cb[-1])
        cand = xb_t[:, jnp.clip(i, 0, local_n - 1)]
        out = jnp.where((valid & ~filled)[None, :], cand, out)
        return out, filled | valid

    return _ring_exchange_fill(fill, x_t_local, counts, c_prev, local_n,
                               axis, sync_axes)


def _all_gather_systematic_resample(x_local, w_local, key, axis: str):
    """Round-1 baseline: gather weights + particles, slice the global
    sample.  Kept for cross-checking the distributed path; O(N*d)
    traffic and O(N) per-chip memory per step."""
    from ..inference.resampling import (_ancestors_from_counts, _cumsum,
                                        _monotone_counts)

    idx = jax.lax.axis_index(axis)
    local_n = x_local.shape[0]
    n_total = local_n * jax.lax.axis_size(axis)
    w_all = jax.lax.all_gather(w_local, axis, tiled=True)        # [N]
    x_all = jax.lax.all_gather(x_local, axis, tiled=True)        # [N, d]
    cdf = _cumsum(w_all / jnp.sum(w_all))
    u = jax.random.uniform(key, (), w_local.dtype)
    counts = jnp.clip(jnp.ceil(n_total * cdf - u), 0,
                      n_total).astype(jnp.int32)
    counts = counts.at[-1].set(n_total)
    # the f32 prefix can dip a ulp => counts must be monotonised before
    # ancestor construction, exactly as every other count-based path
    anc = _ancestors_from_counts(_monotone_counts(counts), n_total)
    local = jax.lax.dynamic_slice_in_dim(anc, idx * local_n, local_n)
    return x_all[local]


# ---------------------------------------------------------------------------
# exact global order statistics without gathering
# ---------------------------------------------------------------------------


def _kth_smallest_sharded(vals, ks, axis: str):
    """Exact k-th smallest of a sharded float32 array, per column: the
    shared bisection selector (:func:`..ops.selection.kth_smallest_bits`)
    with each round's counts psummed over ``axis`` -- 32 small
    reductions, no gather, no sort."""
    from ..ops.selection import kth_smallest_bits

    return kth_smallest_bits(vals.astype(jnp.float32), ks,
                             psum=lambda c: jax.lax.psum(c, axis))


# ---------------------------------------------------------------------------
# the sharded filter
# ---------------------------------------------------------------------------


def _sharded_weighted_pick(wn, k, axis: str, local_n: int, n_total: int):
    """Global index of one particle sampled proportional to the sharded
    weights ``wn`` (inverse-CDF on a shared uniform, no gather): the
    count of global-CDF entries below the target is the psum of local
    counts against shard-offset local CDFs."""
    idx = jax.lax.axis_index(axis)
    n_shards = jax.lax.axis_size(axis)
    local_sum = jnp.sum(wn)
    s_all = jax.lax.all_gather(local_sum, axis)                  # [n_shards]
    offset = jnp.sum(jnp.where(jnp.arange(n_shards) < idx, s_all, 0.0))
    total = jnp.sum(s_all)
    u = jax.random.uniform(k, (), wn.dtype) * total              # shared key
    cnt = jnp.sum((offset + jnp.cumsum(wn)) < u).astype(jnp.int32)
    j = jax.lax.psum(cnt, axis)
    return jnp.clip(j, 0, n_total - 1)


def _sharded_weighted_summary(model, cols, wn, mean, t, interval: float,
                              n_total: int, axis: str):
    """Weighted summary tuple on sharded [d+1, local_n] columns (state rows
    + eta row): weighted global quantiles via the bisection selector with
    psummed masses.  float32 (the selector's domain)."""
    from ..inference.filter import _interval_levels
    from ..ops.selection import weighted_quantile_bits

    d = cols.shape[0] - 1
    eta_mean = model.link(model.f(mean, t))
    ps_s, ps_e = _interval_levels(n_total, interval)
    ps = jnp.asarray([list(ps_s)] * d + [list(ps_e)], jnp.float32)
    sel = weighted_quantile_bits(cols.astype(jnp.float32),
                                 wn.astype(jnp.float32), ps,
                                 psum=lambda m: jax.lax.psum(m, axis))
    return (eta_mean, sel[d, 0], sel[d, 1], mean, sel[:d, 0], sel[:d, 1])


def _make_save_fn_sharded(model: Model, store, interval: float,
                          local_n: int, n_total: int, axis: str,
                          weighted: bool = False):
    """Per-step save functions on the sharded cloud; keys are shared across
    shards.  Mirrors filter._make_save_fn semantics exactly (PfOut,
    ParticleFilter.scala:53-59 + getIntervals :415-424), including the
    ``weighted`` flavour used when ``ess_threshold`` leaves the carried
    weights non-uniform at save points."""
    if store == "ll" or store is None:
        return lambda t, x, wn, k: ()
    if store == "path":
        if weighted:
            def save(t, x, wn, k):
                idx = jax.lax.axis_index(axis)
                j = _sharded_weighted_pick(wn, k, axis, local_n, n_total)
                mine = (j // local_n) == idx
                v = jnp.where(mine, x[j % local_n], jnp.zeros_like(x[0]))
                return jax.lax.psum(v, axis)
        else:
            def save(t, x, wn, k):
                idx = jax.lax.axis_index(axis)
                j = jax.random.randint(k, (), 0, n_total)
                mine = (j // local_n) == idx
                v = jnp.where(mine, x[j % local_n], jnp.zeros_like(x[0]))
                return jax.lax.psum(v, axis)
        return save
    if store == "summary":
        k_os = math.floor(n_total * interval)

        if weighted:
            def save(t, x, wn, k):
                wsum = jax.lax.psum(jnp.sum(wn), axis)
                mean = jax.lax.psum(
                    jnp.sum(wn[:, None] * x, axis=0), axis) / wsum
                etas = model.link(model.f(x, t))
                cols = jnp.concatenate([x.T, etas[None]], axis=0)
                return _sharded_weighted_summary(
                    model, cols, wn, mean, t, interval, n_total, axis)
            return save

        def save(t, x, wn, k):
            mean = jax.lax.psum(jnp.sum(x, axis=0), axis) / n_total
            eta_mean = model.link(model.f(mean, t))
            etas = model.link(model.f(x, t))                     # [local_n]
            cols = jnp.concatenate([x.T, etas[None]], axis=0)    # [d+1, m]
            d = x.shape[1]
            ks = jnp.asarray(
                [[n_total - k_os - 1, k_os - 1]] * d
                + [[n_total - k_os, min(k_os, n_total - 1)]], jnp.int32)
            sel = _kth_smallest_sharded(cols, ks, axis)          # [d+1, 2]
            return (eta_mean, sel[d, 0], sel[d, 1],
                    mean, sel[:d, 0], sel[:d, 1])
        return save
    if callable(store):
        return lambda t, x, wn, k: store(t, x, k)
    raise ValueError(f"unknown store mode {store!r}")


def _sharded_scan(model: Model, params: Tree, data: TimeSeries,
                  local_n: int, key, axis: str, *,
                  x_init=None, t0=None, store="ll",
                  ess_threshold: Optional[float] = None,
                  interval: float = 0.975,
                  resample_comm: str = "distributed",
                  sync_axes=None):
    """Filter body executed on each particle shard (inside shard_map).

    Semantics match the single-device scan (filter._filter_impl): carried
    globally-normalised weights, ``ll += max + log(total)``, ESS trigger,
    missing-observation propagate-only.
    """
    idx = jax.lax.axis_index(axis)
    n_shards = jax.lax.axis_size(axis)
    n_total = local_n * n_shards
    # n_shards is trace-time static: on a 1-wide particle axis the scalar
    # collectives are identities -- skip them
    pmax_ = (lambda v: v) if n_shards == 1 else (
        lambda v: jax.lax.pmax(v, axis))
    psum_ = (lambda v: v) if n_shards == 1 else (
        lambda v: jax.lax.psum(v, axis))
    save_fn = _make_save_fn_sharded(model, store, interval, local_n,
                                    n_total, axis,
                                    weighted=ess_threshold is not None)

    k_init, k_scan = jax.random.split(key)
    if x_init is None:
        particles = model.initial_state(
            params, jax.random.fold_in(k_init, idx), (local_n,))
    else:
        x_init = jnp.asarray(x_init)
        if x_init.ndim == 1:
            # FilterInit: every particle starts at the supplied state
            particles = jnp.broadcast_to(
                x_init, (local_n,) + x_init.shape)
        else:
            particles = x_init   # already the local [local_n, d] block
    dtype = particles.dtype
    wn0 = jnp.full((local_n,), 1.0 / n_total, dtype=dtype)

    def step(carry, inp):
        x, wn, t_prev, ll, ess = carry
        t, y, mask, k = inp
        k_prop = jax.random.fold_in(jax.random.fold_in(k, 1), idx)
        k_sys = jax.random.fold_in(k, 2)    # shared across shards
        k_save = jax.random.fold_in(k, 3)   # shared across shards

        x1 = model.step(params, k_prop, x, t - t_prev)

        y_safe = jnp.where(mask, y, 0.0)
        gamma = model.f(x1, t)
        logw = model.log_density(params, gamma, y_safe)
        logw = jnp.where(mask, logw, 0.0)

        maxw = pmax_(jnp.max(logw))
        u = wn * jnp.exp(logw - maxw)
        total = psum_(jnp.sum(u))
        ll_inc = jnp.where(mask, maxw + jnp.log(total), 0.0)
        wn1 = u / total
        sumsq = psum_(jnp.sum(wn1 * wn1))
        ess1 = jnp.where(mask,
                         jnp.floor(1.0 / sumsq).astype(jnp.int32), ess)

        if ess_threshold is None:
            do_resample = mask
        else:
            do_resample = mask & (ess1 < ess_threshold * n_total)

        def yes(args):
            x_, w_ = args
            if resample_comm == "distributed":
                x2 = distributed_systematic_resample(x_, w_, k_sys, axis,
                                                     sync_axes=sync_axes)
            else:
                x2 = _all_gather_systematic_resample(x_, w_, k_sys, axis)
            return x2, jnp.full((local_n,), 1.0 / n_total, dtype=dtype)

        x2, wn2 = jax.lax.cond(do_resample, yes, lambda a: a, (x1, wn1))
        ll1 = ll + ll_inc
        out = (save_fn(t, x2, wn2, k_save), ll1, ess1)
        return (x2, wn2, t, ll1, ess1), out

    keys = jax.random.split(k_scan, data.ts.shape[0])
    t_start = data.ts[0] if t0 is None else jnp.asarray(t0, dtype)
    init = (particles, wn0, t_start, jnp.asarray(0.0, dtype),
            jnp.asarray(n_total, jnp.int32))
    (xf, _, _, ll, _), (saved, ll_hist, ess_hist) = jax.lax.scan(
        step, init, (data.ts, data.ys, data.mask, keys))
    return ll, ll_hist, ess_hist, xf, saved


def _make_save_fn_sharded_t(model: Model, store, interval: float,
                            local_n: int, n_total: int, axis: str,
                            weighted: bool = False):
    """Save functions on the transposed [d, local_n] sharded cloud."""
    if store == "ll" or store is None:
        return lambda t, x_t, wn, k: ()
    if store == "path":
        if weighted:
            def save(t, x_t, wn, k):
                idx = jax.lax.axis_index(axis)
                j = _sharded_weighted_pick(wn, k, axis, local_n, n_total)
                mine = (j // local_n) == idx
                v = jnp.where(mine, x_t[:, j % local_n],
                              jnp.zeros_like(x_t[:, 0]))
                return jax.lax.psum(v, axis)
        else:
            def save(t, x_t, wn, k):
                idx = jax.lax.axis_index(axis)
                j = jax.random.randint(k, (), 0, n_total)
                mine = (j // local_n) == idx
                v = jnp.where(mine, x_t[:, j % local_n],
                              jnp.zeros_like(x_t[:, 0]))
                return jax.lax.psum(v, axis)
        return save
    if store == "summary":
        k_os = math.floor(n_total * interval)

        if weighted:
            def save(t, x_t, wn, k):
                wsum = jax.lax.psum(jnp.sum(wn), axis)
                mean = jax.lax.psum(
                    jnp.sum(wn[None, :] * x_t, axis=1), axis) / wsum
                etas = model.link(model.f_t(x_t, t))
                cols = jnp.concatenate(
                    [x_t, etas[None].astype(x_t.dtype)], axis=0)
                return _sharded_weighted_summary(
                    model, cols, wn, mean, t, interval, n_total, axis)
            return save

        def save(t, x_t, wn, k):
            d = x_t.shape[0]
            mean = jax.lax.psum(jnp.sum(x_t, axis=1), axis) / n_total
            eta_mean = model.link(model.f(mean, t))
            etas = model.link(model.f_t(x_t, t))                 # [local_n]
            cols = jnp.concatenate([x_t, etas[None]], axis=0)    # [d+1, m]
            ks = jnp.asarray(
                [[n_total - k_os - 1, k_os - 1]] * d
                + [[n_total - k_os, min(k_os, n_total - 1)]], jnp.int32)
            sel = _kth_smallest_sharded(cols, ks, axis)          # [d+1, 2]
            return (eta_mean, sel[d, 0], sel[d, 1],
                    mean, sel[:d, 0], sel[:d, 1])
        return save
    if callable(store):
        # preserve the documented (t, particles [local_n, d], key) contract
        # across flat/transposed paths (the transposed scan holds [d, local_n]
        # columns; a callable must not see a layout-dependent shape)
        return lambda t, x_t, wn, k: store(t, x_t.T, k)
    raise ValueError(f"unknown store mode {store!r}")


def _sharded_scan_t(model: Model, params: Tree, data: TimeSeries,
                    local_n: int, key, axis: str, *,
                    x_init=None, t0=None, store="ll",
                    ess_threshold: Optional[float] = None,
                    interval: float = 0.975,
                    sync_axes=None):
    """Transposed-layout sharded filter body.

    Particles live as [d, local_n] columns for the whole scan, and
    resampling uses :func:`distributed_systematic_resample_t`.  Semantics
    identical to :func:`_sharded_scan`.
    """
    idx = jax.lax.axis_index(axis)
    n_shards = jax.lax.axis_size(axis)
    n_total = local_n * n_shards
    # 1-wide particle axis: scalar collectives are identities (see
    # _sharded_scan)
    pmax_ = (lambda v: v) if n_shards == 1 else (
        lambda v: jax.lax.pmax(v, axis))
    psum_ = (lambda v: v) if n_shards == 1 else (
        lambda v: jax.lax.psum(v, axis))
    save_fn = _make_save_fn_sharded_t(model, store, interval, local_n,
                                      n_total, axis,
                                      weighted=ess_threshold is not None)

    k_init, k_scan = jax.random.split(key)
    d = model.dim
    if x_init is None:
        x_t = model.initial_state_t(
            params, jax.random.fold_in(k_init, idx), local_n)
    else:
        x_init = jnp.asarray(x_init)
        if x_init.ndim == 1:
            x_t = jnp.broadcast_to(x_init[:, None], (d, local_n))
        else:
            x_t = x_init.T   # local [local_n, d] block
    dtype = x_t.dtype
    wn0 = jnp.full((local_n,), 1.0 / n_total, dtype=dtype)

    def step(carry, inp):
        x_t, wn, t_prev, ll, ess = carry
        t, y, mask, k = inp
        k_prop = jax.random.fold_in(jax.random.fold_in(k, 1), idx)
        k_sys = jax.random.fold_in(k, 2)    # shared across shards
        k_save = jax.random.fold_in(k, 3)   # shared across shards

        y_safe = jnp.where(mask, y, 0.0)
        x1 = model.step_t(params, k_prop, x_t, t - t_prev)
        gamma = model.f_t(x1, t)
        logw = model.log_density(params, gamma, y_safe)
        logw = jnp.where(mask, logw, 0.0)

        maxw = pmax_(jnp.max(logw))
        u = wn * jnp.exp(logw - maxw)
        total = psum_(jnp.sum(u))
        ll_inc = jnp.where(mask, maxw + jnp.log(total), 0.0)
        wn1 = u / total
        sumsq = psum_(jnp.sum(wn1 * wn1))
        ess1 = jnp.where(mask,
                         jnp.floor(1.0 / sumsq).astype(jnp.int32), ess)

        if ess_threshold is None:
            do_resample = mask
        else:
            do_resample = mask & (ess1 < ess_threshold * n_total)

        def yes(args):
            x_, w_ = args
            x2 = distributed_systematic_resample_t(
                x_, w_, k_sys, axis, sync_axes=sync_axes)
            return x2, jnp.full((local_n,), 1.0 / n_total, dtype=dtype)

        x2, wn2 = jax.lax.cond(do_resample, yes, lambda a: a, (x1, wn1))
        ll1 = ll + ll_inc
        out = (save_fn(t, x2, wn2, k_save), ll1, ess1)
        return (x2, wn2, t, ll1, ess1), out

    keys = jax.random.split(k_scan, data.ts.shape[0])
    t_start = data.ts[0] if t0 is None else jnp.asarray(t0, dtype)
    init = (x_t, wn0, t_start, jnp.asarray(0.0, dtype),
            jnp.asarray(n_total, jnp.int32))
    (xf_t, _, _, ll, _), (saved, ll_hist, ess_hist) = jax.lax.scan(
        step, init, (data.ts, data.ys, data.mask, keys))
    return ll, ll_hist, ess_hist, xf_t.T, saved


@partial(jax.jit, static_argnames=("model", "n_particles", "mesh", "axis",
                                   "store", "ess_threshold", "interval",
                                   "resample_comm", "init_is_cloud",
                                   "transposed"))
def _sharded_filter_impl(model, params, data, n_particles, key, x_init, t0,
                         mesh, axis, store, ess_threshold, interval,
                         resample_comm, init_is_cloud, transposed=False):
    n_shards = mesh.shape[axis]
    if n_particles % n_shards:
        raise ValueError(
            f"n_particles={n_particles} not divisible by {n_shards} shards")
    local_n = n_particles // n_shards

    if transposed:
        def body(p, d, k, t, xi):
            return _sharded_scan_t(model, p, d, local_n, k, axis,
                                   x_init=xi, t0=t, store=store,
                                   ess_threshold=ess_threshold,
                                   interval=interval)
    else:
        def body(p, d, k, t, xi):
            return _sharded_scan(model, p, d, local_n, k, axis,
                                 x_init=xi, t0=t, store=store,
                                 ess_threshold=ess_threshold,
                                 interval=interval,
                                 resample_comm=resample_comm)

    init_spec = P(axis) if init_is_cloud else P()
    if x_init is None:
        body_in = lambda p, d, k, t: body(p, d, k, t, None)
        in_specs = (P(), P(), P(), P())
        args = (params, data, key, t0)
    else:
        body_in = body
        in_specs = (P(), P(), P(), P(), init_spec)
        args = (params, data, key, t0, x_init)

    fn = shard_map(
        body_in, mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(), P(), P(), P(axis), P()),
        check_vma=False,
    )
    return fn(*args)


def sharded_bootstrap_filter(model: Model, params: Tree, data: TimeSeries,
                             n_particles: int, key, mesh: Mesh, *,
                             axis: str = PARTICLE_AXIS,
                             t0: Optional[float] = None,
                             initial_state=None,
                             store="summary",
                             ess_threshold: Optional[float] = None,
                             interval: float = 0.975,
                             resample_comm: str = "distributed",
                             transposed: bool = False):
    """Multi-device :func:`~..inference.filter.bootstrap_filter`: same API
    surface and semantics, particle axis sharded over ``mesh[axis]``.

    ``resample_comm``: 'distributed' (ppermute ring, default) or
    'allgather' (round-1 baseline, for cross-checking).

    ``transposed``: run the scan in [d, local_n] layout (particle axis
    last); default the [local_n, d] layout.

    Returns a :class:`~..inference.filter.FilterResult`; ``final_particles``
    keeps its global sharding.
    """
    from ..inference.filter import FilterResult, PfSummary

    model.validate_params(params)
    if resample_comm not in ("distributed", "allgather"):
        raise ValueError(
            f"resample_comm={resample_comm!r}: 'distributed' or 'allgather'")
    if transposed and resample_comm != "distributed":
        raise ValueError("transposed=True requires resample_comm="
                         f"'distributed' (got {resample_comm!r})")
    x_init = None if initial_state is None else jnp.asarray(initial_state)
    init_is_cloud = x_init is not None and x_init.ndim == 2
    t0v = data.ts[0] if t0 is None else jnp.asarray(t0, data.ts.dtype)
    ll, ll_hist, ess_hist, xf, saved = _sharded_filter_impl(
        model, params, data, n_particles, key, x_init, t0v, mesh, axis,
        store, ess_threshold, interval, resample_comm, init_is_cloud,
        transposed=transposed)

    summary = None
    path = None
    if store == "summary":
        eta_mean, e_lo, e_hi, s_mean, s_lo, s_hi = saved
        summary = PfSummary(data.ts, eta_mean, e_lo, e_hi,
                            s_mean, s_lo, s_hi)
    elif store == "path":
        path = saved
    return FilterResult(ll, ll_hist, ess_hist, xf, summary, path)


def sharded_log_likelihood(model: Model, params: Tree, data: TimeSeries,
                           n_particles: int, key,
                           mesh: Mesh, axis: str = PARTICLE_AXIS,
                           resample_comm: str = "distributed"):
    """PF log marginal likelihood with the particle axis sharded over
    ``mesh[axis]``.  Returns ``(ll, ll_history, ess_history,
    final_particles)`` with final particles sharded on their global axis."""
    res = sharded_bootstrap_filter(model, params, data, n_particles, key,
                                   mesh, axis=axis, store="ll",
                                   resample_comm=resample_comm)
    return res.ll, res.ll_history, res.ess, res.final_particles
