"""Resampling schemes for the particle filter.

The reference's TreeMap-based empirical CDF + ordered lookup
(Resampling.scala:36-96) becomes a normalised cumulative sum and
per-particle position counts -- fully vectorised, no data-dependent
shapes, and identical statistics.

Every scheme has the reference's call convention: inputs are *shifted linear*
weights ``exp(logw - max(logw))`` (ParticleFilter.scala:124-126), not log
weights.  Each ``*_indices`` kernel returns ancestor indices [n]; ``resample``
gathers particles with them, so one gather serves any per-particle payload
(states, paths, ancestor buffers).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _normalise(w):
    """w / sum(w).  Reference: Resampling.scala:21-24."""
    return w / jnp.sum(w)


def _cumsum(w):
    """Prefix sum, the single shared implementation for every resampling
    path (the sharded resampler's window counts must see the same cdf
    bits as the single-device schemes)."""
    return jax.lax.associative_scan(jnp.add, w)


def _monotone_counts(counts):
    """Exact running max over int32 cumulative position counts.

    The f32 cdf from a tree-structured prefix sum can *dip by a ulp*
    between adjacent entries (different rounding groupings), so
    ``ceil(n*cdf - u)`` occasionally decreases by 1 (seen with
    heavy-tailed weights at N=2^17).  Downstream consumers (ancestor
    construction, the distributed resampler's windows) assume
    nondecreasing counts, so every count-based scheme monotonises here.
    int32 max is exact, so this is the true sequential cummax.
    """
    return jax.lax.associative_scan(jnp.maximum, counts)


def _lookup(cdf, positions):
    """First index whose cdf >= position (the TreeMap ``.from`` lookup,
    Resampling.scala:36-58)."""
    n = cdf.shape[0]
    idx = jnp.searchsorted(cdf, positions, side="left")
    return jnp.clip(idx, 0, n - 1)


def _ancestors_from_counts(counts, n_out: int):
    """Ancestor indices from cumulative position counts, O(N), search-free.

    ``counts[i]`` = number of resampling positions strictly below ``cdf[i]``
    (nondecreasing, ``counts[-1] == n_out``).  Particle ``i`` owns output
    slots ``[counts[i-1], counts[i])``; materialised by scattering ``i`` to
    slot ``counts[i-1]`` for every particle with offspring and forward-filling
    with a running max.

    This replaces a per-slot ``searchsorted`` (a 20-round binary search
    of dependent gathers at N=2^20) with one scatter + one associative
    scan.
    """
    m = counts.shape[0]
    offspring = jnp.diff(counts, prepend=jnp.zeros((1,), counts.dtype))
    starts = counts - offspring
    targets = jnp.where(offspring > 0, starts, n_out)  # drop childless
    seed = jnp.zeros((n_out,), jnp.int32).at[targets].max(
        jnp.arange(m, dtype=jnp.int32), mode="drop")
    return jax.lax.associative_scan(jnp.maximum, seed)


def systematic_counts(key, weights, n: int | None = None):
    """Monotone cumulative position counts for systematic resampling.

    Positions are affine in the slot index, so the position count below
    each cdf entry is closed-form: ``counts[i] = clip(ceil(n*cdf[i] - u),
    0, n)`` -- no search at all.  Reference semantics:
    Resampling.scala:63-72.
    """
    m = weights.shape[0]
    n = m if n is None else n
    u = jax.random.uniform(key, (), weights.dtype)
    cdf = _cumsum(_normalise(weights))
    counts = jnp.clip(jnp.ceil(n * cdf - u), 0, n).astype(jnp.int32)
    counts = counts.at[-1].set(n)  # guard against cdf[-1] < 1 rounding
    return _monotone_counts(counts)


def stratified_counts(key, weights, n: int | None = None):
    """Monotone cumulative position counts for stratified resampling.

    Position j lives in [j/n, (j+1)/n), so the count below cdf value c is
    ``k + (u[k] < n*c - k)`` with ``k = floor(n*c)`` -- elementwise, no
    search.  Reference semantics: Resampling.scala:78-86.
    """
    m = weights.shape[0]
    n = m if n is None else n
    cdf = _cumsum(_normalise(weights))
    u = jax.random.uniform(key, (n,), weights.dtype)
    v = n * cdf
    k = jnp.floor(v).astype(jnp.int32)
    k_safe = jnp.clip(k, 0, n - 1)
    extra = (u[k_safe] < (v - k)).astype(jnp.int32)
    counts = jnp.clip(jnp.where(k >= n, n, k + extra), 0, n)
    counts = counts.at[-1].set(n)
    return _monotone_counts(counts)


def systematic_indices(key, weights, n: int | None = None):
    """Systematic resampling ancestors (Resampling.scala:63-72)."""
    m = weights.shape[0]
    n = m if n is None else n
    return _ancestors_from_counts(systematic_counts(key, weights, n), n)


def stratified_indices(key, weights, n: int | None = None):
    """Stratified resampling ancestors (Resampling.scala:78-86)."""
    m = weights.shape[0]
    n = m if n is None else n
    return _ancestors_from_counts(stratified_counts(key, weights, n), n)


def multinomial_indices(key, weights, n: int | None = None):
    """Multinomial resampling: n iid draws from the weight distribution,
    one ``searchsorted`` lookup per position.  Reference:
    Resampling.scala:92-96.

    A search-free alternative (one stable argsort of the merged
    ``[positions, cdf]`` array yields every count) gives the same
    multiset; it measured slower on the GPU at N=2^20 and serves as the
    test oracle (tests/test_resampling.py).
    """
    m = weights.shape[0]
    n = m if n is None else n
    cdf = _cumsum(_normalise(weights))
    positions = jax.random.uniform(key, (n,), weights.dtype)
    return _lookup(cdf, positions)


def residual_indices(key, weights, n: int | None = None):
    """Residual resampling with fixed shapes.

    Deterministically copy particle i ``floor(n * w_i)`` times, then fill the
    remaining slots multinomially from the residual weights
    (Resampling.scala:130-146).  The dynamic deterministic count K becomes a
    fixed-shape ``repeat(..., total_repeat_length=n)`` plus a positional mask:
    slots < K take deterministic copies, slots >= K take iid multinomial
    draws (:func:`multinomial_indices`, whose any prefix is iid).
    """
    m = weights.shape[0]
    n = m if n is None else n
    wn = _normalise(weights)
    ki = jnp.floor(wn * n).astype(jnp.int32)
    k_total = jnp.sum(ki)

    det = jnp.repeat(jnp.arange(m), ki, total_repeat_length=n)

    residual = wn * n - ki
    residual = jnp.maximum(residual, 0.0)
    # guard: if residual mass is exactly zero (all weights uniform), fall back
    # to uniform residual distribution -- those slots are masked out anyway
    safe = jnp.where(jnp.sum(residual) > 0, residual, jnp.ones_like(residual))
    multi = multinomial_indices(key, safe, n)

    slot = jnp.arange(n)
    return jnp.where(slot < k_total, det, multi)


def identity_indices(key, weights, n: int | None = None):
    """No resampling.  Reference: Resampling.scala:29."""
    m = weights.shape[0]
    n = m if n is None else n
    return jnp.arange(n) % m


_SCHEMES = {
    "systematic": systematic_indices,
    "stratified": stratified_indices,
    "multinomial": multinomial_indices,
    "residual": residual_indices,
    "identity": identity_indices,
}


def get_scheme(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    try:
        return _SCHEMES[name_or_fn]
    except KeyError:
        raise ValueError(
            f"unknown resampling scheme {name_or_fn!r}; "
            f"choose from {sorted(_SCHEMES)}") from None


def resample(key, particles, weights, scheme="systematic"):
    """Gather a resampled particle set (any pytree with leading axis N)."""
    idx = get_scheme(scheme)(key, weights)
    return jax.tree_util.tree_map(lambda x: x[idx], particles)


def exp_normalise(logw):
    """Log weights -> normalised linear weights without overflow.

    Reference: Resampling.scala:102-108.
    """
    w = jnp.exp(logw - jnp.max(logw))
    return w / jnp.sum(w)


def effective_sample_size(weights):
    """floor(1 / sum(w_hat^2)) from unnormalised linear weights.

    Reference: ParticleFilter.scala:431-434.
    """
    wn = _normalise(weights)
    return jnp.floor(1.0 / jnp.sum(wn * wn)).astype(jnp.int32)


def sample_one(key, xs):
    """Uniformly sample one element (leading axis).

    Reference: Resampling.sampleOne, Resampling.scala:151-154.
    """
    i = jax.random.randint(key, (), 0, jax.tree_util.tree_leaves(xs)[0].shape[0])
    return jax.tree_util.tree_map(lambda x: x[i], xs)


def sample_many(key, n: int, xs):
    """Uniformly sample n elements WITHOUT replacement.

    Reference: Resampling.sampleMany, Resampling.scala:159-162.
    """
    m = jax.tree_util.tree_leaves(xs)[0].shape[0]
    idx = jax.random.permutation(key, m)[:n]
    return jax.tree_util.tree_map(lambda x: x[idx], xs)


def posterior_sample(key, stacked, n: int):
    """Resample n draws (with replacement) from a stacked posterior pytree.

    Reference: Streaming.createDist, Streaming.scala:170-174.
    """
    m = jax.tree_util.tree_leaves(stacked)[0].shape[0]
    idx = jax.random.randint(key, (n,), 0, m)
    return jax.tree_util.tree_map(lambda x: x[idx], stacked)
