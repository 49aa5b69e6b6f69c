"""Resampling tests: particle-count preservation (SamplingTest.scala:7-23)
plus distributional correctness (weighted-mean preservation) the reference
lacks (SURVEY.md section 4 gaps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from composablestatespacemodels_tpu.inference import resampling as rs

SCHEMES = ["systematic", "stratified", "multinomial", "residual"]


@pytest.mark.parametrize("scheme", SCHEMES + ["identity"])
def test_preserves_particle_count(key, scheme):
    n = 1000
    w = jax.random.uniform(key, (n,))
    idx = rs.get_scheme(scheme)(key, w)
    assert idx.shape == (n,)
    assert int(idx.min()) >= 0 and int(idx.max()) < n


@pytest.mark.parametrize("scheme", SCHEMES)
def test_weighted_mean_preserved(key, scheme):
    """Resampled unweighted mean ~ weighted mean of the inputs."""
    n = 4000
    kx, kw, kr = jax.random.split(key, 3)
    x = jax.random.normal(kx, (n,))
    w = jax.random.uniform(kw, (n,)) ** 2 + 0.01
    target = jnp.sum(x * w) / jnp.sum(w)

    keys = jax.random.split(kr, 50)
    means = jax.vmap(
        lambda k: jnp.mean(x[rs.get_scheme(scheme)(k, w)]))(keys)
    np.testing.assert_allclose(jnp.mean(means), target, atol=0.03)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_degenerate_weight_selects_single_particle(key, scheme):
    n = 128
    w = jnp.zeros((n,)).at[17].set(1.0)
    idx = rs.get_scheme(scheme)(key, w)
    assert bool(jnp.all(idx == 17))


def test_systematic_low_variance_vs_multinomial(key):
    """Systematic resampling has lower Monte-Carlo variance."""
    n = 1000
    kx, kw, kr = jax.random.split(key, 3)
    x = jax.random.normal(kx, (n,))
    w = jax.random.uniform(kw, (n,)) + 0.01
    keys = jax.random.split(kr, 200)
    var_sys = jnp.var(jax.vmap(
        lambda k: jnp.mean(x[rs.systematic_indices(k, w)]))(keys))
    var_mult = jnp.var(jax.vmap(
        lambda k: jnp.mean(x[rs.multinomial_indices(k, w)]))(keys))
    assert float(var_sys) < float(var_mult)


def test_residual_deterministic_part(key):
    # particle with weight k/n appears at least floor(k) times
    n = 100
    w = jnp.ones((n,)) / (2 * n)
    w = w.at[0].set(0.5 + 1.0 / (2 * n))  # wn[0] > 0.5 => >= 50 copies
    idx = rs.residual_indices(key, w)
    assert int(jnp.sum(idx == 0)) >= 50


def test_exp_normalise(key):
    logw = jax.random.normal(key, (256,)) * 5
    w = rs.exp_normalise(logw)
    np.testing.assert_allclose(jnp.sum(w), 1.0, rtol=1e-5)
    assert bool(jnp.all(w >= 0))


def test_effective_sample_size():
    n = 512
    np.testing.assert_allclose(
        rs.effective_sample_size(jnp.ones((n,))), n)
    w = jnp.zeros((n,)).at[0].set(1.0)
    np.testing.assert_allclose(rs.effective_sample_size(w), 1)


def test_resample_gathers_pytrees(key):
    n = 64
    particles = {"x": jnp.arange(n, dtype=jnp.float32),
                 "y": jnp.ones((n, 3))}
    w = jnp.zeros((n,)).at[5].set(1.0)
    out = rs.resample(key, particles, w)
    assert bool(jnp.all(out["x"] == 5))
    assert out["y"].shape == (n, 3)


def test_indices_subsample_size(key):
    w = jax.random.uniform(key, (1000,))
    idx = rs.systematic_indices(key, w, n=100)
    assert idx.shape == (100,)


# ---------------------------------------------------------------------------
# oracle: the search-free merged-rank multinomial.  The package draws
# multinomial ancestors by searchsorted lookups (faster on the GPU at
# N=2^20); this independent algorithm must give the same multiset.
# ---------------------------------------------------------------------------


def multinomial_counts(key, weights, n=None):
    """Monotone cumulative position counts for multinomial resampling.

    ONE stable argsort of the merged ``[positions, cdf]`` array yields every
    count: with positions occupying the first n merged slots, the merged
    rank of ``cdf[i]`` is ``#(positions <= cdf[i]) + i`` (the stable sort
    breaks position/cdf ties position-first, matching the ``side='left'``
    lookup), hence ``counts[i] = rank(cdf[i]) - i``.  The rank identity
    needs the cdf itself sorted, so the f32 prefix's ulp dips are removed
    with a running max before the merge.
    """
    m = weights.shape[0]
    n = m if n is None else n
    cdf = jax.lax.associative_scan(jnp.maximum,
                                   rs._cumsum(rs._normalise(weights)))
    u = jax.random.uniform(key, (n,), weights.dtype)
    order = jnp.argsort(jnp.concatenate([u, cdf]), stable=True)
    rank = jnp.zeros((n + m,), jnp.int32).at[order].set(
        jnp.arange(n + m, dtype=jnp.int32))
    counts = rank[n:] - jnp.arange(m, dtype=jnp.int32)
    counts = jnp.clip(counts, 0, n).at[-1].set(n)  # cdf[-1] < 1 rounding
    return rs._monotone_counts(counts)


def iid_draws_sorted_permuted(key, weights, n):
    """n iid draws from ``weights``: the merged-rank multiset (sorted)
    under a uniformly random slot permutation, so any fixed-size prefix
    is an iid sample too."""
    k_mult, k_perm = jax.random.split(key)
    anc = rs._ancestors_from_counts(multinomial_counts(k_mult, weights, n), n)
    return anc[jax.random.permutation(k_perm, n)]


def test_multinomial_counts_match_lookup_multiset(key):
    """The merged-rank oracle's ancestors are the sorted multiset of the
    package's per-position lookup for the same key
    (Resampling.scala:92-96 semantics)."""
    for trial in range(5):
        k = jax.random.fold_in(key, trial)
        n = 512
        w = jnp.exp(3.0 * jax.random.normal(k, (n,)))
        got = rs._ancestors_from_counts(multinomial_counts(k, w), n)
        # monotonise the lookup's cdf: the tree-structured f32 prefix sum
        # can dip by a ulp (see _monotone_counts), which the counts path
        # corrects and a raw searchsorted would not
        cdf = jax.lax.associative_scan(
            jnp.maximum, rs._cumsum(rs._normalise(w)))
        want = rs._lookup(cdf, jax.random.uniform(k, (n,), w.dtype))
        np.testing.assert_array_equal(np.asarray(got),
                                      np.sort(np.asarray(want)))
        # the package scheme draws exactly those positions
        np.testing.assert_array_equal(
            np.sort(np.asarray(rs.multinomial_indices(k, w))),
            np.sort(np.asarray(rs._lookup(rs._cumsum(rs._normalise(w)),
                                          jax.random.uniform(k, (n,))))))


def test_multinomial_counts_subsample_and_degenerate(key):
    w = jnp.zeros((256,)).at[17].set(1.0)
    counts = multinomial_counts(key, w, n=64)
    got = rs._ancestors_from_counts(counts, 64)
    assert got.shape == (64,)
    np.testing.assert_array_equal(np.asarray(got), 17)
    # monotone + closing invariants
    assert int(counts[-1]) == 64
    assert bool(jnp.all(jnp.diff(counts) >= 0))
    idx = rs.multinomial_indices(key, w, n=64)
    assert idx.shape == (64,)
    np.testing.assert_array_equal(np.asarray(idx), 17)


def test_multinomial_counts_weighted_mean(key):
    """Distributional check: resampled mean estimates the weighted mean."""
    n = 4096
    x = jax.random.normal(key, (n,))
    w = jnp.exp(jax.random.normal(jax.random.fold_in(key, 1), (n,)))
    target = jnp.sum(x * w) / jnp.sum(w)
    keys = jax.random.split(jax.random.fold_in(key, 2), 50)

    def one(k):
        anc = rs._ancestors_from_counts(multinomial_counts(k, w), n)
        return jnp.mean(x[anc])

    means = jax.vmap(one)(keys)
    se = jnp.std(means) / np.sqrt(50)
    assert abs(float(jnp.mean(means) - target)) < 5 * float(se) + 1e-3


def test_iid_sorted_permuted_matches_lookup_distribution(key):
    """The sorted-then-permuted oracle is distributed as iid lookups,
    INCLUDING any fixed prefix of slots (the property residual_indices'
    K-dependent mask relies on -- a sorted prefix would bias toward low
    ancestors)."""
    w = jnp.asarray([0.05, 0.1, 0.15, 0.2, 0.5])
    m, n, trials = 5, 40, 300
    counts_full = np.zeros(m)
    counts_prefix = np.zeros(m)
    slot_means = np.zeros(n)
    for i in range(trials):
        idx = np.asarray(iid_draws_sorted_permuted(
            jax.random.fold_in(key, i), w, n))
        counts_full += np.bincount(idx, minlength=m)
        counts_prefix += np.bincount(idx[:11], minlength=m)  # odd prefix
        slot_means += idx
    for counts, total in ((counts_full, n * trials),
                          (counts_prefix, 11 * trials)):
        freq = counts / total
        se = np.sqrt(np.asarray(w) * (1 - np.asarray(w)) / total)
        assert (np.abs(freq - np.asarray(w)) < 5 * se + 1e-3).all(), freq
    # no slot-position structure left after the permutation
    slot_means /= trials
    assert slot_means.std() < 0.5, slot_means.std()


def test_residual_multiset_parity_sorted_vs_lookup(key):
    """residual_indices (lookup fill) and the same scheme with the
    sorted+permuted oracle fill agree in distribution: compare ancestor
    frequencies over many keys."""
    w = jnp.asarray([0.02, 0.08, 0.3, 0.6])
    m, n, trials = 4, 32, 300
    wn = np.asarray(w) / np.asarray(w).sum()
    ki = np.floor(wn * n).astype(int)
    residual = np.maximum(wn * n - ki, 0)
    r_total = n - ki.sum()
    expected = ki + r_total * residual / residual.sum()

    def run(oracle_fill):
        counts = np.zeros(m)
        for i in range(trials):
            k = jax.random.fold_in(key, i)
            if oracle_fill:
                kk = jnp.asarray(ki, jnp.int32)
                det = jnp.repeat(jnp.arange(m), kk, total_repeat_length=n)
                multi = iid_draws_sorted_permuted(k, jnp.asarray(residual),
                                                  n)
                idx = jnp.where(jnp.arange(n) < int(ki.sum()), det, multi)
            else:
                idx = rs.residual_indices(k, w, n)
            counts += np.bincount(np.asarray(idx), minlength=m)
        return counts / trials

    f_oracle = run(True)
    f_pkg = run(False)
    se = np.sqrt(r_total * residual / residual.sum()) / np.sqrt(trials) + 0.05
    assert (np.abs(f_oracle - expected) < 6 * se).all(), (f_oracle, expected)
    assert (np.abs(f_pkg - expected) < 6 * se).all(), (f_pkg, expected)
    assert (np.abs(f_oracle - f_pkg) < 8 * se).all()


# ---------------------------------------------------------------------------
# closed-form systematic/stratified counts vs a float64 sequential oracle,
# at the shapes and weight regimes the filter meets
# ---------------------------------------------------------------------------


def _weights(regime, m, key):
    if regime == "uniform":
        return jnp.ones((m,), jnp.float32)
    if regime == "one_hot":
        return jnp.zeros((m,), jnp.float32).at[m // 3].set(1.0)
    if regime == "degenerate":
        # a handful of particles carry almost all the mass
        x = 30.0 * jax.random.normal(key, (m,))
        return jnp.exp(x - jnp.max(x))
    if regime == "heavy_tail":
        return jax.random.exponential(key, (m,)) ** 4
    raise ValueError(regime)


def _oracle_ancestors(scheme, key, w, n):
    """Reference semantics (Resampling.scala:63-86) in float64: slot j's
    ancestor is the first particle whose cdf exceeds position j, with
    systematic positions (j + u) / n and stratified (j + u_j) / n, using
    the uniforms the package draws from ``key``."""
    w64 = np.asarray(w, np.float64)
    cdf = np.cumsum(w64 / w64.sum())
    j = np.arange(n)
    if scheme == "systematic":
        u = float(jax.random.uniform(key, (), w.dtype))
    else:
        u = np.asarray(jax.random.uniform(key, (n,), w.dtype), np.float64)
    pos = (j + u) / n
    return np.minimum(np.searchsorted(cdf, pos, side="right"), len(w64) - 1)


def _check_against_oracle(scheme, key, w, n):
    counts_fn = {"systematic": rs.systematic_counts,
                 "stratified": rs.stratified_counts}[scheme]
    m = w.shape[0]
    counts = np.asarray(counts_fn(key, w, n))
    # monotone after the guard, closing at n
    assert counts.shape == (m,)
    assert (np.diff(counts) >= 0).all() and counts[-1] == n
    assert counts.min() >= 0
    anc = np.asarray(rs.get_scheme(scheme)(key, w, n))
    assert anc.shape == (n,)
    assert (np.diff(anc) >= 0).all() and anc.min() >= 0 and anc.max() < m
    # the ancestors are exactly those the counts describe
    np.testing.assert_array_equal(
        np.bincount(anc, minlength=m), np.diff(counts, prepend=0))
    # against float64 positions: f32 cdf rounding can move a slot only
    # across a boundary it sits on, so offspring differ by at most one
    want = _oracle_ancestors(scheme, key, w, n)
    diff = np.bincount(anc, minlength=m) - np.bincount(want, minlength=m)
    assert np.abs(diff).max() <= 1, np.abs(diff).max()
    assert (anc != want).mean() <= 0.01


@pytest.mark.parametrize("regime",
                         ["degenerate", "heavy_tail", "one_hot", "uniform"])
@pytest.mark.parametrize("m", [1024, 2048, 4096, 1531])
@pytest.mark.parametrize("scheme", ["systematic", "stratified"])
def test_counts_match_float64_oracle(scheme, m, regime, key):
    k = jax.random.fold_in(key, m)
    w = _weights(regime, m, jax.random.fold_in(k, 1))
    _check_against_oracle(scheme, k, w, m)


@pytest.mark.parametrize("m,n", [(1024, 100), (1531, 4096), (4096, 1024)])
@pytest.mark.parametrize("scheme", ["systematic", "stratified"])
def test_counts_subsample_match_float64_oracle(scheme, m, n, key):
    """n != m output slots (subsampling and supersampling)."""
    k = jax.random.fold_in(key, m + n)
    w = _weights("heavy_tail", m, jax.random.fold_in(k, 1))
    _check_against_oracle(scheme, k, w, n)
