"""Bisection order-statistic selection vs sorting (ops/selection.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from composablestatespacemodels_tpu.ops.selection import kth_smallest_bits


def test_matches_sort_random(key):
    vals = jax.random.normal(key, (5, 1000)) * jnp.asarray(
        [[1e-3], [1.0], [1e4], [1e-30], [1e30]])
    ks = jnp.asarray([[0, 10, 500, 999]] * 5, jnp.int32)
    got = kth_smallest_bits(vals, ks)
    want = jnp.sort(vals, axis=1)[:, jnp.asarray([0, 10, 500, 999])]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_matches_sort_signs_and_ties(key):
    vals = jnp.concatenate([
        -jnp.abs(jax.random.normal(key, (1, 300))),
        jnp.zeros((1, 100)),
        jnp.round(jax.random.normal(jax.random.fold_in(key, 1), (1, 300))),
    ], axis=1)
    vals = jnp.broadcast_to(vals, (3, 700)).astype(jnp.float32)
    ks = jnp.asarray([[0, 299, 350, 699]] * 3, jnp.int32)
    got = kth_smallest_bits(vals, ks)
    want = jnp.sort(vals, axis=1)[:, jnp.asarray([0, 299, 350, 699])]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_rejects_non_f32():
    # (f64 would silently downcast without x64 mode; bf16 is always distinct)
    with pytest.raises(TypeError, match="float32"):
        kth_smallest_bits(jnp.zeros((1, 4), jnp.bfloat16),
                          jnp.zeros((1, 1), jnp.int32))


def test_sharded_reduction_equivalence(key):
    """psum-combined local counts select the global order statistic."""
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    n_dev = len(jax.devices())
    if n_dev < 2:
        pytest.skip("needs multiple devices")
    mesh = Mesh(np.array(jax.devices()), ("p",))
    vals = jax.random.normal(key, (2, 128 * n_dev))
    ks = jnp.asarray([[0, 64, 128 * n_dev - 1]] * 2, jnp.int32)

    def body(v):
        return kth_smallest_bits(v, ks,
                                 psum=lambda c: jax.lax.psum(c, "p"))

    got = shard_map(body, mesh=mesh, in_specs=P(None, "p"),
                    out_specs=P(), check_vma=False)(vals)
    want = jnp.sort(vals, axis=1)[:, jnp.asarray([0, 64, 128 * n_dev - 1])]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
