"""Streaming / online tooling: chunked filters, monitored + checkpointed PMMH.

The reference expresses online filtering and MCMC experiment plumbing as Akka
Streams stages (Streaming.scala:14-242).  The equivalents here:

* :class:`OnlineFilter` -- an unbounded stream becomes host-fed chunks, each
  processed by one jitted ``lax.scan`` with the particle cloud carried
  across chunks (the ``Flow.scan`` of ParticleFilter.scala:163-166, without
  holding the whole stream);
* :func:`pmmh_monitored` -- long chains run as a host loop of jitted chunks
  with acceptance-rate monitoring every chunk (monitorStream,
  Streaming.scala:72-94) and crash-safe checkpoint/resume
  (Streaming.scala:200-241's serialisation, rebuilt on
  :mod:`.checkpoint`).
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.model import Model
from ..models.tree import Tree
from .checkpoint import checkpoint_exists, restore_checkpoint, save_checkpoint
from .data import TimeSeries

# NOTE: inference modules import utils.data, so inference imports here are
# deferred into the functions to break the package-init cycle.


class OnlineFilter:
    """Feed observation chunks as they arrive; filtering state persists.

    Example::

        f = OnlineFilter(model, params, n_particles=10_000,
                         key=jax.random.PRNGKey(0), t0=0.0)
        for chunk in stream:          # chunk: TimeSeries
            summary = f.step(chunk)   # jitted scan over the chunk
        f.ll                          # running log marginal likelihood
    """

    def __init__(self, model: Model, params: Tree, n_particles: int, key,
                 t0: float, *, resample: str = "systematic",
                 store: str = "summary", interval: float = 0.975,
                 mesh=None):
        """``mesh``: optional particle-sharded multi-chip filtering (the
        carried cloud keeps its device sharding across chunks)."""
        model.validate_params(params)
        self.model = model
        self.params = params
        self.n_particles = n_particles
        self.resample = resample
        self.store = store
        self.interval = interval
        self.mesh = mesh
        from ..inference.filter import bootstrap_filter  # deferred
        self._filter = bootstrap_filter
        self._key = key
        # the initial cloud is drawn by the first step's filter call
        # (initial_state=None): on a mesh that happens per shard inside
        # shard_map, so no host ever materialises the full [N, d] cloud
        self.particles = None
        dtype = jnp.result_type(float)
        self.t = jnp.asarray(t0, dtype)
        self.ll = jnp.asarray(0.0, dtype)
        self.n_observed = 0

    def step(self, chunk: TimeSeries):
        """Filter one chunk; returns its :class:`FilterResult` (summaries are
        per-chunk; ``self.ll`` accumulates across chunks)."""
        self._key, k = jax.random.split(self._key)
        res = self._filter(
            self.model, self.params, chunk, self.n_particles, k,
            resample=self.resample, t0=float(self.t),
            initial_state=self.particles, store=self.store,
            interval=self.interval, mesh=self.mesh)
        self.particles = res.final_particles
        self.t = chunk.ts[-1]
        self.ll = self.ll + res.ll
        self.n_observed += int(chunk.ts.shape[0])
        return res


def pmmh_monitored(key, init_params: Tree, pf_ll: Callable,
                   proposal: Callable, n_iters: int, *,
                   chunk_size: int = 1000,
                   prior: Callable = None,
                   log_transition: Callable = None,
                   approx: bool = False,
                   store_state: bool = False,
                   checkpoint_path: Optional[str] = None,
                   log_every: bool = True,
                   out=None) -> PmmhResult:
    """PMMH as a host loop of jitted chunks with monitoring + checkpointing.

    Prints the running acceptance rate after every chunk (the reference
    prints every 100 iterations, Streaming.monitorStream,
    Streaming.scala:72-94).  If ``checkpoint_path`` is given, chain state
    (params, ll, accepted, key, completed chunks) is saved after each chunk
    and the run resumes from it if present.  ``store_state`` carries the
    sampled latent state through the chain and checkpoints (joint-posterior
    chains, the reference monitorStateStream, Streaming.scala:84-94);
    ``pf_ll`` must then return ``(ll, state)``
    (``make_pf_loglik(..., store_state=True)``).
    """
    from ..inference.pmmh import (PmmhResult, _seed_latent, flat_prior,
                                  initial_state, pmmh, symmetric_transition)

    prior = flat_prior if prior is None else prior
    log_transition = (symmetric_transition if log_transition is None
                      else log_transition)
    out = sys.stderr if out is None else out
    n_chunks = -(-n_iters // chunk_size)
    state = _seed_latent(initial_state(init_params), pf_ll, key, store_state)
    start_chunk = 0

    def _chunk_path(c):
        return f"{checkpoint_path}.chunk{c:05d}"

    def _chunk_template(size):
        zeros = lambda x: jnp.zeros((size,) + jnp.shape(x),
                                    jnp.result_type(x))
        return PmmhResult(
            jax.tree_util.tree_map(zeros, init_params),
            jnp.zeros((size,), jnp.result_type(float)),
            jnp.zeros((size,), jnp.int32),
            None if not store_state
            else jax.tree_util.tree_map(zeros, state.state))

    pieces = []
    if checkpoint_path and checkpoint_exists(checkpoint_path):
        template = {
            "state": state,
            "key": jax.random.key_data(key),
            "chunk": jnp.asarray(0, jnp.int32),
        }
        saved = restore_checkpoint(checkpoint_path, template)
        state = saved["state"]
        key = jax.random.wrap_key_data(saved["key"])
        start_chunk = int(saved["chunk"])
        # reload completed chunks so a resumed run returns the FULL chain
        for c in range(start_chunk):
            size = min(chunk_size, n_iters - c * chunk_size)
            pieces.append(
                restore_checkpoint(_chunk_path(c), _chunk_template(size)))
        if log_every:
            print(f"[pmmh] resumed from {checkpoint_path} at chunk "
                  f"{start_chunk}/{n_chunks}", file=out)

    for c in range(start_chunk, n_chunks):
        size = min(chunk_size, n_iters - c * chunk_size)
        k_chunk = jax.random.fold_in(key, c)
        res, state = pmmh(k_chunk, init_params, pf_ll, proposal, size,
                          prior=prior, log_transition=log_transition,
                          approx=approx, store_state=store_state,
                          init_state=state, return_state=True)
        pieces.append(jax.device_get(res))
        if log_every:
            total_acc = int(state.accepted)
            total_it = c * chunk_size + size
            print(f"[pmmh] iter {min((c + 1) * chunk_size, n_iters)}"
                  f"/{n_iters}  acceptance {total_acc / total_it:.3f}  "
                  f"ll {float(state.ll):.2f}", file=out)
        if checkpoint_path:
            save_checkpoint(_chunk_path(c), pieces[-1])
            save_checkpoint(checkpoint_path, {
                "state": state,
                "key": jax.random.key_data(key),
                "chunk": jnp.asarray(c + 1, jnp.int32),
            })

    cat = lambda *xs: jnp.concatenate([jnp.asarray(x) for x in xs], axis=0)
    return PmmhResult(
        jax.tree_util.tree_map(cat, *[p.params for p in pieces]),
        cat(*[p.lls for p in pieces]),
        cat(*[p.accepted for p in pieces]),
        None if not store_state else jax.tree_util.tree_map(
            cat, *[p.states for p in pieces]))


def thin_stream(xs, step: int):
    """Take every ``step``-th element (Streaming.thinStream,
    Streaming.scala:100-105)."""
    return jax.tree_util.tree_map(lambda a: a[::step], xs)


def ascii_histogram(values, bins: int = 20, width: int = 50,
                    out=None) -> None:
    """ASCII histogram of samples (ParticleFilter.hist,
    ParticleFilter.scala:439-447)."""
    out = sys.stdout if out is None else out
    values = np.asarray(values)
    counts, edges = np.histogram(values, bins=bins)
    peak = max(int(counts.max()), 1)
    for c, lo in zip(counts, edges[:-1]):
        bar = "#" * int(width * c / peak)
        print(f"{lo:10.3f} | {bar} {c}", file=out)


def min_sink(values, initial: float = 0.0) -> float:
    """Running minimum fold over a stream (Streaming.minSink,
    Streaming.scala:197-198).  Faithfully keeps the reference's ``0.0``
    seed, so an all-positive stream returns 0.0 -- documented quirk."""
    out = initial
    for v in values:
        v = float(v)
        if v < out:
            out = v
    return out


def monitor_stream(records, every: int = 100, out=None):
    """Yield PMMH iteration records unchanged, printing the running
    acceptance rate every ``every`` records (the stateless
    Streaming.monitorStream, Streaming.scala:72-82; records expose
    ``.accepted`` or are ``(.., accepted)`` tuples)."""
    out = sys.stderr if out is None else out
    for i, rec in enumerate(records, start=1):
        if i % every == 0:
            acc = getattr(rec, "accepted", rec[-1] if isinstance(
                rec, (tuple, list)) else rec)
            print(f"Iteration: {i}, accepted: {float(acc) / i}", file=out)
        yield rec


def windowed_mean_params(stacked, window: int):
    """Tumbling-window means of a stacked parameter pytree
    (Streaming.calculateMeanParameters, Streaming.scala:62-67).  Returns a
    stacked pytree with ``n // window`` entries (trailing partial window
    dropped, as ``grouped`` emits only full groups when truncated)."""
    n = jax.tree_util.tree_leaves(stacked)[0].shape[0]
    k = n // window

    def group_mean(x):
        return jnp.mean(
            x[:k * window].reshape((k, window) + x.shape[1:]), axis=1)

    return jax.tree_util.tree_map(group_mean, stacked)
