"""PMMH over a (chains x particles) device mesh.

Chains are data-parallel over the ``chains`` mesh axis (one chain per mesh
row -- the replacement for the reference's two-thread ``mapAsync(2)``
chain parallelism, DetermineParameters.scala:68-69); each chain's inner
particle filter shards its particle cloud over the ``particles`` axis with
collectives (see :mod:`.sharded_filter`).

Everything -- proposals, the PF sweep, the accept/reject step -- lives in one
jitted ``lax.scan`` inside one ``shard_map``; iterations never leave the
device mesh.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..inference.pmmh import (PmmhResult, PmmhState, flat_prior,
                              symmetric_transition)
from ..models.model import Model
from ..models.tree import Tree
from ..utils.data import TimeSeries
from .mesh import CHAIN_AXIS, PARTICLE_AXIS
from .sharded_filter import _sharded_scan, _sharded_scan_t

_INIT_LL = -1e30


def sharded_initial_state(init_params: Tree, n_chains: int,
                          state_dim: int | None = None) -> PmmhState:
    """Fresh per-chain state: params broadcast over a leading [n_chains]
    axis, ll = -1e30 so each chain's first proposal is always accepted
    (PMMH.scala:121).

    ``state_dim``: with ``store_state`` the carried latent state needs a
    [n_chains, state_dim] zeros slot (``model.dim``); the zeros never
    reach the output -- the always-accepted first proposal overwrites
    them with the first PF's sampled state."""
    ftype = jnp.result_type(float)
    params = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.asarray(x)[None],
                                   (n_chains,) + jnp.shape(x)), init_params)
    latent = (() if state_dim is None
              else jnp.zeros((n_chains, state_dim), ftype))
    return PmmhState(params,
                     jnp.full((n_chains,), _INIT_LL, ftype),
                     jnp.zeros((n_chains,), jnp.int32),
                     latent)


@partial(jax.jit,
         static_argnames=("model", "n_particles", "n_iters", "mesh",
                          "proposal", "prior", "log_transition",
                          "transposed", "approx", "store_state"))
def _sharded_pmmh_impl(model: Model, state0: PmmhState, data: TimeSeries,
                       n_particles: int, key, n_iters: int, mesh: Mesh,
                       proposal, prior, log_transition, transposed=False,
                       approx=False, store_state=False):
    n_pshards = mesh.shape[PARTICLE_AXIS]
    if n_particles % n_pshards:
        raise ValueError(
            f"n_particles={n_particles} not divisible by {n_pshards} shards")
    local_n = n_particles // n_pshards

    def body(s0, d, k):
        ci = jax.lax.axis_index(CHAIN_AXIS)
        k = jax.random.fold_in(k, ci)  # independent chain streams
        p0 = jax.tree_util.tree_map(lambda x: x[0], s0.params)
        ll0 = s0.ll[0]
        acc0 = s0.accepted[0]
        st0 = jax.tree_util.tree_map(lambda x: x[0], s0.state)

        def run_scan(kk, p):
            # sync_axes: the adaptive resampling ring's trip count must
            # agree across chain rows too (its ppermutes rendezvous
            # mesh-wide), so the unfilled-count psum spans both axes
            scan = _sharded_scan_t if transposed else _sharded_scan
            return scan(model, p, d, local_n, kk, PARTICLE_AXIS,
                        sync_axes=(CHAIN_AXIS, PARTICLE_AXIS))

        def pf_ll(kk, p):
            return run_scan(kk, p)[0], ()

        def pf_ll_state(kk, p):
            # one particle sampled uniformly from the final (resampled,
            # hence uniformly weighted) GLOBAL cloud (the reference
            # filterLlState, ParticleFilter.scala:346-357): a global
            # index is drawn from the chain-shared key stream, the
            # owning particle shard contributes its row, and a psum
            # replicates it to every shard of the chain
            k_run, k_pick = jax.random.split(kk)
            ll, _, _, xf, _ = run_scan(k_run, p)     # xf [local_n, dim]
            j = jax.random.randint(k_pick, (), 0, n_particles)
            si = jax.lax.axis_index(PARTICLE_AXIS)
            loc = j - si * local_n
            mine = (loc >= 0) & (loc < local_n)
            row = xf[jnp.clip(loc, 0, local_n - 1)]
            st = jax.lax.psum(jnp.where(mine, row, jnp.zeros_like(row)),
                              PARTICLE_AXIS)
            return ll, st

        eval_ll = pf_ll_state if store_state else pf_ll

        def mh_step(carry, kk):
            cur, ll, st, acc = carry
            k_prop, k_pf, k_pf_old, k_u = jax.random.split(kk, 4)
            # proposal key identical on every particle shard of this chain
            prop = proposal(k_prop, cur)
            ll_prop, s_prop = eval_ll(k_pf, prop)
            if approx:
                # doubly-stochastic: refresh the current params' estimate
                # too (ApproxPMMH, PMMH.scala:138-152); the refreshed
                # state stays paired with the refreshed ll
                ll_cur, s_cur = eval_ll(k_pf_old, cur)
            else:
                ll_cur, s_cur = ll, st
            a = (ll_prop + log_transition(prop, cur) + prior(prop)
                 - log_transition(cur, prop) - ll_cur - prior(cur))
            accept = (jnp.log(jax.random.uniform(
                k_u, (), jnp.result_type(float))) < a)
            new = jax.tree_util.tree_map(
                lambda x, y: jnp.where(accept, y, x), cur, prop)
            new_ll = jnp.where(accept, ll_prop, ll_cur)
            new_st = jax.tree_util.tree_map(
                lambda c, q: jnp.where(accept, q, c), s_cur, s_prop)
            new_acc = acc + accept.astype(jnp.int32)
            carry1 = (new, new_ll, new_st, new_acc)
            return carry1, carry1

        keys = jax.random.split(k, n_iters)
        (pf, llf, stf, accf), (ps, lls, sts, accs) = jax.lax.scan(
            mh_step, (p0, ll0, st0, acc0), keys)
        # add a leading local-chain axis so out_specs can lay chains out
        expand = lambda x: x[None]
        ex = lambda t: jax.tree_util.tree_map(expand, t)
        return (ex(ps), lls[None], accs[None], ex(sts),
                ex(pf), llf[None], accf[None], ex(stf))

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P(CHAIN_AXIS), P(), P()),
        out_specs=(P(CHAIN_AXIS),) * 8,
        check_vma=False,
    )
    ps, lls, accs, sts, pf, llf, accf, stf = fn(state0, data, key)
    return (PmmhResult(ps, lls, accs, sts if store_state else None),
            PmmhState(pf, llf, accf, stf))


def sharded_pmmh(model: Model, init_params: Tree, data: TimeSeries,
                 n_particles: int, key, n_iters: int, mesh: Mesh, *,
                 proposal: Callable,
                 prior: Callable = flat_prior,
                 log_transition: Callable = symmetric_transition,
                 approx: bool = False,
                 store_state: bool = False,
                 init_state: PmmhState | None = None,
                 return_state: bool = False,
                 transposed: bool = False) -> PmmhResult:
    """Run ``mesh.shape['chains']`` PMMH chains, each with a
    particle-sharded filter.  Result axes: [n_chains, n_iters, ...].

    Mirrors the single-device tier (:func:`..inference.pmmh.pmmh`):
    ``approx`` re-evaluates the current parameters' likelihood every
    iteration (the reference ApproxPMMH, PMMH.scala:128-153);
    ``store_state`` carries each iteration's sampled latent final state
    (the reference ``MetropState.state``, PMMH.scala:26): one particle
    is drawn uniformly from the final resampled GLOBAL cloud (the owning
    shard's row is psum-replicated across the particle axis), so
    ``(params[c, i], states[c, i])`` are JOINT posterior draws per chain
    -- feed to :func:`~..inference.filter.forecast_from_posterior`;
    ``init_state`` resumes from a per-chain :class:`PmmhState` (leading
    [n_chains] axis on every leaf -- see :func:`sharded_initial_state`),
    overriding ``init_params``; ``return_state`` also returns the final
    per-chain state for chunked/checkpointed runs
    (:func:`sharded_pmmh_monitored`).

    ``transposed``: run each chain's filter in the [d, local_n] layout
    (see sharded_filter)."""
    if init_state is None:
        model.validate_params(init_params)
        init_state = sharded_initial_state(
            init_params, mesh.shape[CHAIN_AXIS],
            state_dim=model.dim if store_state else None)
    elif store_state and isinstance(init_state.state, tuple):
        # resumed state predating store_state: seed a zeros latent carry
        # (emitted until this run's first acceptance -- resume with a
        # store_state checkpoint to avoid the gap)
        init_state = dataclasses.replace(
            init_state,
            state=jnp.zeros((mesh.shape[CHAIN_AXIS], model.dim),
                            jnp.result_type(float)))
    elif not store_state and not isinstance(init_state.state, tuple):
        # store_state checkpoint resumed with the flag off: drop the
        # latent carry (the MH step would otherwise tree_map an array
        # against () and die with an obscure TypeError)
        init_state = dataclasses.replace(init_state, state=())
    result, final = _sharded_pmmh_impl(
        model, init_state, data, n_particles, key, n_iters, mesh, proposal,
        prior, log_transition, transposed=transposed, approx=approx,
        store_state=store_state)
    return (result, final) if return_state else result


def sharded_adaptive_pmmh(model: Model, init_params: Tree, data: TimeSeries,
                          n_particles: int, key, n_iters: int, mesh: Mesh, *,
                          pilot_iters: int = 1000,
                          pilot_delta: float = 0.05,
                          burn_in: int | None = None,
                          thin: int = 2,
                          scale: float | None = None,
                          nugget: float | None = None,
                          prior: Callable = flat_prior,
                          log_transition: Callable = symmetric_transition,
                          approx: bool = False,
                          transposed: bool = False,
                          return_pilot: bool = False):
    """Two-phase adaptive PMMH over the chain mesh (the mesh tier of
    :func:`..inference.pmmh.adaptive_pmmh`).

    Phase 1 runs iid-Gaussian pilot chains on every mesh row; the pooled
    (burned-in, thinned) pilot draws of ALL chains estimate one parameter
    covariance (more pilot samples per wall-clock second than any single
    chain), and phase 2 restarts each chain from its own pilot's final
    parameters with the shared ``perturb_mvn_eigen(scale * cov)``
    proposal.  Reference proposal machinery: Parameters.scala:111-123 MVN
    proposals fed by Utilities.scala:11-18 sample moments.
    """
    from ..models.params import covariance_params, perturb, perturb_mvn_eigen

    k_pilot, k_main = jax.random.split(key)
    pilot = sharded_pmmh(model, init_params, data, n_particles, k_pilot,
                         pilot_iters, mesh, proposal=perturb(pilot_delta),
                         prior=prior, log_transition=log_transition,
                         approx=approx, transposed=transposed)
    b = pilot_iters // 2 if burn_in is None else burn_in
    kept = pilot.thin(burn_in=b, thin=thin)
    # pool chains: [n_chains, kept, ...] -> [n_chains * kept, ...]
    pooled = jax.tree_util.tree_map(
        lambda x: x.reshape((-1,) + x.shape[2:]), kept.params)
    cov = jnp.atleast_2d(covariance_params(pooled))
    dim = cov.shape[0]
    if scale is None:
        scale = 2.38 ** 2 / dim
    if nugget is None:
        nugget = 1e-6 * pilot_delta
    cov = scale * cov + nugget * jnp.eye(dim, dtype=cov.dtype)

    n_chains = mesh.shape[CHAIN_AXIS]
    last = jax.tree_util.tree_map(lambda x: x[:, -1], pilot.params)
    ftype = jnp.result_type(float)
    # ll = -1e30: the main chains re-accept their first proposal (the
    # pilot's ll estimate used a different proposal scale's trajectory)
    init_state = PmmhState(last, jnp.full((n_chains,), _INIT_LL, ftype),
                           jnp.zeros((n_chains,), jnp.int32))
    result = sharded_pmmh(model, init_params, data, n_particles, k_main,
                          n_iters, mesh, proposal=perturb_mvn_eigen(cov),
                          prior=prior, log_transition=log_transition,
                          approx=approx, init_state=init_state,
                          transposed=transposed)
    return (result, pilot) if return_pilot else result


def sharded_pmmh_monitored(key, model: Model, init_params: Tree,
                           data: TimeSeries, n_particles: int,
                           n_iters: int, mesh: Mesh, *,
                           proposal: Callable,
                           chunk_size: int = 1000,
                           prior: Callable = flat_prior,
                           log_transition: Callable = symmetric_transition,
                           approx: bool = False,
                           store_state: bool = False,
                           checkpoint_path: str | None = None,
                           log_every: bool = True,
                           out=None) -> PmmhResult:
    """Mesh chains as a host loop of jitted chunks with acceptance-rate
    monitoring and crash-safe checkpoint/resume -- the mesh tier of
    :func:`..utils.streaming.pmmh_monitored` (reference monitorStream,
    Streaming.scala:72-94; serialisation Streaming.scala:200-241).

    Prints the chain-mean running acceptance after every chunk.  With
    ``checkpoint_path`` the per-chain state (params, ll, accepted, the
    ``store_state`` latent carry, key, completed chunks) persists after
    each chunk and a rerun resumes from it, returning the FULL
    [n_chains, n_iters, ...] chain.  ``store_state`` carries joint
    latent-state draws exactly as :func:`sharded_pmmh` does (reference
    ``MetropState.state`` monitored by Streaming.scala:84-94).
    """
    import sys

    from ..utils.checkpoint import (checkpoint_exists, restore_checkpoint,
                                    save_checkpoint)

    out = sys.stderr if out is None else out
    n_chains = mesh.shape[CHAIN_AXIS]
    n_chunks = -(-n_iters // chunk_size)
    state = sharded_initial_state(
        init_params, n_chains,
        state_dim=model.dim if store_state else None)
    start_chunk = 0

    def _chunk_path(c):
        return f"{checkpoint_path}.chunk{c:05d}"

    def _chunk_template(size):
        zeros = lambda x: jnp.zeros((n_chains, size) + jnp.shape(x),
                                    jnp.result_type(x))
        return PmmhResult(
            jax.tree_util.tree_map(zeros, init_params),
            jnp.zeros((n_chains, size), jnp.result_type(float)),
            jnp.zeros((n_chains, size), jnp.int32),
            zeros(jnp.zeros((model.dim,))) if store_state else None)

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
        for c in range(start_chunk):
            size = min(chunk_size, n_iters - c * chunk_size)
            pieces.append(
                restore_checkpoint(_chunk_path(c), _chunk_template(size)))
        if log_every:
            print(f"[sharded-pmmh] resumed from {checkpoint_path} at chunk "
                  f"{start_chunk}/{n_chunks}", file=out)

    for c in range(start_chunk, n_chunks):
        size = min(chunk_size, n_iters - c * chunk_size)
        k_chunk = jax.random.fold_in(key, c)
        res, state = sharded_pmmh(
            model, init_params, data, n_particles, k_chunk, size, mesh,
            proposal=proposal, prior=prior, log_transition=log_transition,
            approx=approx, store_state=store_state, init_state=state,
            return_state=True)
        pieces.append(jax.device_get(res))
        if log_every:
            total_it = c * chunk_size + size
            acc = float(jnp.mean(state.accepted)) / total_it
            print(f"[sharded-pmmh] iter "
                  f"{min((c + 1) * chunk_size, n_iters)}/{n_iters}  "
                  f"mean acceptance {acc:.3f}  "
                  f"mean ll {float(jnp.mean(state.ll)):.2f}", file=out)
        if checkpoint_path:
            save_checkpoint(_chunk_path(c), pieces[-1])
            save_checkpoint(checkpoint_path, {
                "state": state,
                "key": jax.random.key_data(key),
                "chunk": jnp.asarray(c + 1, jnp.int32),
            })

    cat = lambda *xs: jnp.concatenate([jnp.asarray(x) for x in xs], axis=1)
    return PmmhResult(
        jax.tree_util.tree_map(cat, *[p.params for p in pieces]),
        cat(*[p.lls for p in pieces]),
        cat(*[p.accepted for p in pieces]),
        cat(*[p.states for p in pieces]) if store_state else None)
