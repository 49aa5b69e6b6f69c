"""Log-Gaussian Cox process filtering: fine-grid cumulative-hazard weights.

The reference ``FilterLgcp`` (ParticleFilter.scala:169-227) advances each
particle on a fine Euler grid between observation times, accumulating the
cumulative hazard integral sum(exp(f(x_k, t_k)) * h), and weights particles by

    log w = gamma(t) - integral lambda dt      (ParticleFilter.scala:217)

Design: the data-dependent number of fine steps ``ceil(dt * 10^p)``
(ParticleFilter.scala:190) is resolved on the host into ONE flat fine grid
over the whole series -- the union of every segment's Euler substeps, each
slot tagged with static flags (hazard-eval / advance-state / observation) --
and the filter is a single ``lax.scan`` over that grid (SURVEY.md section 7
hard part (d)), fully vectorised over the particle axis.

Cost is therefore O(sum of gaps / h), not O(T * max_gap / h): event-time
data has exponential inter-arrival gaps, and the previous per-observation
``max_substeps``-padded inner scan made every step pay for the largest gap
(one 10x outlier gap cost 10x on *every* observation).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.model import Model
from ..models.tree import Tree
from ..utils.data import TimeSeries
from . import resampling as rs


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class LgcpResult:
    """Per-observation filter output (reference ``PfOut`` + ``getIntervals``,
    ParticleFilter.scala:53-59, 415-424, 488-511: eta intervals use the
    order-statistic flavour of :455-460, state intervals the off-by-one
    flavour of :488-502, both on the post-resample cloud)."""

    ll: jnp.ndarray              # scalar
    ll_history: jnp.ndarray      # [T]
    ess: jnp.ndarray             # [T]
    eta_mean: jnp.ndarray        # [T]  mean intensity exp(gamma)
    eta_lower: jnp.ndarray       # [T]
    eta_upper: jnp.ndarray       # [T]
    state_mean: jnp.ndarray      # [T, d]
    state_lower: jnp.ndarray     # [T, d]
    state_upper: jnp.ndarray     # [T, d]
    final_particles: jnp.ndarray

    def tree_flatten(self):
        return ((self.ll, self.ll_history, self.ess, self.eta_mean,
                 self.eta_lower, self.eta_upper, self.state_mean,
                 self.state_lower, self.state_upper,
                 self.final_particles), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _slot_body(model: Model, sp, h: float, d: int, n_particles: int,
               split_keys, pmax_, psum_, resample, order_stats):
    """The shared per-slot scan body of the single-device and sharded LGCP
    filters (hazard eval BEFORE advance, zero-dt flat-weight case, the
    observation weight/resample step -- ParticleFilter.scala:184-217).

    The integral sums n = ceil(dt/h) hazard evaluations starting AT the
    previous posterior state and the state advances n-1 fine steps
    (calcWeight, ParticleFilter.scala:184-208).  At observation slots
    (``of``) the reference weight/resample step runs under a ``lax.cond``
    so non-observation slots skip the resampling gather; a dt == 0
    observation contributes no integral and flat weights
    (ParticleFilter.scala:212-214: gamma - hazard == 0).

    Parameterised by the per-deployment primitives, exactly as
    ``sharded_filter`` parameterises its save_fns:

      split_keys: ``k -> (k_em, k_res)`` (the sharded flavour folds the
        shard index into ``k_em`` and shares ``k_res`` across shards);
      pmax_/psum_: scalar weight collectives (identities single-device);
      resample: ``(key, x, w) -> x2``;
      order_stats: ``(eta, x2) -> (e_lo, e_hi, s_lo [d], s_hi [d])``.
    """

    def body(carry, inp):
        x, hz, ll = carry
        t_ev, hf, af, of, t_ob, zf, k = inp
        k_em, k_res = split_keys(k)

        gamma_k = model.f(x, t_ev)
        hz1 = hz + jnp.where(hf, jnp.exp(gamma_k) * h, 0.0)
        x_adv = model.sde.step_euler_maruyama(sp, k_em, x, h)
        x1 = jnp.where(af, x_adv, x)
        dtype = x1.dtype

        def obs_case(args):
            x1, hz1, ll = args
            gamma = model.f(x1, t_ob)
            logw = jnp.where(zf, 0.0, gamma - hz1)          # :217
            maxw = pmax_(jnp.max(logw))
            w = jnp.exp(logw - maxw)
            total = psum_(jnp.sum(w))
            ll1 = ll + maxw + jnp.log(total / n_particles)
            wn = w / total
            ess = jnp.floor(
                1.0 / psum_(jnp.sum(wn * wn))).astype(jnp.int32)
            x2 = resample(k_res, x1, w)
            eta = jnp.exp(gamma)
            eta_mean = psum_(jnp.sum(eta)) / n_particles
            s_mean = psum_(jnp.sum(x2, axis=0)) / n_particles
            e_lo, e_hi, s_lo, s_hi = order_stats(eta, x2)
            # the bisection selectors are float32-only; cast back so both
            # lax.cond branches agree under jax_enable_x64 (the sharded eta
            # quantiles are therefore f32-precise even under x64)
            out = (ll1, ess, eta_mean.astype(dtype),
                   e_lo.astype(dtype), e_hi.astype(dtype),
                   s_mean.astype(dtype),
                   s_lo.astype(dtype), s_hi.astype(dtype))
            return (x2, jnp.zeros_like(hz1), ll1), out

        def no_obs(args):
            x1, hz1, ll = args
            z = jnp.asarray(0.0, dtype)
            zd = jnp.zeros((d,), dtype)
            out = (ll, jnp.asarray(0, jnp.int32), z, z, z, zd, zd, zd)
            return (x1, hz1, ll), out

        return jax.lax.cond(of, obs_case, no_obs, (x1, hz1, ll))

    return body


def _interval_ks(n: int, interval: float):
    """Order-statistic (0-based sorted) indices for the eta and state
    interval flavours (ParticleFilter.scala:455-460 / :488-502), as used
    by the bisection selectors."""
    k_os = math.floor(n * interval)
    eta_ks = ((n - k_os) % n, min(k_os, n - 1))
    state_ks = ((n - k_os - 1) % n, (k_os - 1) % n)
    return eta_ks, state_ks


def _result_from_scan(ll, outs, obs_idx, xf):
    ll_hist, ess, em, elo, ehi, sm, slo, shi = tuple(
        o[obs_idx] for o in outs)
    return LgcpResult(ll, ll_hist, ess, em, elo, ehi, sm, slo, shi, xf)


@partial(jax.jit, static_argnames=("model", "n_particles", "precision",
                                   "resample", "interval"))
def _lgcp_impl(model: Model, params: Tree, grid, n_particles: int, key,
               precision: int, resample: str, interval: float):
    """One flat scan over the union fine grid.

    ``grid`` is the host-built tuple
    ``(t_eval, hflag, aflag, oflag, t_obs, zflag, obs_idx)`` -- see
    :func:`lgcp_filter`.  Slot semantics: :func:`_slot_body`.
    """
    from .filter import credible_interval_eta, credible_interval_state

    t_eval, hflag, aflag, oflag, t_obs, zflag, obs_idx = grid
    resample_fn = rs.get_scheme(resample)

    def resample_gather(k, x, w):
        return x[resample_fn(k, w)]
    h = 10.0 ** (-precision)
    sp = model.sde_params(params)

    k_init, k_scan = jax.random.split(key)
    particles = model.initial_state(params, k_init, (n_particles,))
    dtype = particles.dtype
    d = model.dim

    def order_stats(eta, x2):
        e_lo, e_hi = credible_interval_eta(eta, interval)
        s_lo, s_hi = credible_interval_state(x2, interval)
        return e_lo, e_hi, s_lo, s_hi

    body = _slot_body(model, sp, h, d, n_particles,
                      split_keys=jax.random.split,
                      pmax_=lambda v: v, psum_=lambda v: v,
                      resample=resample_gather, order_stats=order_stats)

    keys = jax.random.split(k_scan, t_eval.shape[0])
    init = (particles, jnp.zeros((n_particles,), dtype),
            jnp.asarray(0.0, dtype))
    (xf, _, ll), outs = jax.lax.scan(
        body, init, (t_eval, hflag, aflag, oflag, t_obs, zflag, keys))
    # per-observation histories: gather the observation slots
    return _result_from_scan(ll, outs, obs_idx, xf)


@partial(jax.jit, static_argnames=("model", "n_particles", "precision",
                                   "interval", "mesh", "axis"))
def _lgcp_sharded_impl(model: Model, params: Tree, grid, n_particles: int,
                       key, precision: int, interval: float, mesh, axis):
    """Particle-sharded flat-grid LGCP scan (``shard_map`` over ``axis``).

    Same per-slot semantics as :func:`_lgcp_impl` (literally the same
    :func:`_slot_body`); the only cross-shard communication per observation
    slot is the scalar weight collectives (``pmax``/``psum`` log-sum-exp +
    ESS), the distributed systematic resampler's ring, and the 32-round
    bisection selection for the eta/state order statistics -- no shard
    ever materialises the global cloud (design: parallel/sharded_filter.py;
    reference semantics: ParticleFilter.scala:210-226).  On a 1-wide
    particle axis every collective specialises away (local selector, local
    resample shortcut, identity pmax/psum).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..ops.selection import kth_smallest_bits
    from ..parallel.sharded_filter import (_kth_smallest_sharded,
                                           distributed_systematic_resample)

    t_eval, hflag, aflag, oflag, t_obs, zflag, obs_idx = grid
    n_shards = mesh.shape[axis]
    if n_particles % n_shards:
        raise ValueError(
            f"n_particles={n_particles} not divisible by {n_shards} shards")
    local_n = n_particles // n_shards
    h = 10.0 ** (-precision)
    sp = model.sde_params(params)
    d = model.dim
    eta_ks, state_ks = _interval_ks(n_particles, interval)
    ks_all = jnp.asarray([list(eta_ks)] + [list(state_ks)] * d, jnp.int32)

    def shard_body(params, grid_arrs, key):
        t_eval, hflag, aflag, oflag, t_obs, zflag = grid_arrs
        idx = jax.lax.axis_index(axis)
        # 1-wide particle axis: scalar collectives are identities and the
        # selector drops its 32 per-round psums (see _sharded_scan)
        pmax_ = (lambda v: v) if n_shards == 1 else (
            lambda v: jax.lax.pmax(v, axis))
        psum_ = (lambda v: v) if n_shards == 1 else (
            lambda v: jax.lax.psum(v, axis))

        def split_keys(k):
            k_em = jax.random.fold_in(jax.random.fold_in(k, 1), idx)
            k_res = jax.random.fold_in(k, 2)    # shared across shards
            return k_em, k_res

        def resample(k_res, x1, w):
            # the 1-wide-axis local shortcut lives inside the resampler
            return distributed_systematic_resample(x1, w, k_res, axis)

        def order_stats(eta, x2):
            rows = jnp.concatenate(
                [eta[None].astype(jnp.float32),
                 x2.T.astype(jnp.float32)], axis=0)       # [1+d, local_n]
            if n_shards == 1:
                sel = kth_smallest_bits(rows, ks_all)
            else:
                sel = _kth_smallest_sharded(rows, ks_all, axis)
            return sel[0, 0], sel[0, 1], sel[1:, 0], sel[1:, 1]

        k_init, k_scan = jax.random.split(key)
        x0 = model.initial_state(params, jax.random.fold_in(k_init, idx),
                                 (local_n,))
        dtype = x0.dtype

        body = _slot_body(model, sp, h, d, n_particles, split_keys,
                          pmax_, psum_, resample, order_stats)

        keys = jax.random.split(k_scan, t_eval.shape[0])
        init = (x0, jnp.zeros((local_n,), dtype), jnp.asarray(0.0, dtype))
        (xf, _, ll), outs = jax.lax.scan(
            body, init, (t_eval, hflag, aflag, oflag, t_obs, zflag, keys))
        return ll, outs, xf

    fn = shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(), P(), P(axis)),
        check_vma=False,
    )
    ll, outs, xf = fn(params, (t_eval, hflag, aflag, oflag, t_obs, zflag),
                      key)
    return _result_from_scan(ll, outs, obs_idx, xf)


def lgcp_filter(model: Model, params: Tree, data: TimeSeries,
                n_particles: int, key, *, precision: int = 1,
                resample: str = "systematic",
                interval: float = 0.975, mesh=None,
                axis: str | None = None) -> LgcpResult:
    """Particle filter for a log-Gaussian Cox process over event times.

    ``data.ts`` are the event (or grid) times; weights follow the reference:
    every datum contributes ``gamma - cumulative_hazard``
    (ParticleFilter.scala:210-226).  Output summaries carry eta AND state
    credible intervals (getIntervals, ParticleFilter.scala:415-424).

    The data-dependent fine grids (``ceil(dt/h)`` Euler substeps per
    inter-observation gap, ParticleFilter.scala:190) are flattened on the
    host into one union grid with per-slot flags, so total work is
    O(sum of gaps / h) -- independent of the largest single gap -- and the
    whole filter compiles once per dataset shape.

    ``mesh=`` shards the particle axis over ``mesh[axis]`` (default axis
    :data:`~..parallel.mesh.PARTICLE_AXIS`): scalar weight collectives +
    the distributed systematic resampler + bisection eta/state order
    statistics, no global cloud on any shard (the multi-device tier of
    :func:`~.filter.bootstrap_filter`, applied to the flat fine-grid
    scan).  Systematic resampling only, as ``bootstrap_filter(mesh=)``.
    The sharded order statistics run the float32 bisection selector, so
    eta/state quantiles are f32-precise even under ``jax_enable_x64``.
    """
    model.validate_params(params)
    rs.get_scheme(resample)   # an unknown name raises, listing the schemes
    grid = _build_fine_grid(np.asarray(data.ts, np.float64), precision)
    if mesh is not None:
        if resample != "systematic":
            raise ValueError(
                "lgcp_filter(mesh=...) supports resample='systematic' only "
                f"(got {resample!r}); the sharded path always resamples "
                "with the distributed systematic scheme")
        if axis is None:
            from ..parallel.mesh import PARTICLE_AXIS
            axis = PARTICLE_AXIS
        return _lgcp_sharded_impl(model, params, grid, n_particles, key,
                                  precision, interval, mesh, axis)
    return _lgcp_impl(model, params, grid, n_particles, key, precision,
                      resample, interval)


def _build_fine_grid(ts: np.ndarray, precision: int):
    """Flatten per-segment Euler substeps into one tagged union grid.

    Returns ``(t_eval, hflag, aflag, oflag, t_obs, zflag, obs_idx)`` of
    length K = sum over segments of max(ceil(gap/h), 1): per slot the
    hazard-eval time, whether it contributes a hazard term, whether the
    state advances afterwards (all but each segment's last substep),
    whether it is a segment's observation slot, the observation time, and
    whether the segment is a zero-dt duplicate event; ``obs_idx`` indexes
    the observation slots for gathering per-observation histories.
    """
    n_obs = ts.shape[0]
    h = 10.0 ** (-precision)
    prev = np.concatenate([ts[:1], ts[:-1]])
    gaps = ts - prev
    # ceil(dt/h) with a tiny backoff so exact multiples of h do not round
    # up from float error (the reference computes this in double too)
    n_sub = np.where(gaps > 0,
                     np.ceil(gaps / h - 1e-9), 0).astype(np.int64)
    slots = np.maximum(n_sub, 1)          # zero-dt segments still need a slot
    ends = np.cumsum(slots)
    seg = np.repeat(np.arange(n_obs), slots)              # [K] obs index
    j = np.arange(ends[-1]) - np.repeat(ends - slots, slots)  # within-segment
    n_seg = n_sub[seg]

    f32 = np.float32
    return (jnp.asarray((prev[seg] + j * h).astype(f32)),  # t_eval
            jnp.asarray(n_seg > 0),                        # hflag
            jnp.asarray(j < n_seg - 1),                    # aflag
            jnp.asarray(j == slots[seg] - 1),              # oflag
            jnp.asarray(ts[seg].astype(f32)),              # t_obs
            jnp.asarray(n_seg == 0),                       # zflag
            jnp.asarray(ends - 1))                         # obs_idx
