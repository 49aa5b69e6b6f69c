"""Drive the system's main path once on one GPU and check what comes out.

  python chip_smoke.py                 # one GPU, flagship widths
  python chip_smoke.py --four-cards    # the multi-device path on 4 GPUs
  python chip_smoke.py --cpu-rehearsal [--four-cards]
                                       # tiny shapes on the CPU

Phases (one process owns the card; any failing phase exits non-zero):

  a  device        platform, kind, count; nvidia-smi name and power limit
  b  cache         where the persistent compile cache lives
  c  flagship      simulate + bootstrap_filter(store='summary') of
                   poisson(ou(1)) + seasonal(24, 3, ou(6)) (d=7),
                   N=2^20, T=1000: compile/warm time, memory
  d  kalman        linear-Gaussian gate against the exact Kalman filter,
                   N=2^20, T=200, every resampling scheme + ess_threshold
  e  pmmh          make_pf_loglik + pmmh at N=100, T=400; pilot_run grid;
                   pmmh_chains with 256 chains
  f  others        interpolation_filter(store='summary'), lgcp_filter,
                   OnlineFilter over chunks, forecast
  g  profile       one short profiler window of the flagship filter

``--four-cards`` runs only the multi-device path and what it is compared
with: the particle-sharded filter (N=2^22) against Kalman and against
the same filter on one card, sharded_pmmh on a 2x2 mesh, and
lgcp_filter / OnlineFilter on the particle mesh.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
Without a GPU the script exits non-zero and prints no such line, unless
``--cpu-rehearsal`` asks for the tiny CPU run (then the line names the
CPU).

Tolerances and why:

* Kalman log-likelihood: the mean of S seeds' PF estimates lies within
  3 Monte-Carlo standard deviations of the exact value, the deviation
  being the sample sd of one estimate over the S seeds.  A bootstrap
  filter's log-likelihood is consistent but biased low by about half
  its variance, which at these N is far inside that band.
* Kalman filtering means: the time-average of |PF mean - Kalman mean| /
  Kalman posterior sd is below 0.05 (N=2^20; MC error of a mean is
  ~1e-3 sd) or 0.25 at rehearsal sizes.
* 'identity' resampling keeps the cloud and drops the weights at every
  observation (Resampling.scala:29), so it has no Kalman answer to meet:
  its run is only checked for finite output.
* Four cards against one card: the mean log-likelihoods of the two
  agree within 3 combined MC standard errors (sqrt(sd1^2/S + sd4^2/S)).
* Every weight contraction and the Kalman oracle run at
  ``Precision.HIGHEST`` (full float32, not TF32).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

import composablestatespacemodels_tpu as cssm
from composablestatespacemodels_tpu.models import (branch, brownian_params,
                                                   leaf, ou_params,
                                                   param_node, parameters,
                                                   perturb)
from composablestatespacemodels_tpu.parallel import (make_mesh, particle_mesh,
                                                     sharded_pmmh)
from composablestatespacemodels_tpu.utils import OnlineFilter
from composablestatespacemodels_tpu.utils.compile_cache import (
    configure_compile_cache)
from composablestatespacemodels_tpu.utils.device import (
    card_name_and_power_limit, device_info, require_gpu)
from composablestatespacemodels_tpu.utils.profiling import (device_op_times,
                                                            trace)


@dataclasses.dataclass(frozen=True)
class Sizes:
    n_flagship: int = 1 << 20
    t_flagship: int = 1000
    n_kalman: int = 1 << 20
    t_kalman: int = 200
    seeds: int = 8
    mean_tol: float = 0.05
    n_pmmh: int = 100
    t_pmmh: int = 400
    pmmh_iters: int = 200
    pilot_counts: tuple = (100, 200, 500, 1000, 2000)
    pilot_reps: int = 100
    n_chains: int = 256
    chain_iters: int = 50
    n_interp: int = 1 << 20
    n_lgcp: int = 1 << 20
    lgcp_end: float = 20.0
    online_chunks: int = 4
    online_len: int = 50
    t_profile: int = 50
    n_four: int = 1 << 22
    t_four: int = 200
    four_pmmh_particles: int = 1 << 16
    four_pmmh_iters: int = 5


REHEARSAL = Sizes(
    n_flagship=1024, t_flagship=40, n_kalman=4096, t_kalman=40, seeds=8,
    mean_tol=0.25, t_pmmh=40, pmmh_iters=20, pilot_counts=(100, 200),
    pilot_reps=8, n_chains=4, chain_iters=5, n_interp=1024, n_lgcp=1024,
    lgcp_end=5.0, online_chunks=2, online_len=10, t_profile=10,
    n_four=4096, t_four=40, four_pmmh_particles=1024, four_pmmh_iters=3)


@dataclasses.dataclass
class Smoke:
    sizes: Sizes
    rehearsal: bool
    card: str = ""          # first card's name and power limit
    nvidia_smi: str = ""    # nvidia-smi's lines, one per card


def say(*parts):
    print(*parts, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(f"check failed: {what}")


def flagship():
    """The composed seasonal-Poisson model of BASELINE.md (d=7)."""
    model = (cssm.poisson(cssm.ou_process(1))
             + cssm.seasonal(24, 3, cssm.ou_process(6)))
    params = branch(
        leaf(param_node(None, ou_params(1.0, 0.2, 0.3, 1.0, 0.3))),
        leaf(param_node(None, ou_params(0.2, 0.2, 0.25, 0.2, 0.2))))
    return model, params


def linear_gaussian():
    model = cssm.linear(cssm.brownian_motion(1))
    params = parameters(jnp.log(0.7), brownian_params(0.5, 0.25, 0.3))
    return model, params


def simulated(model, params, n_steps, seed=0, dt=1.0):
    sim = cssm.simulate_regular(model, params, jax.random.PRNGKey(seed),
                                n_steps, dt=dt)
    return sim.to_timeseries()


def timed(fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def seed_lls(fn, seeds):
    """``fn(key)`` over ``seeds`` keys -> numpy array of log-likelihoods."""
    return np.asarray([float(fn(jax.random.PRNGKey(100 + s)))
                       for s in range(seeds)])


def kalman_agreement(name, lls, kf_ll):
    mean, sd = float(lls.mean()), float(lls.std(ddof=1))
    z = abs(mean - kf_ll) / sd if sd > 0 else math.inf
    say(f"  {name}: PF ll {mean:.4f} (sd {sd:.4f} over {len(lls)} seeds), "
        f"Kalman {kf_ll:.4f}, |diff|/sd {z:.2f}")
    check(z <= 3.0, f"{name}: PF ll within 3 MC sd of Kalman")


def mean_agreement(name, summary_mean, kf, tol):
    err = np.abs(np.asarray(summary_mean[:, 0]) - np.asarray(kf.means[:, 0]))
    rel = float((err / np.sqrt(np.asarray(kf.covs[:, 0, 0]))).mean())
    say(f"  {name}: mean |PF - Kalman| filtering mean = {rel:.4f} "
        f"posterior sd (tolerance {tol})")
    check(rel < tol, f"{name}: filtering means within {tol} sd")


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


def phase_device(ctx: Smoke):
    info = require_gpu(ctx.rehearsal)
    say(f"  platform {info['platform']}, kind {info['kind']}, "
        f"count {info['count']}")
    ctx.nvidia_smi = ("no card (cpu rehearsal)" if ctx.rehearsal
                      else card_name_and_power_limit())
    cards = ctx.nvidia_smi.splitlines()
    ctx.card = cards[0] + (f" (x{len(cards)})" if len(cards) > 1 else "")
    for line in cards:
        say(f"  nvidia-smi: {line}")


def phase_cache(ctx: Smoke):
    say(f"  compile cache: {configure_compile_cache()}")


def phase_flagship(ctx: Smoke):
    z = ctx.sizes
    model, params = flagship()
    data = simulated(model, params, z.t_flagship)
    n = z.n_flagship

    def run(key):
        return cssm.bootstrap_filter(model, params, data, n, key,
                                     store="summary")

    key = jax.random.PRNGKey(1)
    t0 = time.perf_counter()
    compiled = jax.jit(run).lower(key).compile()
    compile_s = time.perf_counter() - t0
    _, first_s = timed(compiled, key)
    res, warm_s = timed(compiled, jax.random.PRNGKey(2))
    ll = float(res.ll)
    ess = np.asarray(res.ess)
    say(f"  N={n} T={z.t_flagship} d={model.dim}: ll {ll:.3f}, "
        f"ESS min {ess.min()} max {ess.max()}")
    say(f"  compile {compile_s:.2f}s, first run {first_s:.3f}s, warm run "
        f"{warm_s:.4f}s = {n * z.t_flagship / warm_s:.4e} particle-steps/s "
        f"({ctx.card})")
    say(f"  memory_analysis: {compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'n/a')}")
    check(np.isfinite(ll), "flagship ll finite")
    check(ess.min() >= 1 and ess.max() <= n, "flagship ESS in [1, N]")
    s = res.summary
    for f in ("eta_mean", "eta_lower", "eta_upper", "state_mean",
              "state_lower", "state_upper"):
        check(bool(jnp.isfinite(getattr(s, f)).all()), f"summary {f} finite")
    check(s.state_mean.shape == (z.t_flagship, model.dim), "summary shape")


def phase_kalman(ctx: Smoke):
    z = ctx.sizes
    model, params = linear_gaussian()
    data = simulated(model, params, z.t_kalman, dt=0.5)
    kf = cssm.kalman_filter(model, params, data)
    kf_ll = float(kf.ll)
    n = z.n_kalman
    say(f"  linear-Gaussian over brownian_motion(1), N={n}, T={z.t_kalman}; "
        "weights and Kalman at Precision.HIGHEST")
    runs = [(s, {}) for s in ("systematic", "stratified", "multinomial",
                              "residual", "identity")]
    runs.append(("systematic", {"ess_threshold": 0.5}))
    for scheme, extra in runs:
        name = scheme + (" ess_threshold=0.5" if extra else "")
        run = jax.jit(lambda k, scheme=scheme, extra=extra:
                      cssm.bootstrap_filter(model, params, data, n, k,
                                            resample=scheme, store="summary",
                                            **extra))
        res = run(jax.random.PRNGKey(7))
        check(bool(jnp.isfinite(res.ll)), f"{name}: ll finite")
        if scheme == "identity":
            say(f"  {name}: ll {float(res.ll):.4f} finite (no Kalman gate: "
                "identity drops the weights)")
            continue
        lls = seed_lls(lambda k: run(k).ll, z.seeds)
        kalman_agreement(name, lls, kf_ll)
        mean_agreement(name, res.summary.state_mean, kf, z.mean_tol)


def phase_pmmh(ctx: Smoke):
    z = ctx.sizes
    model, params = flagship()
    data = simulated(model, params, z.t_pmmh)
    pf_ll = cssm.make_pf_loglik(model, data, z.n_pmmh)

    def chain(k):
        return cssm.pmmh(k, params, pf_ll, perturb(0.05), z.pmmh_iters)

    res, first_s = timed(chain, jax.random.PRNGKey(3))
    res, warm_s = timed(chain, jax.random.PRNGKey(4))
    rate = float(res.acceptance_rate())
    say(f"  pmmh N={z.n_pmmh} T={z.t_pmmh}: {z.pmmh_iters} iters, "
        f"acceptance {rate:.3f}, first call {first_s:.2f}s, "
        f"{z.pmmh_iters / warm_s:.2f} iters/s ({ctx.card})")
    check(bool(jnp.isfinite(res.lls).all()), "pmmh lls finite")
    check(0.0 < rate < 1.0, "pmmh acceptance in (0, 1)")

    grid, grid_s = timed(lambda: cssm.pilot_run(
        model, params, data, jax.random.PRNGKey(5),
        particle_counts=z.pilot_counts, n_reps=z.pilot_reps))
    for n, m, v in grid:
        say(f"  pilot N={n}: mean ll {m:.3f}, var {v:.4f}")
        check(np.isfinite(m) and np.isfinite(v), f"pilot N={n} finite")
    say(f"  pilot grid: {grid_s:.2f}s including one compile per N")

    def chains(k):
        return cssm.pmmh_chains(k, params, pf_ll, perturb(0.05),
                                z.chain_iters, z.n_chains)

    res_c, first_s = timed(chains, jax.random.PRNGKey(6))
    res_c, warm_s = timed(chains, jax.random.PRNGKey(7))
    rates = np.asarray(res_c.acceptance_rate())
    say(f"  pmmh_chains {z.n_chains} chains x {z.chain_iters} iters: "
        f"mean acceptance {rates.mean():.3f}, first call {first_s:.2f}s, "
        f"{z.n_chains * z.chain_iters / warm_s:.2f} aggregate "
        f"chain-iters/s ({ctx.card})")
    check(res_c.lls.shape == (z.n_chains, z.chain_iters), "chains shape")
    check(bool(jnp.isfinite(res_c.lls).all()), "chains lls finite")
    check(0.0 < rates.mean() < 1.0, "chains acceptance in (0, 1)")


def phase_others(ctx: Smoke):
    z = ctx.sizes
    model, params = flagship()
    data = simulated(model, params, z.t_flagship)
    t_end = float(data.ts[-1])
    gap = data.knock_out(0.4 * t_end, 0.45 * t_end)
    key = jax.random.PRNGKey(8)

    ip, ip_s = timed(lambda: cssm.interpolation_filter(
        model, params, gap, z.n_interp, key, store="summary"))
    say(f"  interpolation_filter(store='summary') N={z.n_interp} "
        f"T={z.t_flagship}: ll {float(ip.ll):.3f} ({ip_s:.2f}s with "
        "compile)")
    for f in ("ll", "state_mean", "state_lower", "state_upper", "eta_mean"):
        check(bool(jnp.isfinite(getattr(ip, f)).all()),
              f"interpolation {f} finite")

    lmodel = cssm.lgcp(cssm.brownian_motion(1))
    lparams = parameters(None, brownian_params(1.0, 0.05, 0.1))
    events, _ = cssm.simulate_lgcp(lmodel, lparams, jax.random.PRNGKey(2),
                                   0.0, z.lgcp_end)
    lg, lg_s = timed(lambda: cssm.lgcp_filter(
        lmodel, lparams, events.to_timeseries(), z.n_lgcp, key,
        precision=1))
    say(f"  lgcp_filter N={z.n_lgcp}, {events.ts.shape[0]} events: "
        f"ll {float(lg.ll):.3f} ({lg_s:.2f}s with compile)")
    for f in ("ll", "eta_mean", "state_mean", "state_lower", "state_upper"):
        check(bool(jnp.isfinite(getattr(lg, f)).all()), f"lgcp {f} finite")

    of = OnlineFilter(model, params, z.n_flagship, key,
                                 t0=float(data.ts[0]) - 1.0, store="summary")
    for c in range(z.online_chunks):
        sl = slice(c * z.online_len, (c + 1) * z.online_len)
        chunk = cssm.TimeSeries(data.ts[sl], data.ys[sl], data.mask[sl])
        res, chunk_s = timed(of.step, chunk)
        say(f"  OnlineFilter chunk {c}: {z.online_len} steps, "
            f"{chunk_s:.3f}s")
        check(bool(jnp.isfinite(res.summary.state_mean).all()),
              f"online chunk {c} summary finite")
    check(bool(jnp.isfinite(of.ll)), "online ll finite")
    say(f"  OnlineFilter N={z.n_flagship}: running ll {float(of.ll):.3f}")

    t_last = float(of.t)
    fc = cssm.forecast(model, params, of.particles, t_last, t_last + 1.0,
                       key)
    fcs = cssm.forecast_times(model, params, of.particles, t_last,
                              t_last + jnp.arange(1.0, 11.0), key)
    check(bool(jnp.isfinite(fc.obs_mean)), "forecast finite")
    check(bool(jnp.isfinite(fcs.state_mean).all())
          and fcs.obs_mean.shape == (10,), "forecast_times finite")
    say(f"  forecast: obs mean {float(fc.obs_mean):.3f} "
        f"[{float(fc.obs_lower):.1f}, {float(fc.obs_upper):.1f}]")


def phase_profile(ctx: Smoke):
    z = ctx.sizes
    model, params = flagship()
    data = simulated(model, params, z.t_profile)
    n = z.n_flagship
    run = jax.jit(lambda k: cssm.bootstrap_filter(model, params, data, n, k,
                                                  store="summary"))
    jax.block_until_ready(run(jax.random.PRNGKey(9)))
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            res = jax.block_until_ready(run(jax.random.PRNGKey(10)))
        red = device_op_times(d)
    check(bool(jnp.isfinite(res.ll)), "profiled run finite")
    if ctx.rehearsal:
        say("  cpu rehearsal: no device plane, nothing to report")
        return
    check(red["n_events"] > 0, "the trace holds device events")
    say(f"  window {red['window_ns'] / 1e6:.3f} ms over T={z.t_profile} "
        f"steps, device busy {red['busy_ns'] / 1e6:.3f} ms, idle share "
        f"{red['idle_share']:.3f} ({ctx.card})")
    for name, ns in list(red["ops"].items())[:10]:
        say(f"    {ns / 1e3 / z.t_profile:10.2f} us/step  {name}")


PHASES = {
    "device": phase_device,
    "cache": phase_cache,
    "flagship": phase_flagship,
    "kalman": phase_kalman,
    "pmmh": phase_pmmh,
    "others": phase_others,
    "profile": phase_profile,
}


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------


def four_devices(ctx: Smoke):
    devs = jax.devices()
    check(len(devs) >= 4, f"four devices visible (have {len(devs)})")
    return devs[:4]


def phase_four_device(ctx: Smoke):
    phase_device(ctx)
    four_devices(ctx)


def phase_four_kalman(ctx: Smoke):
    z = ctx.sizes
    mesh = particle_mesh(devices=four_devices(ctx))
    model, params = linear_gaussian()
    data = simulated(model, params, z.t_four, dt=0.5)
    kf = cssm.kalman_filter(model, params, data)
    n = z.n_four
    run = jax.jit(lambda k: cssm.bootstrap_filter(
        model, params, data, n, k, store="summary", mesh=mesh))
    res, first_s = timed(run, jax.random.PRNGKey(7))
    say(f"  sharded linear-Gaussian N={n} over {mesh.devices.size} devices,"
        f" T={z.t_four}: first call {first_s:.2f}s")
    lls = seed_lls(lambda k: run(k).ll, z.seeds)
    kalman_agreement("sharded systematic", lls, float(kf.ll))
    mean_agreement("sharded systematic", res.summary.state_mean, kf,
                   z.mean_tol)


def phase_four_flagship(ctx: Smoke):
    z = ctx.sizes
    devs = four_devices(ctx)
    mesh = particle_mesh(devices=devs)
    model, params = flagship()
    data = simulated(model, params, z.t_four)
    n = z.n_four
    sharded = jax.jit(lambda k: cssm.log_likelihood(
        model, params, data, n, k, mesh=mesh))
    _, s_first = timed(sharded, jax.random.PRNGKey(0))
    _, s_warm = timed(sharded, jax.random.PRNGKey(1))
    with jax.default_device(devs[0]):
        one = jax.jit(lambda k: cssm.log_likelihood(model, params, data,
                                                    n, k))
        _, o_first = timed(one, jax.random.PRNGKey(0))
        _, o_warm = timed(one, jax.random.PRNGKey(1))
        ll1 = seed_lls(one, z.seeds)
    ll4 = seed_lls(sharded, z.seeds)
    se = math.sqrt(ll1.var(ddof=1) / len(ll1) + ll4.var(ddof=1) / len(ll4))
    diff = abs(ll4.mean() - ll1.mean())
    say(f"  flagship N={n} T={z.t_four}: 4 devices ll {ll4.mean():.4f} "
        f"(sd {ll4.std(ddof=1):.4f}), 1 device ll {ll1.mean():.4f} "
        f"(sd {ll1.std(ddof=1):.4f}); |diff| = {diff / se:.2f} combined "
        "MC standard errors")
    say(f"  warm run: 4 devices {s_warm:.4f}s "
        f"({n * z.t_four / s_warm:.4e} particle-steps/s), 1 device "
        f"{o_warm:.4f}s ({n * z.t_four / o_warm:.4e}); first calls "
        f"{s_first:.2f}s / {o_first:.2f}s ({ctx.card})")
    check(np.isfinite(ll4).all() and np.isfinite(ll1).all(), "lls finite")
    check(diff <= 3.0 * se, "4-device flagship within 3 MC se of 1 device")


def phase_four_pmmh(ctx: Smoke):
    z = ctx.sizes
    mesh = make_mesh(2, 2, devices=four_devices(ctx))
    model, params = flagship()
    data = simulated(model, params, z.t_pmmh)
    res, s = timed(lambda: sharded_pmmh(
        model, params, data, z.four_pmmh_particles, jax.random.PRNGKey(3),
        z.four_pmmh_iters, mesh, proposal=perturb(0.05)))
    say(f"  sharded_pmmh 2x2 mesh, N={z.four_pmmh_particles} "
        f"T={z.t_pmmh}, {z.four_pmmh_iters} iters: last lls "
        f"{np.asarray(res.lls)[:, -1]} ({s:.2f}s with compile)")
    check(res.lls.shape == (2, z.four_pmmh_iters), "sharded pmmh shape")
    check(bool(jnp.isfinite(res.lls).all()), "sharded pmmh lls finite")


def phase_four_lgcp_online(ctx: Smoke):
    z = ctx.sizes
    mesh = particle_mesh(devices=four_devices(ctx))
    key = jax.random.PRNGKey(8)
    lmodel = cssm.lgcp(cssm.brownian_motion(1))
    lparams = parameters(None, brownian_params(1.0, 0.05, 0.1))
    events, _ = cssm.simulate_lgcp(lmodel, lparams, jax.random.PRNGKey(2),
                                   0.0, z.lgcp_end)
    lg = cssm.lgcp_filter(lmodel, lparams, events.to_timeseries(),
                          z.n_four, key, precision=1, mesh=mesh)
    say(f"  sharded lgcp_filter N={z.n_four}: ll {float(lg.ll):.3f}")
    check(bool(jnp.isfinite(lg.ll)) and bool(
        jnp.isfinite(lg.state_mean).all()), "sharded lgcp finite")

    model, params = flagship()
    data = simulated(model, params, z.online_len)
    of = OnlineFilter(model, params, z.n_four, key,
                                 t0=float(data.ts[0]) - 1.0, store="summary",
                                 mesh=mesh)
    res = of.step(data)
    say(f"  sharded OnlineFilter chunk of {z.online_len}: ll "
        f"{float(of.ll):.3f}")
    check(bool(jnp.isfinite(of.ll))
          and bool(jnp.isfinite(res.summary.state_mean).all()),
          "sharded online chunk finite")


FOUR_CARD_PHASES = {
    "device": phase_four_device,
    "cache": phase_cache,
    "sharded_kalman": phase_four_kalman,
    "sharded_flagship": phase_four_flagship,
    "sharded_pmmh": phase_four_pmmh,
    "sharded_lgcp_online": phase_four_lgcp_online,
}


def run_phases(phases, ctx: Smoke):
    for name, fn in phases.items():
        say(f"[phase {name}]")
        t0 = time.perf_counter()
        fn(ctx)
        say(f"[phase {name}] ok ({time.perf_counter() - t0:.1f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path, on 4 GPUs")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny shapes on the CPU; measures nothing")
    args = ap.parse_args(argv)
    if args.cpu_rehearsal and args.four_cards:
        # four virtual CPU devices; read when the backend first starts
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=4").strip()
    ctx = Smoke(REHEARSAL if args.cpu_rehearsal else Sizes(),
                args.cpu_rehearsal)
    run_phases(FOUR_CARD_PHASES if args.four_cards else PHASES, ctx)
    say(ctx.nvidia_smi)
    print(json.dumps({"ok": True, "device": device_info()}), flush=True)


if __name__ == "__main__":
    main()
