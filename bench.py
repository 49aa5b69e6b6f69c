"""Headline benchmark: 2^20-particle, 1000-step composed seasonal-Poisson
bootstrap particle filter (BASELINE.md north-star config).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}, "card": ...}

``vs_baseline`` divides by a **measured** CPU baseline: the reference
publishes no numbers and no JVM exists in the build image, so
``baseline_numpy.py`` -- a semantics-faithful single-thread NumPy port of
the reference hot loop (ParticleFilter.scala:116-132, Sde.scala:142-150,
Resampling.scala:63-72) -- was measured at 1.31e6 particle-steps/s on a
CPU (BASELINE.md).

Times are host wall-clock around ``block_until_ready``; every result names
the device it ran on.  Without a GPU the script exits non-zero.

Usage:
  python bench.py                  # full: N=2^20, T=1000 on the GPU
  python bench.py --smoke          # tiny shapes on the GPU
  python bench.py --no-secondary   # headline only (skip PMMH, LGCP, mesh)
  python bench.py --cpu-rehearsal  # tiny shapes on the CPU (no device
                                   # numbers; proves the control flow)
"""

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp

import composablestatespacemodels_tpu as cssm
from composablestatespacemodels_tpu.models import (branch, leaf, ou_params,
                                                   param_node)
from composablestatespacemodels_tpu.utils.compile_cache import (
    configure_compile_cache)
from composablestatespacemodels_tpu.utils.device import (
    card_name_and_power_limit, require_gpu)

# Measured single-thread NumPy port of the reference hot loop
# (baseline_numpy.py, best of 3, on a CPU; see BASELINE.md).
BASELINE_PARTICLE_STEPS_PER_SEC = 1.31e6


def flagship_model():
    model = (cssm.poisson(cssm.ou_process(1))
             + cssm.seasonal(24, 3, cssm.ou_process(6)))
    params = branch(
        leaf(param_node(None, ou_params(1.0, 0.2, 0.3, 1.0, 0.3))),
        leaf(param_node(None, ou_params(0.2, 0.2, 0.25, 0.2, 0.2))))
    return model, params


def best_time(fn, key, repeats: int = 3) -> float:
    """Compile + warm ``fn(key)``, then the best of ``repeats`` timed calls
    (fresh keys), each ended by ``block_until_ready``."""
    jax.block_until_ready(fn(key))
    best = float("inf")
    for i in range(repeats):
        k = jax.random.fold_in(key, i + 1)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(k))
        best = min(best, time.perf_counter() - t0)
    return best


def run(n_particles: int, n_steps: int) -> float:
    model, params = flagship_model()
    key = jax.random.PRNGKey(0)
    sim = cssm.simulate_regular(model, params, key, n_steps, dt=1.0)
    data = sim.to_timeseries()

    def ll(k):
        return cssm.log_likelihood(model, params, data, n_particles, k)

    best = best_time(ll, key)
    rate = n_particles * n_steps / best
    print(f"filter: {rate:.4e} particle-steps/s (N={n_particles}, "
          f"T={n_steps}, d={model.dim})", file=sys.stderr)
    return rate


def bench_sharded(n_particles: int, n_steps: int = 200) -> float:
    """The mesh-tier filter (``bootstrap_filter(mesh=)``) on a particle
    mesh over every visible device."""
    from composablestatespacemodels_tpu.parallel import particle_mesh

    model, params = flagship_model()
    key = jax.random.PRNGKey(0)
    sim = cssm.simulate_regular(model, params, key, n_steps, dt=1.0)
    data = sim.to_timeseries()
    mesh = particle_mesh()

    def ll(k):
        return cssm.bootstrap_filter(model, params, data, n_particles, k,
                                     mesh=mesh, store="ll").ll

    rate = n_particles * n_steps / best_time(ll, key)
    print(f"sharded filter ({mesh.devices.size} device(s)): "
          f"{rate:.4e} particle-steps/s", file=sys.stderr)
    return rate


def bench_pmmh(n_particles: int = 100, n_obs: int = 400,
               n_iters: int = 500) -> float:
    """PMMH iterations/sec -- one full PF sweep per iteration at the
    reference's DeterminePosterior shape (100 particles,
    DetermineParameters.scala:55-85)."""
    from composablestatespacemodels_tpu.models import perturb

    model, params = flagship_model()
    key = jax.random.PRNGKey(0)
    sim = cssm.simulate_regular(model, params, key, n_obs, dt=1.0)
    pf_ll = cssm.make_pf_loglik(model, sim.to_timeseries(), n_particles)

    def chain(k):
        return cssm.pmmh(k, params, pf_ll, perturb(0.05), n_iters).lls

    rate = n_iters / best_time(chain, key)
    print(f"PMMH: {rate:.2f} iters/s at N={n_particles}, T={n_obs}",
          file=sys.stderr)
    return rate


def bench_pmmh_chains(n_chains: int = 256, n_particles: int = 100,
                      n_obs: int = 400, n_iters: int = 200) -> float:
    """Aggregate chains x iterations/sec of vmapped PMMH chains
    (``pmmh_chains``; the reference's mapAsync(2) thread parallelism,
    DetermineParameters.scala:68-69, scaled out)."""
    from composablestatespacemodels_tpu.models import perturb

    model, params = flagship_model()
    key = jax.random.PRNGKey(0)
    sim = cssm.simulate_regular(model, params, key, n_obs, dt=1.0)
    pf_ll = cssm.make_pf_loglik(model, sim.to_timeseries(), n_particles)

    def chains(k):
        return cssm.pmmh_chains(k, params, pf_ll, perturb(0.05), n_iters,
                                n_chains).lls

    rate = n_chains * n_iters / best_time(chains, key)
    print(f"PMMH chains: {rate:.2f} aggregate chain-iters/s at "
          f"{n_chains} chains x N={n_particles}, T={n_obs}", file=sys.stderr)
    return rate


def bench_lgcp(n_particles: int = 1 << 17) -> float:
    """Flat fine-grid LGCP filter throughput (inference/lgcp.py; reference
    ParticleFilter.scala:169-227): particle-slot-steps/sec over the union
    grid at precision=1."""
    import numpy as np

    from composablestatespacemodels_tpu.inference.lgcp import (
        _build_fine_grid)
    from composablestatespacemodels_tpu.models import (brownian_params,
                                                       parameters)
    from composablestatespacemodels_tpu.utils.data import simulate_lgcp

    model = cssm.lgcp(cssm.brownian_motion(1))
    params = parameters(None, brownian_params(1.0, 0.05, 0.1))
    events, _grid = simulate_lgcp(model, params, jax.random.PRNGKey(2),
                                  0.0, 20.0)
    data = events.to_timeseries()
    n_slots = _build_fine_grid(
        np.asarray(data.ts, np.float64), 1)[0].shape[0]

    def ll(k):
        return cssm.lgcp_filter(model, params, data, n_particles, k,
                                precision=1).ll

    rate = n_particles * n_slots / best_time(ll, jax.random.PRNGKey(0))
    print(f"LGCP flat-grid filter: {rate:.4e} particle-slot-steps/s "
          f"(N={n_particles}, K={n_slots} slots)", file=sys.stderr)
    return rate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="tiny shapes")
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--no-secondary", action="store_true",
                    help="headline metric only (skip the PMMH, LGCP and "
                         "mesh benches)")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run tiny shapes on the CPU; the numbers are not "
                         "device metrics")
    args = ap.parse_args()

    device = require_gpu(args.cpu_rehearsal)
    card = ("not a GPU (cpu rehearsal)" if args.cpu_rehearsal
            else card_name_and_power_limit())
    print(f"compile cache: {configure_compile_cache()}", file=sys.stderr)
    print(f"device: {device}; card: {card}", file=sys.stderr)

    tiny = args.smoke or args.cpu_rehearsal
    n, t = (10_000, 100) if tiny else (1 << 20, 1000)
    n = args.particles or n
    t = args.steps or t

    throughput = run(n, t)
    result = {
        "metric": f"particle-steps/sec at N={n} "
                  "(composed seasonal-Poisson PF)",
        "value": throughput,
        "unit": "particle-steps/s",
        "vs_baseline": throughput / BASELINE_PARTICLE_STEPS_PER_SEC,
        "device": device,
        "card": card,
    }
    if not args.no_secondary:
        small = dict(n_obs=40, n_iters=5) if tiny else {}
        result["pmmh_iters_per_sec"] = bench_pmmh(**small)
        result["pmmh_chains_aggregate_iters_per_sec"] = bench_pmmh_chains(
            **(dict(small, n_chains=8) if tiny else {}))
        result["lgcp_particle_slot_steps_per_sec"] = bench_lgcp(
            1 << 10 if tiny else 1 << 17)
        result["sharded_particle_steps_per_sec"] = bench_sharded(
            n, n_steps=20 if tiny else 200)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
