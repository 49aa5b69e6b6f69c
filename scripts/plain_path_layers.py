"""Device time of each plain-JAX job of the filter step, from short traces.

Times, at the flagship width (N=2^20 particles, d=7 state dims):

* the systematic counts pipeline (cumsum, ceil/clip, cummax);
* the ancestor scatter + cummax, and the ``[N, d]`` row gather;
* propagate + observation weights of the flagship model;
* multinomial and residual resampling (``searchsorted`` lookups);
* the per-step summary (state/eta credible intervals by sorting);
* whole filter steps (``store='ll'`` and ``store='summary'``, T=50);
* one PMMH iteration at the reference's DeterminePosterior shape
  (N=100, T=400).

Under ``XLA_FLAGS=--xla_gpu_enable_command_buffer=`` the trace names each
fused op instead of one command buffer per program.

Each job is one jitted call, run ``--reps`` times inside one profiler
window; its device time is the trace's summed device op time over the
repetitions.  Needs a GPU (``--cpu-rehearsal`` runs tiny shapes on the
CPU, which proves the control flow and measures nothing).

  python scripts/plain_path_layers.py [--out chiprun_out/layers.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import composablestatespacemodels_tpu as cssm  # noqa: E402
from composablestatespacemodels_tpu.inference import resampling as rs  # noqa: E402,E501
from composablestatespacemodels_tpu.models import (  # noqa: E402
    branch, leaf, ou_params, param_node, perturb)
from composablestatespacemodels_tpu.utils.compile_cache import (  # noqa: E402
    configure_compile_cache)
from composablestatespacemodels_tpu.utils.device import (  # noqa: E402
    card_name_and_power_limit, require_gpu)
from composablestatespacemodels_tpu.utils.profiling import (  # noqa: E402
    device_op_times, trace)


def flagship():
    model = (cssm.poisson(cssm.ou_process(1))
             + cssm.seasonal(24, 3, cssm.ou_process(6)))
    params = branch(
        leaf(param_node(None, ou_params(1.0, 0.2, 0.3, 1.0, 0.3))),
        leaf(param_node(None, ou_params(0.2, 0.2, 0.25, 0.2, 0.2))))
    return model, params


def device_ms(name, fn, args, reps, rehearsal, out, per=1):
    """Time ``fn(*args)``; device and wall times are divided by ``per``
    (e.g. the number of filter steps in one call)."""
    jfn = jax.jit(fn)
    t0 = time.perf_counter()
    jax.block_until_ready(jfn(*args))
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(jfn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(jfn(*args))
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            for _ in range(reps):
                jax.block_until_ready(jfn(*args))
        red = device_op_times(d)
    dev_ms = red["busy_ns"] / reps / per / 1e6
    wall_ms /= per
    top = list(red["ops"].items())[:8]
    out[name] = {"device_ms": None if rehearsal else dev_ms,
                 "wall_ms": None if rehearsal else wall_ms,
                 "compile_s": compile_s,
                 "idle_share": None if rehearsal else red["idle_share"],
                 "top_ops_ns_per_call": {k: v / reps / per for k, v in top}}
    label = "(cpu rehearsal: not a device metric)" if rehearsal else ""
    unit = "step" if per > 1 else "call"
    print(f"{name}: device {dev_ms:.4f} ms/{unit}  wall {wall_ms:.4f} ms/{unit} "
          f"idle {red['idle_share']:.3f}  compile {compile_s:.1f}s {label}",
          flush=True)
    for k, v in top:
        print(f"    {v / reps / per / 1e3:10.2f} us  {k}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/plain_path_layers.json")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cpu-rehearsal", action="store_true")
    args = ap.parse_args()
    dev = require_gpu(args.cpu_rehearsal)
    print("compile cache:", configure_compile_cache())
    card = ("cpu rehearsal" if args.cpu_rehearsal
            else card_name_and_power_limit())
    print(f"device {dev}; card {card}", flush=True)

    n = 1 << 12 if args.cpu_rehearsal else 1 << 20
    model, params = flagship()
    key = jax.random.PRNGKey(0)
    kw, kx, kr = jax.random.split(key, 3)
    # a filter-like weight regime: shifted exp of log-weights with sd 1
    w = jnp.exp(jax.random.normal(kw, (n,)))
    w = w / jnp.max(w)
    x = model.initial_state(params, kx, (n,))
    counts = rs.systematic_counts(kr, w)
    idx = rs._ancestors_from_counts(counts, n)
    out = {"n": n, "d": model.dim, "card": card, "device": dev}

    def propagate_weights(k, x):
        x1 = model.step(params, k, x, 1.0)
        logw = model.log_density(params, model.f(x1, 1.0), 3.0)
        return x1, logw

    jobs = [
        ("systematic_counts", lambda k, w: rs.systematic_counts(k, w),
         (kr, w)),
        ("ancestors_scatter_cummax",
         lambda c: rs._ancestors_from_counts(c, n), (counts,)),
        ("gather_rows", lambda x, i: x[i], (x, idx)),
        ("propagate_weights", propagate_weights, (kr, x)),
        ("multinomial", rs.multinomial_indices, (kr, w)),
        ("residual", rs.residual_indices, (kr, w)),
    ]
    for name, fn, a in jobs:
        device_ms(name, fn, a, args.reps, args.cpu_rehearsal, out)

    from composablestatespacemodels_tpu.inference.filter import (
        credible_interval_eta, credible_interval_state)

    def summary(x):
        etas = model.link(model.f(x, 1.0))
        return credible_interval_state(x, 0.975), credible_interval_eta(
            etas, 0.975)

    device_ms("summary_sorts", summary, (x,), args.reps, args.cpu_rehearsal,
              out)
    t_f = 10 if args.cpu_rehearsal else 50
    data = cssm.simulate_regular(model, params, jax.random.PRNGKey(1), t_f,
                                 dt=1.0).to_timeseries()
    for store in ("ll", "summary"):
        device_ms(f"filter_step_{store}",
                  lambda k, store=store: cssm.bootstrap_filter(
                      model, params, data, n, k, store=store),
                  (key,), 2, args.cpu_rehearsal, out, per=t_f)

    n_obs, n_iters = (40, 4) if args.cpu_rehearsal else (400, 20)
    sim = cssm.simulate_regular(model, params, jax.random.PRNGKey(1), n_obs,
                                dt=1.0)
    pf_ll = cssm.make_pf_loglik(model, sim.to_timeseries(), 100)

    def pmmh_run(k):
        return cssm.pmmh(k, params, pf_ll, perturb(0.05), n_iters).lls

    device_ms("pmmh_iterations", pmmh_run, (key,), 1, args.cpu_rehearsal,
              out)
    rec = out["pmmh_iterations"]
    if rec["device_ms"] is not None:
        rec["device_ms_per_iter"] = rec["device_ms"] / n_iters
        rec["wall_ms_per_iter"] = rec["wall_ms"] / n_iters
        print(f"pmmh: {rec['device_ms_per_iter']:.3f} device ms/iter, "
              f"{rec['wall_ms_per_iter']:.3f} wall ms/iter "
              f"(N=100, T={n_obs}; {card})", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v.get("device_ms", v) if isinstance(v, dict)
                      else v for k, v in out.items()}))


if __name__ == "__main__":
    main()
