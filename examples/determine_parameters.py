"""Pilot run + PMMH posterior + JSON-to-CSV
(reference examples/DetermineParameters.scala:22-101).

  python examples/determine_parameters.py pilot data_sims.json
  python examples/determine_parameters.py posterior data_sims.json \
      --n-iters 10000 --n-particles 100
  python examples/determine_parameters.py tocsv posterior.json posterior.csv
"""

import argparse
import sys

import jax

sys.path.insert(0, ".")
import composablestatespacemodels_tpu as cssm
from composablestatespacemodels_tpu.utils.compile_cache import (
    configure_compile_cache)
from composablestatespacemodels_tpu.models import perturb
from composablestatespacemodels_tpu.utils import io as cio
from composablestatespacemodels_tpu.utils.streaming import pmmh_monitored
from examples.common import add_common_args, config_from_args, test_model


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("what", choices=["pilot", "posterior", "tocsv"])
    ap.add_argument("data")
    ap.add_argument("csv_out", nargs="?")
    ap.add_argument("--chains", type=int, default=2)
    ap.add_argument("--delta", type=float, default=0.05,
                    help="random-walk proposal variance "
                         "(DetermineParameters.scala:72)")
    ap.add_argument("--plot", action="store_true",
                    help="also write trace/histogram + pilot PNGs "
                         "(R/Plots.R:77-107 analogue)")
    ap.add_argument("--adaptive", action="store_true",
                    help="two-phase adaptive PMMH: pilot RW chain -> "
                         "covariance -> MVN-eigen main chain "
                         "(Parameters.scala:111-123 + Utilities.scala:11-18 "
                         "workflow)")
    ap.add_argument("--mesh", action="store_true",
                    help="run chains over a (chains x particles) device "
                         "mesh (parallel.sharded_pmmh tier: each chain's "
                         "filter shards its cloud); combines with "
                         "--adaptive and --chains")
    add_common_args(ap)
    args = ap.parse_args()
    configure_compile_cache()
    cfg = config_from_args(args)
    model, params = test_model()

    if args.what == "tocsv":
        cio.posterior_to_csv(args.data, args.csv_out or "posterior.csv",
                             params)
        print(f"wrote {args.csv_out or 'posterior.csv'}")
        return

    data = cio.read_timeseries_json(args.data)
    key = jax.random.PRNGKey(cfg.seed)

    if args.what == "pilot":
        # ll variance at several particle counts (PilotRun,
        # DetermineParameters.scala:22-45)
        out = cssm.pilot_run(model, params, data, key,
                             particle_counts=(100, 200, 500, 1000, 2000),
                             n_reps=100)
        print("n_particles, mean_ll, var_ll")
        for n, m, v in out:
            print(f"{n}, {m:.3f}, {v:.3f}")
        if args.plot:
            from composablestatespacemodels_tpu.utils import plots
            plots.plot_pilot_run([n for n, _, _ in out],
                                 [v for _, _, v in out],
                                 f"{cfg.out}_pilot.png")
            print(f"wrote {cfg.out}_pilot.png")
        return

    # posterior: chains via vmap, monitored single chain via host loop
    pf_ll = cssm.make_pf_loglik(model, data, cfg.n_particles, cfg.resample)
    if args.mesh:
        from composablestatespacemodels_tpu.parallel import (
            make_mesh, sharded_adaptive_pmmh, sharded_pmmh_monitored)

        n_dev = len(jax.devices())
        n_chains = max(1, min(args.chains, n_dev))
        mesh = make_mesh(n_chains, n_dev // n_chains)
        if args.adaptive:
            res = sharded_adaptive_pmmh(
                model, params, data, cfg.n_particles, key, cfg.n_iters,
                mesh, pilot_iters=max(200, cfg.n_iters // 4),
                pilot_delta=args.delta)
        else:
            res = sharded_pmmh_monitored(
                key, model, params, data, cfg.n_particles, cfg.n_iters,
                mesh, proposal=perturb(args.delta), chunk_size=1000,
                checkpoint_path=f"{cfg.out}_mesh_chain.npz")
        for c in range(n_chains):
            chain = jax.tree_util.tree_map(lambda x: x[c], res)
            cio.write_posterior_json(f"{cfg.out}_posterior_{c}.json", chain)
        print(f"acceptance rates: {res.acceptance_rate()}")
    elif args.chains > 1:
        res = cssm.pmmh_chains(key, params, pf_ll, perturb(args.delta),
                               cfg.n_iters, args.chains)
        for c in range(args.chains):
            chain = jax.tree_util.tree_map(lambda x: x[c], res)
            cio.write_posterior_json(f"{cfg.out}_posterior_{c}.json", chain)
        print(f"acceptance rates: {res.acceptance_rate()}")
        from composablestatespacemodels_tpu.inference.pmmh import gelman_rubin
        print(f"R-hat(ll): {float(gelman_rubin(res.lls)):.3f}")
    elif args.adaptive:
        res = cssm.adaptive_pmmh(key, params, pf_ll, cfg.n_iters,
                                 pilot_iters=max(200, cfg.n_iters // 4),
                                 pilot_delta=args.delta)
        cio.write_posterior_json(f"{cfg.out}_posterior.json", res)
        print(f"acceptance (adapted chain): "
              f"{float(res.acceptance_rate()):.3f}")
    else:
        res = pmmh_monitored(key, params, pf_ll, perturb(args.delta),
                             cfg.n_iters, chunk_size=1000,
                             checkpoint_path=f"{cfg.out}_chain.npz")
        cio.write_posterior_json(f"{cfg.out}_posterior.json", res)
        print(f"acceptance: {float(res.acceptance_rate()):.3f}")
    if args.plot:
        from composablestatespacemodels_tpu.utils import plots
        plots.plot_posterior(res, path=f"{cfg.out}_posterior.png")
        plots.plot_diagnostics(res, path=f"{cfg.out}_diagnostics.png")
        print(f"wrote {cfg.out}_posterior.png + _diagnostics.png")


if __name__ == "__main__":
    main()
