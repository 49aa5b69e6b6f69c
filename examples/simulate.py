"""Forward-simulation apps (reference examples/Simulation.scala:31-96).

  python examples/simulate.py ornstein   --n-obs 5000   # SimOrnstein
  python examples/simulate.py model      --n-obs 5000   # SimulateModel
  python examples/simulate.py seasonal   --n-obs 5000   # SimulateSeasonal
  python examples/simulate.py lgcp                      # SimulateLgcp
"""

import argparse
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")
import composablestatespacemodels_tpu as cssm
from composablestatespacemodels_tpu.utils.compile_cache import (
    configure_compile_cache)
from composablestatespacemodels_tpu.models import ou_params, parameters
from composablestatespacemodels_tpu.utils import io as cio
from examples.common import add_common_args, config_from_args, test_model


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("what", choices=["ornstein", "model", "seasonal", "lgcp"])
    ap.add_argument("--plot", action="store_true",
                    help="also write a PNG figure (R/Plots.R analogue)")
    add_common_args(ap)
    args = ap.parse_args()
    configure_compile_cache()
    cfg = config_from_args(args)
    key = jax.random.PRNGKey(cfg.seed)

    if args.what == "ornstein":
        sde = cssm.ou_process(1)
        p = ou_params(0.0, 1.0, 0.3, 1.0, 0.5)
        ts, xs = sde.simulate(p, key, 0.0, cfg.dt, cfg.n_obs)
        with open(f"{cfg.out}_ou.csv", "w") as f:
            for t, x in zip(ts, xs[:, 0]):
                f.write(f"{float(t)},{float(x)}\n")
        print(f"wrote {cfg.out}_ou.csv ({cfg.n_obs + 1} rows)")

    elif args.what == "model":
        model, params = test_model()
        sim = cssm.simulate_regular(model, params, key, cfg.n_obs, cfg.dt)
        cio.write_simulated_csv(f"{cfg.out}_sims.csv", sim)
        cio.write_timeseries_json(f"{cfg.out}_sims.json", sim.to_timeseries())
        print(f"wrote {cfg.out}_sims.csv + .json ({cfg.n_obs} rows)")
        if args.plot:
            from composablestatespacemodels_tpu.utils import plots
            plots.plot_simulation(sim, f"{cfg.out}_sims.png")
            print(f"wrote {cfg.out}_sims.png")

    elif args.what == "seasonal":
        model = cssm.seasonal(24, 3, cssm.ou_process(6))
        params = parameters(jnp.log(1.0), ou_params(0.5, 0.2, 0.25, 0.5, 0.2))
        sim = cssm.simulate_regular(model, params, key, cfg.n_obs, cfg.dt)
        cio.write_simulated_csv(f"{cfg.out}_seasonal.csv", sim)
        print(f"wrote {cfg.out}_seasonal.csv")

    else:  # lgcp
        model = cssm.lgcp(cssm.brownian_motion(1))
        params = parameters(None, cssm.brownian_params(1.0, 0.05, 0.05))
        events, grid = cssm.simulate_lgcp(model, params, key, 0.0, 10.0,
                                          precision=2)
        cio.write_simulated_csv(f"{cfg.out}_lgcp.csv", events)
        print(f"wrote {cfg.out}_lgcp.csv ({len(events)} events)")


if __name__ == "__main__":
    main()
