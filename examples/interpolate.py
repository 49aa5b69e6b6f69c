"""Missing-data interpolation (reference examples/Interpolate.scala:10-53):
knock out observations in a window, reconstruct them with the path-storing
particle filter, write smoothed credible intervals.

  python examples/interpolate.py --knock-lo 420 --knock-hi 450
"""

import argparse
import sys

import jax

sys.path.insert(0, ".")
import composablestatespacemodels_tpu as cssm
from composablestatespacemodels_tpu.utils.compile_cache import (
    configure_compile_cache)
from examples.common import add_common_args, config_from_args, test_model


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--knock-lo", type=float, default=420.0)
    ap.add_argument("--knock-hi", type=float, default=450.0)
    add_common_args(ap)
    args = ap.parse_args()
    configure_compile_cache()
    cfg = config_from_args(args)
    key = jax.random.PRNGKey(cfg.seed)

    model, params = test_model()
    sim = cssm.simulate_regular(model, params, key, cfg.n_obs, cfg.dt)
    data = sim.to_timeseries().knock_out(args.knock_lo, args.knock_hi)

    res = cssm.interpolation_filter(model, params, data, cfg.n_particles,
                                    key, resample=cfg.resample)
    path = f"{cfg.out}_interpolated.csv"
    with open(path, "w") as f:
        for i in range(len(data)):
            row = [res.ts[i], res.eta_mean[i], res.eta_lower[i],
                   res.eta_upper[i], float(data.mask[i])]
            f.write(",".join(str(float(v)) for v in row) + "\n")
    print(f"ll = {float(res.ll):.3f}; wrote {path}")


if __name__ == "__main__":
    main()
