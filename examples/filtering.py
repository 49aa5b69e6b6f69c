"""Particle filtering with per-step credible intervals
(reference examples/Filtering.scala:16-33).

  python examples/simulate.py model --out data
  python examples/filtering.py data_sims.json --n-particles 1000
"""

import argparse
import sys

import jax

sys.path.insert(0, ".")
import composablestatespacemodels_tpu as cssm
from composablestatespacemodels_tpu.utils.compile_cache import (
    configure_compile_cache)
from composablestatespacemodels_tpu.utils import io as cio
from examples.common import add_common_args, config_from_args, test_model


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("data", help="line-delimited JSON observations")
    ap.add_argument("--plot", action="store_true",
                    help="also write a filtered-ribbon PNG (R/Plots.R:58-75)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard the particle cloud over all devices "
                         "(distributed systematic resampling)")
    add_common_args(ap)
    args = ap.parse_args()
    configure_compile_cache()
    cfg = config_from_args(args)

    mesh = None
    if args.mesh:
        from composablestatespacemodels_tpu.parallel import particle_mesh
        mesh = particle_mesh()
        print(f"mesh: {mesh.devices.size} device(s) on the particle axis")

    model, params = test_model()
    data = cio.read_timeseries_json(args.data)
    res = cssm.bootstrap_filter(model, params, data, cfg.n_particles,
                                jax.random.PRNGKey(cfg.seed),
                                resample=cfg.resample, store="summary",
                                mesh=mesh)
    s = res.summary
    path = f"{cfg.out}_filtered.csv"
    with open(path, "w") as f:
        for i in range(len(data)):
            row = [s.ts[i], s.eta_mean[i], s.eta_lower[i], s.eta_upper[i],
                   *s.state_mean[i], res.ess[i]]
            f.write(",".join(str(float(v)) for v in row) + "\n")
    print(f"ll = {float(res.ll):.3f}; wrote {path}")
    if args.plot:
        from composablestatespacemodels_tpu.utils import plots
        plots.plot_filtering(s, data, f"{cfg.out}_filtered.png")
        print(f"wrote {cfg.out}_filtered.png")


if __name__ == "__main__":
    main()
