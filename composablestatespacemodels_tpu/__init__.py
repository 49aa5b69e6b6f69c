"""composablestatespacemodels_tpu: a JAX framework for composable
state-space models.

A ground-up JAX/XLA rebuild of the capabilities of
jonnylaw/ComposableStateSpaceModels (Law & Wilkinson, "Composable models for
online Bayesian analysis of streaming data", Stat Comput 28, 2018):

* observation models (Poisson, zero-inflated Poisson, negative binomial,
  Bernoulli, Beta, Student-t, Gaussian/linear, seasonal, log-Gaussian Cox)
  over continuous-time latent diffusions (Brownian, generalised Brownian,
  Ornstein-Uhlenbeck) composed with a left-biased semigroup operator;
* bootstrap particle filtering, interpolation, forecasting and PMMH
  parameter inference, all expressed as jitted ``lax.scan`` programs;
* particle- and chain-parallelism over device meshes via ``shard_map``
  collectives.
"""

__version__ = "0.1.0"

from . import inference, models, native, utils
from .inference import (adaptive_pmmh, bootstrap_filter, forecast,
                        forecast_cloud, forecast_from_posterior, forecast_times,
                        interpolation_filter, kalman_filter, lgcp_filter,
                        log_likelihood, make_pf_loglik, pilot_run,
                        pmmh_chains)
from .inference.pmmh import pmmh
from .models import (bernoulli, beta, branch, brownian_motion, brownian_params,
                     compose, gen_brownian_motion, gen_brownian_params, leaf,
                     lgcp, linear, negative_binomial, ou_params, ou_process,
                     param_node, parameters, poisson, seasonal, students_t,
                     zero_inflated_poisson)
from .utils import SimulatedData, TimeSeries, simulate, simulate_lgcp, simulate_regular

__all__ = [
    "models", "inference", "utils", "native",
    "poisson", "linear", "seasonal", "students_t", "bernoulli", "beta",
    "negative_binomial", "zero_inflated_poisson", "lgcp", "compose",
    "brownian_motion", "gen_brownian_motion", "ou_process",
    "brownian_params", "gen_brownian_params", "ou_params",
    "param_node", "parameters", "leaf", "branch",
    "bootstrap_filter", "log_likelihood", "kalman_filter", "forecast",
    "forecast_cloud", "forecast_times", "forecast_from_posterior",
    "lgcp_filter",
    "interpolation_filter",
    "pmmh", "pmmh_chains", "adaptive_pmmh", "make_pf_loglik", "pilot_run",
    "TimeSeries", "SimulatedData", "simulate", "simulate_regular",
    "simulate_lgcp",
]
