from . import filter as filter_mod
from . import interpolation, kalman, lgcp, pmmh, resampling
from .filter import (FilterResult, Forecast, ForecastCloud, PfSummary,
                     bootstrap_filter, credible_interval_eta,
                     credible_interval_state, forecast, forecast_cloud,
                     forecast_from_posterior, forecast_times, log_likelihood)
from .interpolation import (InterpolationResult, interpolation_filter,
                            interpolation_memory_bytes)
from .kalman import KalmanResult, kalman_filter
from .lgcp import LgcpResult, lgcp_filter
from .pmmh import (PmmhResult, PmmhState, adaptive_pmmh,
                   effective_chain_size, flat_prior, gelman_rubin,
                   make_pf_loglik, pilot_run, pmmh_chains,
                   symmetric_transition)
from .resampling import (effective_sample_size, exp_normalise,
                         identity_indices, multinomial_indices, resample,
                         residual_indices, stratified_indices,
                         systematic_indices)

__all__ = [
    "resampling", "kalman", "pmmh", "lgcp", "interpolation",
    "PmmhResult", "PmmhState", "make_pf_loglik",
    "pmmh_chains", "pilot_run",
    "adaptive_pmmh",
    "flat_prior", "symmetric_transition", "gelman_rubin",
    "effective_chain_size",
    "lgcp_filter", "LgcpResult",
    "interpolation_filter", "InterpolationResult",
    "interpolation_memory_bytes",
    "bootstrap_filter", "log_likelihood", "FilterResult", "PfSummary",
    "Forecast", "ForecastCloud", "forecast", "forecast_cloud",
    "forecast_times", "forecast_from_posterior",
    "credible_interval_eta", "credible_interval_state",
    "kalman_filter", "KalmanResult",
    "systematic_indices", "stratified_indices", "multinomial_indices",
    "residual_indices", "identity_indices", "resample",
    "effective_sample_size", "exp_normalise",
]
