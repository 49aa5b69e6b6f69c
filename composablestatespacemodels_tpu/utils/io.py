"""CSV / line-delimited-JSON persistence.

Replaces the reference's spray-json codecs (jsonFormats.scala:16-144) and
cats Show CSV instances (CsvFormat.scala:7-87):

* time-series CSV with ``NA``/empty for missing observations
  (DataFromFile, Data.scala:252-260);
* line-delimited JSON for observations (DataFromJson, Data.scala:265-272);
* parameter trees serialised **with explicit structure and type tags**
  (the reference flattens trees and disambiguates SDE families by field
  count, jsonFormats.scala:33-45 -- fragile; here every record round-trips
  exactly);
* PMMH posterior read/write with burn-in/thinning
  (Streaming.pmmhToJson/readPosterior, Streaming.scala:42-58, 113-140) and
  posterior-to-CSV with parameter-name headers (JsonToCSV,
  DetermineParameters.scala:90-101).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

from ..models.params import (BrownianParams, GenBrownianParams, OuParams,
                             ParamNode, param_names)
from ..models.tree import Branch, Empty, EmptyTree, Leaf, Tree
from .data import SimulatedData, TimeSeries

# ---------------------------------------------------------------------------
# time series
# ---------------------------------------------------------------------------


def write_timeseries_csv(path: str, data: TimeSeries) -> None:
    """Rows ``t,y`` with an empty observation field when missing.

    Uses the native C++ writer (:mod:`..native`) when available.
    """
    ts = np.asarray(data.ts)
    ys = np.asarray(data.ys)
    mask = np.asarray(data.mask)
    from .. import native
    if native.write_timeseries_csv(path, ts, ys, mask):
        return
    with open(path, "w") as f:
        for t, y, m in zip(ts, ys, mask):
            f.write(f"{t},{y if m else ''}\n")


def _build_timeseries(ts, ys, mask) -> TimeSeries:
    import jax.numpy as _jnp
    f = _jnp.result_type(float)
    return TimeSeries(_jnp.asarray(ts, dtype=f),
                      _jnp.asarray(np.where(mask, ys, 0.0), dtype=f),
                      _jnp.asarray(mask))


def read_timeseries_csv(path: str) -> TimeSeries:
    """First column time, second observation; ``NA``/empty => missing
    (Data.scala:258).

    Uses the native single-pass C++ parser (:mod:`..native`) when available
    -- the host-side equivalent of the reference's Akka file-streaming
    stages (Data.scala:252-260) -- falling back to pure Python.  The native
    parser is lenient: lines whose time field does not parse are skipped
    (the Python fallback raises).
    """
    from .. import native
    parsed = native.parse_timeseries_csv(path)
    if parsed is not None:
        return _build_timeseries(*parsed)
    ts, ys = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            ts.append(float(parts[0]))
            v = parts[1].strip() if len(parts) > 1 else ""
            ys.append(None if v in ("", "NA") else float(v))
    return TimeSeries.from_arrays(np.asarray(ts), ys)


def write_timeseries_json(path: str, data: TimeSeries) -> None:
    """Line-delimited ``{"t": ..., "observation": ...|null}``."""
    ts = np.asarray(data.ts)
    ys = np.asarray(data.ys)
    mask = np.asarray(data.mask)
    with open(path, "w") as f:
        for t, y, m in zip(ts, ys, mask):
            f.write(json.dumps(
                {"t": float(t), "observation": float(y) if m else None})
                + "\n")


def read_timeseries_json(path: str) -> TimeSeries:
    """Line-delimited JSON reader (native fast path when available)."""
    from .. import native
    parsed = native.parse_timeseries_json(path)
    if parsed is not None:
        return _build_timeseries(*parsed)
    ts, ys = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            ts.append(rec["t"])
            ys.append(rec.get("observation"))
    return TimeSeries.from_arrays(np.asarray(ts), ys)


def write_timestamped_json(path: str, data: TimeSeries, epoch,
                           unit: str = "h") -> None:
    """Line-delimited ``{"timestamp": ISO-8601, "observation": ...|null}``.

    The wall-clock flavour of :func:`write_timeseries_json`: the reference
    round-trips ``TimestampObservation`` records with ISO DateTime stamps
    (jsonFormats.scala:106-118, Data.scala:45); here the continuous time
    axis maps back to stamps through ``(epoch, unit)`` (see
    :func:`..utils.data.timestamps_of`).
    """
    from .data import timestamps_of

    stamps = timestamps_of(data.ts, epoch, unit)
    ys = np.asarray(data.ys)
    mask = np.asarray(data.mask)
    with open(path, "w") as f:
        for s, y, m in zip(stamps, ys, mask):
            f.write(json.dumps({
                "timestamp": np.datetime_as_string(s),
                "observation": float(y) if m else None}) + "\n")


def read_timestamped_json(path: str, unit: str = "h", epoch=None):
    """Read ISO-timestamped observations; returns ``(TimeSeries, epoch)``
    (inverse of :func:`write_timestamped_json`; reference
    timestampObservationFormat, jsonFormats.scala:106-118)."""
    from .data import timeseries_from_timestamps

    stamps, ys = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            stamps.append(rec["timestamp"])
            ys.append(rec.get("observation"))
    return timeseries_from_timestamps(stamps, ys, unit=unit, epoch=epoch)


def write_simulated_csv(path: str, sim: SimulatedData) -> None:
    """Rows ``t,y,eta,gamma,x_0,...,x_{d-1}`` (the reference Show[Data]
    layout, CsvFormat.scala:18-27)."""
    ts, ys = np.asarray(sim.ts), np.asarray(sim.ys)
    etas, gammas = np.asarray(sim.etas), np.asarray(sim.gammas)
    xs = np.asarray(sim.xs)
    with open(path, "w") as f:
        for i in range(len(ts)):
            row = [ts[i], ys[i], etas[i], gammas[i], *xs[i]]
            f.write(",".join(str(float(v)) for v in row) + "\n")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

_SDE_TAGS = {BrownianParams: "brownian", GenBrownianParams: "gen_brownian",
             OuParams: "ou"}
_SDE_TYPES = {v: k for k, v in _SDE_TAGS.items()}


def _sde_to_json(p) -> dict:
    d = {"type": _SDE_TAGS[type(p)]}
    for field in p.__dataclass_fields__:
        d[field] = np.asarray(getattr(p, field)).tolist()
    return d


def _sde_from_json(d: dict):
    cls = _SDE_TYPES[d["type"]]
    kwargs = {k: jnp.asarray(v, dtype=jnp.result_type(float))
              for k, v in d.items() if k != "type"}
    return cls(**kwargs)


def params_to_json(p) -> dict:
    """Parameter tree -> JSON-able dict (structure preserved, unlike the
    reference's flatten-and-rebuild, jsonFormats.scala:60-104)."""
    if isinstance(p, Leaf):
        return {"leaf": params_to_json(p.value)}
    if isinstance(p, Branch):
        return {"left": params_to_json(p.left),
                "right": params_to_json(p.right)}
    if isinstance(p, EmptyTree):
        return {"empty": True}
    if isinstance(p, ParamNode):
        return {"scale": None if p.scale is None else float(p.scale),
                "sde": _sde_to_json(p.sde)}
    raise TypeError(f"cannot serialise {type(p).__name__}")


def params_from_json(d: dict):
    if "leaf" in d:
        return Leaf(params_from_json(d["leaf"]))
    if "left" in d:
        return Branch(params_from_json(d["left"]),
                      params_from_json(d["right"]))
    if d.get("empty"):
        return Empty
    scale = d["scale"]
    return ParamNode(
        None if scale is None else jnp.asarray(scale,
                                               dtype=jnp.result_type(float)),
        _sde_from_json(d["sde"]))


def write_params_json(path: str, p: Tree) -> None:
    with open(path, "w") as f:
        json.dump(params_to_json(p), f)


def read_params_json(path: str) -> Tree:
    with open(path) as f:
        return params_from_json(json.load(f))


# ---------------------------------------------------------------------------
# posteriors
# ---------------------------------------------------------------------------


def write_posterior_json(path: str, result) -> None:
    """Line-delimited PMMH iterations ``{"ll":..,"accepted":..,"params":..}``
    (reference pmmhToJson, Streaming.scala:42-58).  ``result`` is a
    single-chain :class:`~..inference.pmmh.PmmhResult`."""
    lls = np.asarray(result.lls)
    accs = np.asarray(result.accepted)
    # convert device leaves to host numpy ONCE: indexing jax arrays per
    # iteration would issue a device dispatch per leaf per row (~minutes
    # for a 100k-iteration chain)
    params_np = jax.tree_util.tree_map(np.asarray, result.params)
    n = lls.shape[0]
    with open(path, "w") as f:
        for i in range(n):
            p_i = jax.tree_util.tree_map(lambda x: x[i], params_np)
            f.write(json.dumps({
                "ll": float(lls[i]),
                "accepted": int(accs[i]),
                "params": params_to_json(p_i),
            }) + "\n")


def read_posterior_json(path: str, burn_in: int = 0, thin: int = 1):
    """Read back a posterior with burn-in and thinning
    (Streaming.readPosterior, Streaming.scala:113-140).

    Returns ``(stacked_params, lls, accepted)``.
    """
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(json.loads(line))
    recs = recs[burn_in::thin]
    if not recs:
        raise ValueError("no posterior records after burn-in/thinning")
    params = [params_from_json(r["params"]) for r in recs]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *params)
    lls = jnp.asarray([r["ll"] for r in recs])
    accs = jnp.asarray([r["accepted"] for r in recs], dtype=jnp.int32)
    return stacked, lls, accs


def posterior_to_csv(json_path: str, csv_path: str, template: Tree) -> None:
    """Posterior JSON -> CSV with parameter-name header (the reference
    JsonToCSV app, DetermineParameters.scala:90-101).

    Flattening is one vmapped ``ravel_pytree`` (a per-row ravel costs a
    device dispatch per row); rows go through the native C++ matrix writer
    when available.
    """
    from ..models.params import stack_flat

    stacked, lls, _ = read_posterior_json(json_path)
    names = param_names(template)
    flat = stack_flat(stacked)                                 # [n, k]
    mat = np.column_stack([np.asarray(flat),
                           np.asarray(lls)[:, None]]).astype(np.float64)
    header = ",".join(names + ["ll"])

    from .. import native
    if native.write_matrix_csv(csv_path, header, mat):
        return
    with open(csv_path, "w") as f:
        f.write(header + "\n")
        for row in mat:
            f.write(",".join(str(v) for v in row) + "\n")


def write_forecast_csv(path: str, fc) -> None:
    """Forecast summaries -> CSV (reference Show[ForecastOut],
    CsvFormat.scala:66-76): t, obs mean/lo/hi, eta mean/lo/hi, state mean."""
    t = np.atleast_1d(np.asarray(fc.t))
    cols = [t,
            np.atleast_1d(np.asarray(fc.obs_mean)),
            np.atleast_1d(np.asarray(fc.obs_lower)),
            np.atleast_1d(np.asarray(fc.obs_upper)),
            np.atleast_1d(np.asarray(fc.eta_mean)),
            np.atleast_1d(np.asarray(fc.eta_lower)),
            np.atleast_1d(np.asarray(fc.eta_upper))]
    state = np.atleast_2d(np.asarray(fc.state_mean))
    with open(path, "w") as f:
        for i in range(t.shape[0]):
            row = [c[i] for c in cols] + list(state[i])
            f.write(",".join(str(float(v)) for v in row) + "\n")


def write_filter_json(path: str, result, ts=None) -> None:
    """Per-step filter summaries -> line-delimited JSON (reference
    Show/json for PfOut, jsonFormats.scala:120-143)."""
    s = result.summary
    if s is None:
        raise ValueError("write_filter_json needs store='summary' output")
    # host-convert every field ONCE (per-row device indexing costs a
    # dispatch per field per row -- see write_posterior_json)
    ts_, eta, e_lo, e_hi, sm, sl, su, ess, llh = (
        np.asarray(x) for x in (s.ts, s.eta_mean, s.eta_lower, s.eta_upper,
                                s.state_mean, s.state_lower, s.state_upper,
                                result.ess, result.ll_history))
    n = int(ts_.shape[0])
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({
                "time": float(ts_[i]),
                "eta": float(eta[i]),
                "etaIntervals": [float(e_lo[i]), float(e_hi[i])],
                "state": [float(v) for v in sm[i]],
                "stateLower": [float(v) for v in sl[i]],
                "stateUpper": [float(v) for v in su[i]],
                "ess": int(ess[i]),
                "ll": float(llh[i]),
            }) + "\n")


# ---------------------------------------------------------------------------
# filter / chain state records (jsonFormats.scala:120-143)
# ---------------------------------------------------------------------------


def state_space_to_json(time, state) -> dict:
    """``StateSpace(time, state)`` codec (stateSpaceFormat,
    jsonFormats.scala:120; Sde.scala:170)."""
    return {"time": float(time),
            "state": np.asarray(state).tolist()}


def state_space_from_json(d):
    return float(d["time"]), jnp.asarray(d["state"],
                                         jnp.result_type(float))


def pf_state_to_json(t, observation, particles, ll, ess) -> dict:
    """``PfState(t, observation, particles, ll, ess)`` codec
    (pfStateFormat, jsonFormats.scala:143; ParticleFilter.scala:32-37).
    Argument order matches the reference record (and
    :func:`pf_state_from_json`'s return)."""
    return {
        "t": float(t),
        "observation": None if observation is None else float(observation),
        "particles": np.asarray(particles).tolist(),
        "ll": float(ll),
        "ess": int(ess),
    }


def pf_state_from_json(d):
    obs = d.get("observation")
    return (float(d["t"]),
            None if obs is None else float(obs),
            jnp.asarray(d["particles"], jnp.result_type(float)),
            float(d["ll"]), int(d["ess"]))


def metrop_state_to_json(ll, params, state_time, state, accepted) -> dict:
    """``MetropState(ll, params, state: StateSpace, accepted)`` codec
    (metropFormat, jsonFormats.scala:121; PMMH.scala:26)."""
    return {
        "ll": float(ll),
        "params": params_to_json(params),
        "state": state_space_to_json(state_time, state),
        "accepted": int(accepted),
    }


def metrop_state_from_json(d):
    t, s = state_space_from_json(d["state"])
    return (float(d["ll"]), params_from_json(d["params"]), t, s,
            int(d["accepted"]))


def write_metrop_states_json(path: str, result, state_time) -> None:
    """Line-delimited ``MetropState`` records from a joint-posterior chain
    (``pmmh(store_state=True)``): ll, params, sampled latent state at
    ``state_time`` (= the data's last observation time) and the cumulative
    acceptance count -- the reference's ``monitorStateStream`` sink feeding
    ``Data.forecast`` (Streaming.scala:84-94, PMMH.scala:26)."""
    if result.states is None:
        raise ValueError(
            "write_metrop_states_json needs a pmmh(store_state=True) "
            "result (result.states is None)")
    lls = np.asarray(result.lls)
    accs = np.asarray(result.accepted)
    states = np.asarray(result.states)
    params_np = jax.tree_util.tree_map(np.asarray, result.params)
    with open(path, "w") as f:
        for i in range(lls.shape[0]):
            p_i = jax.tree_util.tree_map(lambda x: x[i], params_np)
            f.write(json.dumps(metrop_state_to_json(
                lls[i], p_i, state_time, states[i], accs[i])) + "\n")


def read_metrop_states_json(path: str, burn_in: int = 0, thin: int = 1):
    """Read a joint posterior back: returns ``(stacked_params, lls,
    state_time, stacked_states, accepted)`` -- the paired draws for
    :func:`~..inference.filter.forecast_from_posterior`."""
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(metrop_state_from_json(json.loads(line)))
    recs = recs[burn_in::thin]
    if not recs:
        raise ValueError("no metrop records after burn-in/thinning")
    params = [r[1] for r in recs]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *params)
    lls = jnp.asarray([r[0] for r in recs])
    states = jnp.stack([r[3] for r in recs])
    accs = jnp.asarray([r[4] for r in recs], dtype=jnp.int32)
    return stacked, lls, recs[0][2], states, accs


def write_pf_states_json(path: str, states) -> None:
    """Line-delimited PfState records (one per filter step) -- the
    reference streams these through its Show/json sinks."""
    with open(path, "w") as f:
        for rec in states:
            f.write(json.dumps(pf_state_to_json(*rec)) + "\n")


def read_pf_states_json(path: str):
    with open(path) as f:
        return [pf_state_from_json(json.loads(line))
                for line in f if line.strip()]
