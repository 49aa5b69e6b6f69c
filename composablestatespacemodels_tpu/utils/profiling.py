"""Tracing / profiling harness.

The reference ships only a stale ScalaMeter bench harness (SURVEY.md
section 5.1); the equivalents here:

* :func:`trace` -- context manager around ``jax.profiler`` producing a
  TensorBoard/Perfetto-loadable trace of device execution;
* :func:`device_op_times` -- reduce such a trace to per-op device time,
  busy time and the device's idle share over the traced window;
* :func:`time_fn` -- wall-clock timing around ``block_until_ready`` with
  compile/warm-up separation;
* :func:`benchmark_filter` -- the reference bench matrix (single step +
  full-filter throughput vs particle count,
  src/bench/scala/ParticleFilter.scala:17-82) on real arrays.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import time
from typing import Callable, Iterable

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace viewable in TensorBoard / Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# device-plane lines that summarise other lines (counting them would count
# every kernel twice)
_SUMMARY_LINES = ("XLA Modules", "Steps", "Framework", "Source")


def _merged_length(intervals) -> int:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_op_times(log_dir: str, device_prefix: str = "/device:GPU"):
    """Per-op device time and idle share from the newest trace in ``log_dir``.

    Reads the ``.xplane.pb`` that :func:`trace` wrote.  Device events are
    those on the lines of planes named ``device_prefix*`` (summary lines
    excluded); each is keyed by its ``hlo_op`` stat (the XLA op, e.g. a
    fusion) or, failing that, by its event name.  The window runs from the
    first device event's start to the last one's end, and busy time is
    the union of all device event intervals in it.

    Returns a dict: ``ops`` (name -> total ns, sorted descending),
    ``busy_ns``, ``window_ns``, ``idle_share`` and ``n_events``; all zero
    when the trace holds no plane of that device (a CPU run).
    """
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    data = ProfileData.from_file(paths[-1])
    ops = collections.Counter()
    spans = []
    for plane in data.planes:
        if not plane.name.startswith(device_prefix):
            continue
        for line in plane.lines:
            if any(s in line.name for s in _SUMMARY_LINES):
                continue
            for ev in line.events:
                start, dur = int(ev.start_ns), int(ev.duration_ns)
                if dur <= 0:
                    continue
                stats = dict(ev.stats)
                ops[str(stats.get("hlo_op", ev.name))] += dur
                spans.append((start, start + dur))
    if not spans:
        return {"ops": {}, "busy_ns": 0, "window_ns": 0, "idle_share": 0.0,
                "n_events": 0}
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = _merged_length(spans)
    return {"ops": dict(ops.most_common()), "busy_ns": busy,
            "window_ns": window,
            "idle_share": 1.0 - busy / window if window else 0.0,
            "n_events": len(spans)}


def time_fn(fn: Callable, *args, repeats: int = 5, warmup: int = 2,
            make_args: Callable = None, **kwargs):
    """Median wall-clock seconds of ``fn(*args)``, each call ended by
    ``block_until_ready`` on every output leaf.

    Args:
      make_args: optional ``i -> tuple`` producing fresh positional args
        per call (e.g. ``lambda i: (jax.random.fold_in(key, i),)``);
        timed calls get ``i < repeats``, warm-up calls the next indices.

    Returns ``(median_seconds, all_times)``.
    """
    get = make_args if make_args is not None else (lambda i: args)
    for i in range(warmup):
        jax.block_until_ready(fn(*get(repeats + i), **kwargs))
    times = []
    for i in range(repeats):
        a = get(i)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], times


def benchmark_filter(model, params, data, key,
                     particle_counts: Iterable[int] = (1000, 10_000, 100_000),
                     resample: str = "systematic",
                     repeats: int = 3):
    """Full-filter throughput vs N (reference bench matrix).

    Returns a list of ``(n_particles, seconds, particle_steps_per_sec)``.
    """
    from ..inference.filter import log_likelihood

    n_steps = int(data.ts.shape[0])
    out = []
    for i, n in enumerate(particle_counts):
        def run(k, n=int(n)):
            return log_likelihood(model, params, data, n, k,
                                  resample=resample)

        k_n = jax.random.fold_in(key, i)
        med, _ = time_fn(run, repeats=repeats,
                         make_args=lambda j: (jax.random.fold_in(k_n, j),))
        out.append((int(n), med, int(n) * n_steps / med))
    return out
