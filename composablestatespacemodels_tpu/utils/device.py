"""The device a measurement runs on, for the entry-point scripts.

A measurement names its device and refuses to run without a GPU: a number
taken on the CPU must never pass for a device number.  The explicit CPU
rehearsal mode exists only to exercise the scripts' control flow.
"""

from __future__ import annotations

import subprocess

import jax


def device_info() -> dict:
    """Platform, kind and count of the devices JAX sees."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(cpu_rehearsal: bool) -> dict:
    """:func:`device_info`, after checking that JAX found a GPU.

    Exits the process with a message when it did not, unless
    ``cpu_rehearsal`` asks for a run on the CPU.
    """
    info = device_info()
    if info["platform"] != "gpu" and not (cpu_rehearsal
                                          and info["platform"] == "cpu"):
        raise SystemExit(
            f"no GPU found (JAX platform {info['platform']!r}); refusing to "
            "run.  --cpu-rehearsal runs tiny shapes on the CPU.")
    return info


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line.

    Runs as a child process that does not touch JAX.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
