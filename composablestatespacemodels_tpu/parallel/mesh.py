"""Device-mesh helpers.

The reference has no distributed backend (SURVEY.md section 2.3); scaling here
is green-field design: a (chains x particles) mesh where

* the **particle axis** shards the N-wide state cloud (the scalable width
  dimension -- the "sequence-parallel"-shaped axis of this domain), with
  collectives for weight normalisation / ESS / log-likelihood and
  resampling;
* the **chain axis** is data-parallelism over independent PMMH chains.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec

P = PartitionSpec

CHAIN_AXIS = "chains"
PARTICLE_AXIS = "particles"


def make_mesh(n_chains: int = 1, n_particle_shards: Optional[int] = None,
              devices=None) -> Mesh:
    """Build a (chains, particles) mesh over the available devices.

    ``n_chains * n_particle_shards`` must equal the device count; by default
    all devices go to the particle axis.
    """
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if n_particle_shards is None:
        n_particle_shards = n // n_chains
    if n_chains * n_particle_shards != n:
        raise ValueError(
            f"mesh {n_chains}x{n_particle_shards} != {n} devices")
    arr = np.asarray(devices).reshape(n_chains, n_particle_shards)
    return Mesh(arr, (CHAIN_AXIS, PARTICLE_AXIS))


def particle_mesh(devices=None) -> Mesh:
    """1-chain mesh: every device shards the particle axis."""
    return make_mesh(1, None, devices)
