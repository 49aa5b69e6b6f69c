"""Multi-host runtime helpers.

The reference is a single-JVM library with no distributed backend
(SURVEY.md section 2.3); this module is the green-field multi-host tier of
the design.  The layout rule follows the mesh axes' communication
profiles:

* the **particle axis** carries per-step collectives (``pmax``/``psum`` of
  weight scalars and the resampling ``ppermute`` ring,
  :mod:`.sharded_filter`), so it must ride the fast in-host interconnect
  -- keep it *within* a host's devices;
* the **chain axis** synchronises nothing inside the filter scan
  (independent PMMH chains), so it is the axis that can safely span
  hosts.

:func:`hybrid_mesh` encodes exactly that: chains over the process
dimension, particles over each host's own devices.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from .mesh import CHAIN_AXIS, PARTICLE_AXIS

P = PartitionSpec


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           auto: bool = False) -> bool:
    """Initialise the JAX distributed runtime if this is a multi-process job.

    Arguments default to the standard environment variables
    (``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``).  With ``auto=True`` the call is forwarded to
    ``jax.distributed.initialize()`` with whatever arguments were supplied,
    letting JAX's cluster auto-detection (SLURM, ...) fill in the
    rest.  Without ``auto``, a job with no coordinator configured and
    ``num_processes`` in {None, 1} is a no-op returning False.

    Must run before any JAX computation touches the XLA backend (this
    function deliberately performs no JAX calls before
    ``jax.distributed.initialize``).  Returns True if the distributed
    runtime was (already) initialised.
    """
    from jax._src import distributed as _dist

    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None

    # already-initialised check WITHOUT touching the XLA backend:
    # jax.process_count() would initialise the backends, after which
    # jax.distributed.initialize() unconditionally raises.  The
    # global_state attribute is private, so a second line of defence
    # below treats initialize()'s "already initialized" error as success
    try:
        if _dist.global_state.client is not None:
            return True
    except AttributeError:
        pass
    if (not auto and coordinator_address is None
            and (num_processes or 1) <= 1):
        return False
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:
        if "already initialized" in str(e):
            return True
        raise
    return True


def hybrid_mesh(n_chains: Optional[int] = None,
                devices=None) -> Mesh:
    """(chains, particles) mesh that keeps the particle axis within a host.

    The chain axis spans processes; the particle axis spans each
    process's local devices.  Defaults to one chain row per host.
    Single-process jobs degrade to :func:`~.mesh.make_mesh` semantics over
    the local devices.

    Args:
      n_chains: chain-axis length; must be a multiple of the process count
        (each host holds ``n_chains // process_count`` chain rows).  Default:
        the process count (chains == hosts).
      devices: override the global device list (testing).
    """
    devices = jax.devices() if devices is None else list(devices)
    proc_ids = sorted({getattr(d, "process_index", 0) for d in devices})
    n_proc = len(proc_ids)
    if n_chains is None:
        n_chains = n_proc
    if n_chains % n_proc:
        raise ValueError(
            f"n_chains={n_chains} not a multiple of process count {n_proc}")
    per_proc_chains = n_chains // n_proc
    n_local = len(devices) // n_proc
    if per_proc_chains > n_local or n_local % per_proc_chains:
        raise ValueError(
            f"{per_proc_chains} chain rows per host do not divide its "
            f"{n_local} local devices")

    # rows: process-major then intra-host chain rows -> a chain row never
    # crosses a host unless chains < hosts is impossible by construction
    by_proc = {p: [] for p in proc_ids}
    for d in devices:
        by_proc[getattr(d, "process_index", 0)].append(d)
    bad = {p: len(ds) for p, ds in by_proc.items() if len(ds) != n_local}
    if bad:
        raise ValueError(
            f"hybrid_mesh needs every process to own the same number of "
            f"devices ({n_local}); differing processes: {bad}")
    rows = []
    for p in proc_ids:
        local = by_proc[p]
        width = n_local // per_proc_chains
        for c in range(per_proc_chains):
            rows.append(local[c * width:(c + 1) * width])
    arr = np.asarray(rows, dtype=object)
    return Mesh(arr, (CHAIN_AXIS, PARTICLE_AXIS))


def replicate_to_mesh(x, mesh: Mesh):
    """Host-local pytree -> globally replicated arrays on ``mesh``.

    Use for observations/parameters every process loads identically (the
    normal case: each host reads the same CSV/JSON input).  Works in
    single- and multi-process jobs.
    """
    def one(a):
        a = np.asarray(a)
        sharding = NamedSharding(mesh, P())
        return jax.make_array_from_process_local_data(sharding, a)

    return jax.tree_util.tree_map(one, x)


def shard_particles_to_mesh(x, mesh: Mesh, axis: str = PARTICLE_AXIS):
    """Host-local ``[N, ...]`` array -> globally sharded on ``mesh[axis]``.

    Each process passes the full global array (replicated host copies);
    the result is device-sharded along the particle axis.
    """
    a = np.asarray(x)
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(sharding, a)


def process_local_chains(n_chains: int) -> range:
    """Indices of the PMMH chains this process owns under
    :func:`hybrid_mesh` layout (for per-host posterior IO)."""
    n_proc = jax.process_count()
    if n_chains % n_proc:
        raise ValueError(
            f"n_chains={n_chains} not a multiple of process count {n_proc}")
    per = n_chains // n_proc
    pid = jax.process_index()
    return range(pid * per, (pid + 1) * per)
