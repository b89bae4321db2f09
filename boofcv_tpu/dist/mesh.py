"""Device-mesh construction helpers.

The framework uses one canonical data-parallel axis name, ``"shard"``, for
fan-out over points (BA), image pairs (matching), and RANSAC hypothesis
banks.  Multi-host initialization goes through jax.distributed upstream of
these helpers.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

SHARD_AXIS = "shard"


def device_count() -> int:
    return jax.device_count()


def make_mesh(n_devices: int | None = None, axis: str = SHARD_AXIS) -> Mesh:
    """1D mesh over the first n devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         local_device_ids=None) -> None:
    """Multi-host (multi-process) runtime initialization.

    Wraps ``jax.distributed.initialize`` (SURVEY §5 "distributed
    communication backend"): every process must call this before any other
    JAX API; afterwards ``jax.devices()`` spans all hosts and meshes built
    by :func:`make_mesh`/:func:`make_mesh_2d` include every process's
    devices — collectives over the mesh stay within a host where they can and
    cross the network between hosts.  Arguments default to the standard env vars
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID) so
    launchers can configure purely through the environment.
    """
    import os

    kwargs = {}
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kwargs["coordinator_address"] = (
            coordinator_address or os.environ["JAX_COORDINATOR_ADDRESS"])
    if num_processes is not None or os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["num_processes"] = int(
            num_processes if num_processes is not None
            else os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None or os.environ.get("JAX_PROCESS_ID"):
        kwargs["process_id"] = int(
            process_id if process_id is not None
            else os.environ["JAX_PROCESS_ID"])
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def make_mesh_2d(n_hosts: int | None = None,
                 devices_per_host: int | None = None,
                 host_axis: str = "host",
                 axis: str = SHARD_AXIS) -> Mesh:
    """2D (host, shard) mesh for multi-host jobs.

    Rows = processes (the network between them), columns = each process's local
    devices.  Layouts that keep the heavy collective on the inner
    ``shard`` axis stay within a host; only the outer ``host`` axis reductions
    cross the network.  On a single process this still works and simply reshapes the
    local devices — used by the CPU-backend multi-host dryrun tests.
    """
    devs = jax.devices()
    if n_hosts is None:
        n_hosts = max(jax.process_count(), 1)
    if devices_per_host is None:
        devices_per_host = len(devs) // n_hosts
    grid = np.array(devs[:n_hosts * devices_per_host]).reshape(
        n_hosts, devices_per_host)
    return Mesh(grid, (host_axis, axis))
