"""Device mesh construction + sharding helpers.

The reference scales via a multiprocessing pool pickling samples over pipes
(vkit/utility/pool.py:101-218, vkit/pipeline/pool.py:27-96).  The device
equivalent is SPMD over a ``jax.sharding.Mesh``: the batch axis is sharded
over ``dp``, activation height over ``sp`` (XLA inserts halo exchanges for
convs), and model channels over ``tp`` (XLA inserts all-reduces, which it
hands to NCCL on GPUs).  Generation itself needs only ``dp``.
"""
import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

DATA_AXIS = 'dp'
SPATIAL_AXIS = 'sp'
MODEL_AXIS = 'tp'

DEFAULT_AXIS_NAMES = (DATA_AXIS, SPATIAL_AXIS, MODEL_AXIS)


def factor_devices(n_devices: int, n_axes: int) -> Tuple[int, ...]:
    """Factor ``n_devices`` into ``n_axes`` mesh dims, biggest first.

    Greedy: repeatedly peel the largest prime factor onto the smallest axis,
    so 8 -> (2, 2, 2), 4 -> (2, 2, 1), 6 -> (3, 2, 1), 1 -> (1, 1, 1).
    """
    assert n_devices >= 1 and n_axes >= 1
    factors = []
    n = n_devices
    d = 2
    while d * d <= n:
        while n % d == 0:
            factors.append(d)
            n //= d
        d += 1
    if n > 1:
        factors.append(n)
    dims = [1] * n_axes
    for f in sorted(factors, reverse=True):
        dims[int(np.argmin(dims))] *= f
    return tuple(sorted(dims, reverse=True))


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = DEFAULT_AXIS_NAMES,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a mesh over the first ``n_devices`` devices.

    With the default 3 axes an 8-device slice becomes a (2, 2, 2)
    dp x sp x tp mesh; a single chip becomes (1, 1, 1) so the same
    sharded program runs unchanged.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    assert n_devices <= len(devices)
    dims = factor_devices(n_devices, len(axis_names))
    mesh_devices = np.asarray(devices[:n_devices]).reshape(dims)
    return Mesh(mesh_devices, axis_names=tuple(axis_names))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join a multi-host JAX runtime (jax.distributed.initialize).

    Falls back to env variables (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID) and no-ops for a single process.
    Returns the number of processes.  Multi-host generation stays
    embarrassingly parallel (SURVEY §2): the batch axis spans processes,
    everything bandwidth-hungry stays within each host — make_multihost_mesh
    lays the axes out accordingly.
    """
    import os

    coordinator_address = coordinator_address or os.environ.get(
        'JAX_COORDINATOR_ADDRESS'
    )
    if num_processes is None:
        num_processes = int(os.environ.get('JAX_NUM_PROCESSES', '1'))
    if process_id is None:
        process_id = int(os.environ.get('JAX_PROCESS_ID', '0'))
    if num_processes <= 1:
        return 1
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return num_processes


def make_multihost_mesh(
    axis_names: Sequence[str] = DEFAULT_AXIS_NAMES,
    dcn_axis: str = DATA_AXIS,
) -> Mesh:
    """Mesh over ALL global devices with ``dcn_axis`` spanning processes.

    Within a process the remaining axes factor over the local devices;
    only the data axis crosses processes, so collectives on sp/tp stay
    inside a host.  Single-process runs reduce to make_mesh.
    """
    n_proc = jax.process_count()
    if n_proc <= 1:
        return make_mesh(axis_names=axis_names)
    axis_names = tuple(axis_names)
    dcn_idx = axis_names.index(dcn_axis)
    local = jax.local_device_count()
    local_dims = list(factor_devices(local, len(axis_names) - 1))
    # Every card of a host reaches every other at the same rate, so the
    # local axes need no topology-aware placement: process-major order,
    # the process axis moved to ``dcn_axis``.
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    arr = np.asarray(devs).reshape((n_proc, *local_dims))
    devices = np.moveaxis(arr, 0, dcn_idx)
    return Mesh(devices, axis_names=axis_names)


def batch_sharding(mesh: Mesh, ndim: int = 4) -> NamedSharding:
    """Sharding for an image batch (N, H, W, C): N over dp, H over sp."""
    spec = [None] * ndim
    spec[0] = DATA_AXIS
    if ndim >= 3 and SPATIAL_AXIS in mesh.axis_names:
        spec[1] = SPATIAL_AXIS
    return NamedSharding(mesh, PartitionSpec(*spec))


def data_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Leading-axis data sharding (labels, params): N over dp only."""
    spec = [None] * ndim
    spec[0] = DATA_AXIS
    return NamedSharding(mesh, PartitionSpec(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_params_for_tp(params, mesh: Mesh, min_channels: int = 256):
    """Annotate a param pytree with tp sharding on large channel dims.

    Conv kernels (kh, kw, cin, cout) and dense kernels (cin, cout) with
    ``cout >= min_channels`` get their output-channel axis sharded over
    ``tp``; everything else is replicated.  XLA's SPMD partitioner inserts
    the matching collectives.
    """
    tp_size = mesh.shape[MODEL_AXIS]

    def spec_for(x) -> NamedSharding:
        if (
            tp_size > 1 and hasattr(x, 'ndim') and x.ndim >= 2
            and x.shape[-1] >= min_channels and x.shape[-1] % tp_size == 0
        ):
            spec = [None] * x.ndim
            spec[-1] = MODEL_AXIS
            return NamedSharding(mesh, PartitionSpec(*spec))
        return NamedSharding(mesh, PartitionSpec())

    return jax.tree_util.tree_map(spec_for, params)
