"""Parallel layer: device mesh + batched device synthesis + prefetch.

Device replacement for the reference's multiprocessing scaling story
(vkit/utility/pool.py, vkit/pipeline/pool.py): SPMD over a jax mesh instead
of processes, a single jitted batch program instead of per-image cv2 calls,
and an async device_put pump instead of pickled pipes.
"""
from .batch import (
    SynthesisParams,
    sample_synthesis_params,
    shard_synthesis,
    synthesize_batch,
    synthesize_with_labels,
    transform_label_points,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SPATIAL_AXIS,
    batch_sharding,
    data_sharding,
    factor_devices,
    initialize_distributed,
    make_mesh,
    make_multihost_mesh,
    replicated,
    shard_params_for_tp,
)
from .prefetch import DevicePrefetcher, prefetch_map

__all__ = [
    'SynthesisParams',
    'sample_synthesis_params',
    'shard_synthesis',
    'synthesize_batch',
    'synthesize_with_labels',
    'transform_label_points',
    'DATA_AXIS',
    'MODEL_AXIS',
    'SPATIAL_AXIS',
    'batch_sharding',
    'data_sharding',
    'factor_devices',
    'initialize_distributed',
    'make_mesh',
    'make_multihost_mesh',
    'replicated',
    'shard_params_for_tp',
    'DevicePrefetcher',
    'prefetch_map',
]
