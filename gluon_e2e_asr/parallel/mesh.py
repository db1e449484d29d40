"""Device mesh + sharding seams for data parallelism over local devices.

Reference-side realization: MXNet kvstore (C++; NCCL/MPI when
distributed) [SURVEY.md §2.1 #15, §2.3, INFERRED-med]. Here, as
prescribed by [BASELINE.json:L5,L10]: XLA collectives (NCCL on GPUs)
— the batch axis is sharded over a 1-D ``data`` mesh axis, params
are replicated, and XLA inserts the gradient allreduce (psum) when the
jitted train step averages the loss over the sharded batch.

The mesh is declared 2-D ``(data, model)`` with the model axis fixed at
size 1: DP is the reference's only distribution axis [SURVEY.md §2.3],
but the seam lets TP-style axes be added without re-plumbing
[SURVEY.md §5 "where a sequence axis would go"].
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices, with a
    trailing unit ``model`` axis as the TP/SP seam."""
    if devices is None:
        devices = jax.devices()
    arr = np.asarray(devices).reshape(len(devices), 1)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis over ``data``; replicate the rest."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch_arrays(mesh: Mesh, arrays: Dict[str, Any]) -> Dict[str, Any]:
    """Device_put host batch arrays with the batch axis sharded over the
    ``data`` mesh axis."""
    sh = batch_sharding(mesh)
    return {k: jax.device_put(v, sh) for k, v in arrays.items()}
