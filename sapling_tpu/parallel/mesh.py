"""Device-mesh construction for data-parallel query scale-out.

The reference is single-threaded, single-process CPU code with no
parallelism of any kind (SURVEY.md §2); the scale-out axis here is
data parallelism over the query/read stream: the genome, suffix-array rank
arrays, and PWL table are read-only and replicated per device, while query
batches shard over the "dp" mesh axis. Statistics (per-bin error
histograms, hit counts) reduce over collectives (NCCL over NVLink on GPUs).

A second "tp" axis is used by the learned-residual trainer
(sapling_tpu.models.residual) to shard MLP hidden units.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, tp: int = 1,
              axes: tuple[str, str] = ("dp", "tp")) -> Mesh:
    """A 2-D mesh over the first n_devices devices.

    tp is the size of the second axis and divides n_devices; the first
    axis gets n_devices // tp. Default axis names ("dp", "tp") serve the
    data-parallel query engine and the residual-MLP trainer; pass
    axes=("dp", "idx") for the index-sharded engine
    (parallel.sharded_index)."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if n % tp:
        raise ValueError(f"{axes[1]}={tp} must divide n_devices={n}")
    grid = np.asarray(devs[:n]).reshape(n // tp, tp)
    return Mesh(grid, axes)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def dp_sharded(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Shard axis 0 over "dp", replicate the rest."""
    return NamedSharding(mesh, P("dp", *([None] * (ndim - 1))))


def pad_to_multiple(a: np.ndarray, multiple: int, fill) -> tuple[np.ndarray, int]:
    """Pad axis 0 up to a multiple (shards must be equal-sized). Returns
    (padded, original_length)."""
    b = a.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return a, b
    pad = np.full((rem,) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad]), b
