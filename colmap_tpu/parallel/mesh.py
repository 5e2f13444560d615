"""Device-mesh helpers for multi-device sharding.

The reference's parallelism surface (threads + multi-GPU round-robin,
SURVEY.md §2.11) maps to JAX device meshes: the observation/pair batch axes
shard over the mesh, and the BA/matching reductions turn into psum
collectives. The mesh is one flat axis: the GPUs of a host reach each
other all to all over NVLink, so the algorithm alone decides the layout.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def shard_leading(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Shard the leading array axis across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(x, multiple: int, axis: int = 0, fill=0):
    """Pad a numpy array so its `axis` length divides `multiple`."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, rem)
    return np.pad(x, widths, constant_values=fill)
