"""Multi-device sharded descriptor matching.

Reference parallelism surface: block-wise exhaustive matching distributed
over GPU worker threads (src/colmap/feature/pairing.h:41-47,
controllers/feature_matching_utils.cc). Here the pair-block axis is
sharded over the device mesh — every device runs the fused matcher kernel
(features/pallas_matcher.py) on its slice of the pair block, with no
collectives until the host gathers the match indices. For problems whose
descriptors do not fit one device, the all_gather variant below shards the
images instead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from colmap_tpu.features import matching as matching_mod
from colmap_tpu.features import pallas_matcher
from colmap_tpu.parallel.mesh import DATA_AXIS


def _shard_map(fn, mesh, in_specs, out_specs):
    # check_vma=False: the kernel's pallas_call carries no replication rule
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_vma=False)


def match_pairs_sharded(mesh, b1: matching_mod.DescriptorBlock,
                        b2: matching_mod.DescriptorBlock,
                        options: matching_mod.MatchingOptions
                        = matching_mod.MatchingOptions()) -> jax.Array:
    """The fused matcher on each device's slice of the pair axis.

    b1/b2 hold batched arrays whose leading (pair) axis is a multiple of
    the mesh size. Returns (B, N) int32 match indices.
    """
    return _sharded_matcher(mesh, options)(b1, b2)


@functools.lru_cache(maxsize=None)
def _sharded_matcher(mesh, options: matching_mod.MatchingOptions):
    """One jitted program per (mesh, options), so pair blocks after the
    first reuse its trace instead of lowering the kernel again."""
    fn = _shard_map(lambda a, b: pallas_matcher.match_pairs(a, b, options),
                    mesh, in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
                    out_specs=P(DATA_AXIS))
    return jax.jit(fn)


def match_pair_blocks_sharded(
    mesh,
    d1_u8: np.ndarray,  # (B, N, 128) uint8 descriptors, side 1
    d2_u8: np.ndarray,  # (B, N, 128)
    v1: np.ndarray,  # (B, N) bool
    v2: np.ndarray,
    options: matching_mod.MatchingOptions = matching_mod.MatchingOptions(),
) -> np.ndarray:
    """Match B pairs sharded over the mesh; returns (B, N) int32 indices.

    B must be a multiple of the mesh size (pad with empty pairs).
    """
    n_dev = mesh.devices.size
    B = d1_u8.shape[0]
    assert B % n_dev == 0, f"pad pair blocks to a multiple of {n_dev}"

    shard = NamedSharding(mesh, P(DATA_AXIS))
    prep = matching_mod.prepare_descriptor_batch
    b1 = prep(jnp.asarray(d1_u8), jnp.asarray(v1))
    b2 = prep(jnp.asarray(d2_u8), jnp.asarray(v2))
    b1, b2 = jax.device_put((b1, b2), shard)
    return np.asarray(match_pairs_sharded(mesh, b1, b2, options))


def exhaustive_match_all_gather(
    mesh,
    descriptors: np.ndarray,  # (I, N, 128) uint8, one row per image
    valid: np.ndarray,  # (I, N)
    options: matching_mod.MatchingOptions = matching_mod.MatchingOptions(),
) -> np.ndarray:
    """All-pairs matching with image shards: each device holds I/n_dev
    images and matches them against ALL images via jax.lax.all_gather —
    the analog of the reference's block schedule for problems where
    descriptors do not fit one device.

    Returns (I, I, N) int32 match indices (row image -> column image).
    """
    n_dev = mesh.devices.size
    I, N = descriptors.shape[:2]
    assert I % n_dev == 0, f"pad images to a multiple of {n_dev}"

    def shard_fn(d_shard, v_shard):
        d_all = jax.lax.all_gather(d_shard, DATA_AXIS, axis=0, tiled=True)
        v_all = jax.lax.all_gather(v_shard, DATA_AXIS, axis=0, tiled=True)
        n_local = d_shard.shape[0]
        # every (local image, any image) pair as one batch for the kernel
        rows = jnp.repeat(jnp.arange(n_local), I)
        cols = jnp.tile(jnp.arange(I), n_local)
        prep = jax.vmap(matching_mod.prepare_descriptors)
        b1 = prep(d_shard[rows], v_shard[rows])
        b2 = prep(d_all[cols], v_all[cols])
        out = pallas_matcher.match_pairs(b1, b2, options)
        return out.reshape(n_local, I, N)

    fn = _shard_map(shard_fn, mesh, in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
                    out_specs=P(DATA_AXIS))
    out = jax.jit(fn)(jnp.asarray(descriptors), jnp.asarray(valid))
    return np.asarray(out)
