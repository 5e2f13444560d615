"""Descriptor matching: the plain reference and the shared selection rules.

Reference: SiftCPUFeatureMatcher (src/colmap/feature/sift.cc:1269,
FindBestMatchesBruteForce :1003): distance = arccos of the normalized uint8
descriptor dot product, ratio test 0.8, max distance 0.7, cross check.

SIFT descriptors are uint8, which does not fit int8, so descriptors are
stored centered (d - 128) and the exact uint8 dot product is recovered
with a rank-1 correction from precomputed row sums:

    a . b = (a-128).(b-128) + 128*sum(a) + 128*sum(b) - 128*128*128

Here the centered product runs int8 x int8 -> int32, which is exact. (The
similarity itself must stay f32: bf16 eps ~8e-3 near sim=1.0 collapses the
top-2 distance gap the ratio test depends on.) `match_pairs_batch` is the
plain reference: it materializes each pair's full similarity matrix. The
production matcher is the fused kernel in `features/pallas_matcher.py`,
which keeps the similarity tiles on chip and selects with
`select_from_statistics` below.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class MatchingOptions:
    max_ratio: float = 0.8
    max_distance: float = 0.7
    cross_check: bool = True


class DescriptorBlock(NamedTuple):
    """Device-resident packed descriptors for one image (fixed capacity)."""

    centered: jax.Array  # (N, 128) int8 = uint8 - 128
    row_sum: jax.Array  # (N,) float32 = sum(uint8 row)
    inv_norm: jax.Array  # (N,) float32 = 1 / ||uint8 row||
    valid: jax.Array  # (N,) bool


def prepare_descriptors(desc_u8, valid=None) -> DescriptorBlock:
    """Pack uint8 descriptors (N, 128) for int8 matching."""
    d = jnp.asarray(desc_u8)
    di = d.astype(jnp.int32)
    row_sum = jnp.sum(di, axis=-1).astype(jnp.float32)
    sq = jnp.sum(di * di, axis=-1).astype(jnp.float32)
    inv_norm = 1.0 / jnp.sqrt(jnp.maximum(sq, 1e-12))
    centered = (di - 128).astype(jnp.int8)
    if valid is None:
        valid = jnp.ones(d.shape[0], dtype=bool)
    return DescriptorBlock(centered=centered, row_sum=row_sum, inv_norm=inv_norm, valid=valid)


# The one compiled form of the preparation: the pooled and the sharded
# matcher paths both use it, so their inverse norms agree to the bit (an
# eager 1 / sqrt and a compiled rsqrt differ in the last bits on the GPU).
prepare_descriptor_batch = jax.jit(jax.vmap(prepare_descriptors))


def _cosine_similarities(b1: DescriptorBlock, b2: DescriptorBlock) -> jax.Array:
    """Exact normalized uint8 dot products (N, M) in float32."""
    dots_c = jax.lax.dot_general(
        b1.centered,
        b2.centered,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32)
    # rank-1 correction back to the exact uint8 dot product
    dots = (
        dots_c
        + 128.0 * b1.row_sum[:, None]
        + 128.0 * b2.row_sum[None, :]
        - 128.0 * 128.0 * 128.0
    )
    return dots * b1.inv_norm[:, None] * b2.inv_norm[None, :]


def _select_matches(sims, b1: DescriptorBlock, b2: DescriptorBlock,
                    options: MatchingOptions):
    sims = jnp.where(b1.valid[:, None] & b2.valid[None, :], sims, -jnp.inf)
    # best + second-best via two max passes (lax.top_k(k=2) would sort
    # every row); the masked double-max is three fused reductions
    best_sim = jnp.max(sims, axis=1)
    best_idx = jnp.argmax(sims, axis=1).astype(jnp.int32)
    cols = jax.lax.broadcasted_iota(jnp.int32, sims.shape, 1)
    second_sim = jnp.max(
        jnp.where(cols == best_idx[:, None], -jnp.inf, sims), axis=1)
    best_dist = jnp.arccos(jnp.clip(best_sim, -1.0, 1.0))
    second_dist = jnp.arccos(jnp.clip(second_sim, -1.0, 1.0))

    ok = jnp.isfinite(best_sim)
    ok &= best_dist <= options.max_distance
    # strict <: equal distances (e.g. duplicated descriptors) are ambiguous
    ok &= best_dist < options.max_ratio * second_dist
    if options.cross_check:
        rev_best = jnp.argmax(sims, axis=0)  # (M,)
        ok &= rev_best[best_idx] == jnp.arange(b1.centered.shape[0])
    return jnp.where(ok & b1.valid, best_idx, -1).astype(jnp.int32)


def match_descriptors(b1: DescriptorBlock, b2: DescriptorBlock,
                      options: MatchingOptions = MatchingOptions()) -> jax.Array:
    """One-to-one matches. Returns (N,) int32 indices into b2 (-1 = none).

    Jittable; vmap over a leading pair axis for pair-batched matching.
    """
    sims = _cosine_similarities(b1, b2)
    return _select_matches(sims, b1, b2, options)


@partial(jax.jit, static_argnames=("options",))
def match_pairs_batch(b1: DescriptorBlock, b2: DescriptorBlock,
                      options: MatchingOptions = MatchingOptions()) -> jax.Array:
    """Match a batch of image pairs in one fused program.

    b1/b2 hold batched arrays: centered (B, N, 128), row_sum (B, N), ...
    """
    return jax.vmap(lambda a, b: match_descriptors(a, b, options))(b1, b2)


def select_from_statistics(best, second, idx, rev_idx, valid1,
                           options: MatchingOptions) -> jax.Array:
    """Ratio, distance and cross checks from the per-row statistics.

    best/second/idx: (B, N) best and second-best similarity and best target
    index per query row; rev_idx: (B, M) best query row per target column.
    """
    n = best.shape[1]
    best_dist = jnp.arccos(jnp.clip(best, -1.0, 1.0))
    second_dist = jnp.arccos(jnp.clip(second, -1.0, 1.0))
    ok = best > -1e20
    ok &= best_dist <= options.max_distance
    ok &= best_dist < options.max_ratio * second_dist
    if options.cross_check:
        rev_at_best = jnp.take_along_axis(rev_idx, jnp.maximum(idx, 0), axis=1)
        ok &= rev_at_best == jnp.arange(n)[None, :]
    return jnp.where(ok & valid1, idx, -1).astype(jnp.int32)


def guided_match_descriptors(
    b1: DescriptorBlock, b2: DescriptorBlock,
    xy1, xy2, F: jax.Array, max_epipolar_error: float,
    options: MatchingOptions = MatchingOptions(),
) -> jax.Array:
    """Guided matching: candidates gated by epipolar (Sampson) distance.

    Reference: guided matching with E/F constraint (feature/sift.cc:1508).
    """
    sims = _cosine_similarities(b1, b2)
    one1 = jnp.ones_like(xy1[:, :1])
    h1 = jnp.concatenate([xy1, one1], axis=-1)  # (N, 3)
    one2 = jnp.ones_like(xy2[:, :1])
    h2 = jnp.concatenate([xy2, one2], axis=-1)  # (M, 3)
    Fx1 = h1 @ F.T  # (N, 3)
    Ftx2 = h2 @ F  # (M, 3)
    num = jnp.einsum("ni,mi->nm", Fx1, h2)  # x2^T F x1
    denom = (
        Fx1[:, 0:1] ** 2 + Fx1[:, 1:2] ** 2
        + (Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2)[None, :]
    )
    sampson = num * num / jnp.maximum(denom, 1e-12)
    sims = jnp.where(sampson <= max_epipolar_error**2, sims, -jnp.inf)
    return _select_matches(sims, b1, b2, options)


def matches_to_pairs(match_idx) -> "tuple":
    """Host helper: (N,) match indices -> (K, 2) index pair array (numpy)."""
    import numpy as np

    m = np.asarray(match_idx)
    rows = np.nonzero(m >= 0)[0]
    return np.stack([rows, m[rows]], axis=-1).astype(np.uint32)
