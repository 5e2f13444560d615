"""Fused descriptor matcher: a Pallas kernel for the GPU (Triton route).

The matcher's work is a QK^T-shaped product: per pair, (N, 128) x (M, 128)
descriptor dot products followed by row statistics (best and second-best
similarity, best index) and column statistics (best query row per target,
for the cross check). Written as plain XLA the (B, N, M) similarity tile
goes to device memory and comes back for each reduction; here each block
keeps its similarity tile in registers, as flash attention does.

Layout:
  * the grid runs over (pair, N tile); a `fori_loop` inside the block walks
    the M tiles and carries the forward best / second / index per query row;
  * the reverse statistics are written per N tile, as partials of shape
    (B, N / TN, M), and reduced by a second XLA pass — blocks run in no
    order, so nothing is carried from one block to another.

The product runs bf16 x bf16 -> f32 on the tensor cores and is EXACT:
centered descriptors (uint8 - 128) lie in [-128, 127], which bf16 holds
exactly, and every 128-term sum stays below 2^24. The exact uint8 dot
product is recovered with a rank-1 correction from precomputed row sums

    a . b = (a-128).(b-128) + 128*sum(a) + 128*sum(b) - 128^3

whose terms are all integers below 2^24, so f32 keeps them exact too; the
normalization then multiplies in the same order as the plain reference
(`matching.match_descriptors`), so the two agree bit for bit. Invalid rows
carry a -inf correction, which masks them on both sides at no extra cost.

`match_pairs` runs the kernel on the GPU. On any other backend it runs the
plain reference (`matching.match_pairs_batch`), which gives the same
indices: the kernel has no compiled form there, and its Pallas interpreter
is 4-8x slower than XLA's fused reference on a CPU. Tests run the kernel
itself through the interpreter (`match_statistics(..., interpret=True)`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from colmap_tpu.features.matching import (DescriptorBlock, MatchingOptions,
                                          match_pairs_batch,
                                          select_from_statistics)

# tile sizes and launch parameters: the fastest of a sweep on an H100 SXM
# at 16 x 1024^2, 2048^2 and 4096^2 blocks (PERF.md, the matcher decision)
TILE_N = 128
TILE_M = 64
NUM_WARPS = 4
NUM_STAGES = 2


def _matcher_kernel(c1_ref, a1_ref, s1_ref, c2_ref, a2_ref, s2_ref,
                    best_ref, second_ref, idx_ref, rbest_ref, ridx_ref, *,
                    tile_m: int):
    """One (pair, N tile) block.

    c1 (TN, 128) bf16; a1/s1 (TN,) f32 correction and inverse norm;
    c2 (M, 128) bf16; a2/s2 (M,) f32. Writes best/second/idx (TN,) and the
    block's reverse partials rbest/ridx (M,).
    """
    from jax.experimental import pallas as pl

    tile_n = c1_ref.shape[0]
    m = c2_ref.shape[0]
    row0 = pl.program_id(1) * tile_n
    q = c1_ref[...]
    a1 = a1_ref[...][:, None]
    s1 = s1_ref[...][:, None]

    def body(t, carry):
        best, second, idx = carry
        cols = pl.ds(t * tile_m, tile_m)
        dots = pl.dot(q, c2_ref[cols, :], trans_b=True)  # (TN, TM) exact
        sims = (dots + a1 + a2_ref[cols][None, :]) * s1 * s2_ref[cols][None, :]
        # forward: top-2 over this tile's targets, merged into the carry
        t_best = jnp.max(sims, axis=1)
        t_arg = jnp.argmax(sims, axis=1).astype(jnp.int32)
        col_ids = jax.lax.broadcasted_iota(jnp.int32, sims.shape, 1)
        t_second = jnp.max(
            jnp.where(col_ids == t_arg[:, None], -jnp.inf, sims), axis=1)
        new_idx = jnp.where(t_best > best, t_arg + t * tile_m, idx)
        new_second = jnp.maximum(jnp.minimum(best, t_best),
                                 jnp.maximum(second, t_second))
        # reverse: best query row of this N tile for every target column
        rbest_ref[cols] = jnp.max(sims, axis=0)
        ridx_ref[cols] = jnp.argmax(sims, axis=0).astype(jnp.int32) + row0
        return jnp.maximum(best, t_best), new_second, new_idx

    init = (jnp.full((tile_n,), -jnp.inf, jnp.float32),
            jnp.full((tile_n,), -jnp.inf, jnp.float32),
            jnp.full((tile_n,), -1, jnp.int32))
    best, second, idx = jax.lax.fori_loop(0, m // tile_m, body, init)
    best_ref[...] = best
    second_ref[...] = second
    idx_ref[...] = idx


def _tile(size: int, tile: int) -> int:
    """Power-of-two tile no larger than needed (>= 16, the dot minimum)."""
    return max(16, min(tile, 1 << max(size - 1, 1).bit_length()))


def _kernel_operands(b: DescriptorBlock, length: int, offset: float):
    """Pad one side to `length` rows: bf16 descriptors, -inf correction on
    invalid rows, inverse norms."""
    pad = length - b.centered.shape[1]
    corr = jnp.where(b.valid, 128.0 * b.row_sum + offset, -jnp.inf)
    widths = ((0, 0), (0, pad))
    return (jnp.pad(b.centered.astype(jnp.bfloat16), widths + ((0, 0),)),
            jnp.pad(corr, widths, constant_values=-jnp.inf),
            jnp.pad(b.inv_norm, widths, constant_values=1.0))


@functools.partial(jax.jit, static_argnames=(
    "tile_n", "tile_m", "num_warps", "num_stages", "interpret"))
def match_statistics(b1: DescriptorBlock, b2: DescriptorBlock,
                     tile_n: int = TILE_N, tile_m: int = TILE_M,
                     num_warps: int = NUM_WARPS, num_stages: int = NUM_STAGES,
                     interpret: bool = False):
    """Forward top-2 and reverse argmax for a batch of pairs.

    b1/b2 hold batched arrays: centered (B, N, 128), row_sum (B, N), ...
    Returns best, second, idx, each (B, N), and rev_idx (B, M): the first
    query row of greatest similarity for every target column.
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    B, n = b1.centered.shape[:2]
    m = b2.centered.shape[1]
    tile_n, tile_m = _tile(n, tile_n), _tile(m, tile_m)
    n_pad = -(-n // tile_n) * tile_n
    m_pad = -(-m // tile_m) * tile_m
    c1, a1, s1 = _kernel_operands(b1, n_pad, -128.0 ** 3)
    c2, a2, s2 = _kernel_operands(b2, m_pad, 0.0)
    nt = n_pad // tile_n

    row = pl.BlockSpec((None, tile_n), lambda b, i: (b, i))
    partial = pl.BlockSpec((None, None, m_pad), lambda b, i: (b, i, 0))
    best, second, idx, rbest, ridx = pl.pallas_call(
        functools.partial(_matcher_kernel, tile_m=tile_m),
        grid=(B, nt),
        in_specs=[
            pl.BlockSpec((None, tile_n, 128), lambda b, i: (b, i, 0)),
            row, row,
            pl.BlockSpec((None, m_pad, 128), lambda b, i: (b, 0, 0)),
            pl.BlockSpec((None, m_pad), lambda b, i: (b, 0)),
            pl.BlockSpec((None, m_pad), lambda b, i: (b, 0)),
        ],
        out_specs=(row, row, row, partial, partial),
        out_shape=(
            jax.ShapeDtypeStruct((B, n_pad), jnp.float32),
            jax.ShapeDtypeStruct((B, n_pad), jnp.float32),
            jax.ShapeDtypeStruct((B, n_pad), jnp.int32),
            jax.ShapeDtypeStruct((B, nt, m_pad), jnp.float32),
            jax.ShapeDtypeStruct((B, nt, m_pad), jnp.int32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name="descriptor_matcher",
    )(c1, a1, s1, c2, a2, s2)
    # second pass: the first N tile holding each column's best wins, and
    # within a tile the kernel already kept the first row — so ties resolve
    # to the lowest row index, as jnp.argmax does
    tile_of = jnp.argmax(rbest, axis=1)  # (B, M_pad)
    rev_idx = jnp.take_along_axis(ridx, tile_of[:, None, :], axis=1)[:, 0]
    return best[:, :n], second[:, :n], idx[:, :n], rev_idx[:, :m]


@functools.partial(jax.jit, static_argnames=("options",))
def match_pairs(b1: DescriptorBlock, b2: DescriptorBlock,
                options: MatchingOptions = MatchingOptions()) -> jax.Array:
    """The production matcher; same result as matching.match_pairs_batch.

    b1/b2 hold batched arrays: centered (B, N, 128), row_sum (B, N), ...
    Returns (B, N) int32 match indices into b2 (-1 = none). The kernel is
    compiled for the GPU; any other backend runs the plain reference.
    """
    if jax.default_backend() != "gpu":
        return match_pairs_batch(b1, b2, options)
    stats = match_statistics(b1, b2)
    return select_from_statistics(*stats, b1.valid, options)
