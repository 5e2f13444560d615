"""Batched k-means on descriptors — the vocab-tree building block.

Reference: the FLANN hierarchical k-means quantizer inside VisualIndex
(src/colmap/retrieval/visual_index.h:46-118). This version is Lloyd's
algorithm where the assignment step is ONE distance GEMM per iteration
(||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2 — the x.c term is a matmul),
vmapped/sharded over nodes for the hierarchical build.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnums=(3, 4))
def kmeans(key: jax.Array, points: jax.Array, valid: jax.Array,
           k: int, num_iters: int = 20) -> Tuple[jax.Array, jax.Array]:
    """Lloyd's k-means. points [N, D] f32, valid [N] bool.

    Returns (centers [k, D], assignment [N] int32). Empty clusters are
    re-seeded at the farthest points.
    """
    n, d = points.shape
    # k-means++-lite init: random distinct points
    perm = jax.random.permutation(key, n)
    centers = points[perm[:k]]

    pn = jnp.sum(points * points, axis=1)  # [N]

    def step(centers, _):
        cn = jnp.sum(centers * centers, axis=1)  # [k]
        # [N, k] distances via one GEMM
        d2 = pn[:, None] - 2.0 * points @ centers.T + cn[None, :]
        d2 = jnp.where(valid[:, None], d2, jnp.inf)
        assign = jnp.argmin(d2, axis=1)
        oh = jax.nn.one_hot(assign, k, dtype=points.dtype) * valid[:, None]
        counts = jnp.sum(oh, axis=0)  # [k]
        sums = oh.T @ points  # [k, D]
        new_centers = sums / jnp.maximum(counts[:, None], 1.0)
        # re-seed empty clusters at the overall farthest valid points
        far = jnp.where(valid, jnp.min(d2, axis=1), -jnp.inf)
        far_idx = jnp.argsort(-far)[:k]
        new_centers = jnp.where(counts[:, None] > 0.5, new_centers,
                                points[far_idx])
        return new_centers, None

    centers, _ = jax.lax.scan(step, centers, None, length=num_iters)
    cn = jnp.sum(centers * centers, axis=1)
    d2 = pn[:, None] - 2.0 * points @ centers.T + cn[None, :]
    assign = jnp.argmin(d2, axis=1).astype(jnp.int32)
    return centers, jnp.where(valid, assign, -1)


def hierarchical_kmeans(rng: np.random.Generator, points: np.ndarray,
                        branching: int, depth: int,
                        min_points_per_node: int = 2) -> np.ndarray:
    """Build a full hierarchical k-means tree; returns the flat center table.

    Layout: a complete `branching`-ary tree of `depth` levels stored as
    centers[level][node, child, D] flattened to one array
    [sum(branching^l), branching, D] — node index at level l is the path
    prefix interpreted in base `branching`. Leaf word id = path index in
    base `branching` over all levels.
    """
    d = points.shape[1]
    levels = []
    # nodes at level l: branching^l
    assignments = np.zeros(len(points), np.int64)  # node index at cur level
    for level in range(depth):
        n_nodes = branching ** level
        table = np.zeros((n_nodes, branching, d), np.float32)
        new_assign = np.zeros_like(assignments)
        for node in range(n_nodes):
            mask = assignments == node
            pts = points[mask]
            if len(pts) < min_points_per_node:
                # degenerate node: replicate whatever is there
                if len(pts) > 0:
                    table[node] = np.tile(pts.mean(0), (branching, 1))
                new_assign[mask] = assignments[mask] * branching
                continue
            import jax.numpy as jnp_

            key = jax.random.PRNGKey(int(rng.integers(0, 2**31)))
            # pad each node's points to a pow2 bucket: per-node exact
            # shapes meant one FRESH compile per node (273 nodes at
            # branching 16 / depth 3) — 30-75 s each through the remote
            # compiler, hours of compile for one vocab build. Bucketing
            # collapses the build to ~10 programs, all persistently
            # cached.
            n_pts = len(pts)
            cap = 1 << max(5, (n_pts - 1).bit_length())
            pts_p = np.zeros((cap, d), np.float32)
            pts_p[:n_pts] = pts
            valid = np.zeros(cap, bool)
            valid[:n_pts] = True
            centers, assign = kmeans(
                key, jnp_.asarray(pts_p), jnp_.asarray(valid),
                min(branching, n_pts), 15)
            centers = np.asarray(centers)
            assign = np.asarray(assign)[:n_pts]
            if len(centers) < branching:
                centers = np.concatenate(
                    [centers, np.tile(centers[-1:], (branching - len(centers), 1))])
            table[node] = centers
            new_assign[mask] = assignments[mask] * branching + np.asarray(assign)
        levels.append(table)
        assignments = new_assign
    return levels


@functools.partial(jax.jit, static_argnums=(2,))
def _quantize_padded(x, levels, branching: int):
    """Jitted full-tree descent over a pow2-padded descriptor block."""
    node = jnp.zeros(x.shape[0], jnp.int32)

    for table in levels:
        centers = table[node]  # [N, branching, D]
        d2 = jnp.sum((x[:, None, :] - centers) ** 2, axis=-1)
        child = jnp.argmin(d2, axis=1).astype(jnp.int32)
        node = node * branching + child
    return node


def quantize(levels, descriptors: np.ndarray) -> np.ndarray:
    """Descend the tree; returns leaf word ids [N].

    One jitted program for the whole descent, with N padded to a pow2
    bucket — per-call exact shapes previously compiled fresh eager
    programs for every distinct descriptor count (one compile storm per
    indexed image through the remote compiler).
    """
    n = len(descriptors)
    if n == 0:
        return np.zeros(0, np.int64)
    cap = 1 << max(7, (n - 1).bit_length())
    x = np.zeros((cap, descriptors.shape[1]), np.float32)
    x[:n] = descriptors
    node = _quantize_padded(jnp.asarray(x),
                            tuple(jnp.asarray(t) for t in levels),
                            int(levels[0].shape[1]))
    return np.asarray(node[:n]).astype(np.int64)
