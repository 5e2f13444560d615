"""Hierarchical mapper: cluster the scene, map clusters, merge models.

Reference: src/colmap/controllers/hierarchical_mapper.h:45-80 — normalized-
cut scene clustering -> PARALLEL per-cluster incremental mapping (thread
pool) -> model merging. This design goes further than the reference on
the merge: instead of greedy pairwise Sim3 chaining, all pairwise cluster
alignments become edges of a Sim3 pose graph that is jointly optimized
(estimators/pose_graph.py) so loop-closure error distributes over the
whole graph before the models fuse.

Cluster reconstructions run concurrently on a host thread pool: the
sqlite connection is thread-bound, so per-cluster DatabaseCaches build
serially first, then mapping (pure device calls + numpy) overlaps.
"""

from __future__ import annotations

import dataclasses
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from colmap_tpu.controllers.incremental_pipeline import (
    IncrementalPipeline,
    IncrementalPipelineOptions,
)
from colmap_tpu.estimators import alignment as alignment_mod
from colmap_tpu.estimators import pose_graph as pose_graph_mod
from colmap_tpu.scene import scene_clustering as sc
from colmap_tpu.scene.database import Database
from colmap_tpu.scene.database_cache import DatabaseCache
from colmap_tpu.scene.reconstruction import Reconstruction
from colmap_tpu.util.controller import BaseController

logger = logging.getLogger("colmap_tpu")


@dataclasses.dataclass
class HierarchicalPipelineOptions:
    clustering: sc.SceneClusteringOptions = dataclasses.field(
        default_factory=sc.SceneClusteringOptions)
    incremental: IncrementalPipelineOptions = dataclasses.field(
        default_factory=IncrementalPipelineOptions)
    min_num_inliers: int = 15
    # concurrent cluster reconstructions (reference: thread pool over
    # clusters, hierarchical_mapper.cc)
    num_workers: int = 4
    # pose-graph edge acceptance
    align_max_error: float = 0.1
    pose_graph_iters: int = 20


class HierarchicalPipeline(BaseController):
    def __init__(self, database: Database,
                 options: HierarchicalPipelineOptions = HierarchicalPipelineOptions()):
        super().__init__()
        self.database = database
        self.options = options

    def _reconstruct_clusters(self, leaves, id_to_name, seed: int
                              ) -> List[Reconstruction]:
        # caches build serially (sqlite is thread-bound) ...
        caches: List[Optional[DatabaseCache]] = []
        for leaf in leaves:
            names = {id_to_name[iid] for iid in leaf.image_ids}
            caches.append(DatabaseCache.create(
                self.database,
                min_num_matches=self.options.incremental.min_num_matches,
                image_names=names))

        # ... then clusters map concurrently
        def work(args):
            li, cache = args
            if self.check_if_stopped():
                return None
            pipeline = IncrementalPipeline(self.database,
                                           self.options.incremental)
            return pipeline.run(seed=seed + li, cache=cache)

        workers = max(1, min(self.options.num_workers, len(leaves)))
        if workers == 1:
            results = [work(a) for a in enumerate(caches)]
        else:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                results = list(ex.map(work, enumerate(caches)))
        recs = []
        for li, rec in enumerate(results):
            if rec is not None:
                logger.info("cluster %d: %d images registered", li,
                            rec.num_registered_images())
                recs.append(rec)
        return recs

    def _placement_ok(self, base: Reconstruction, rec: Reconstruction
                      ) -> bool:
        """Do the common registered images of `rec` (already transformed
        into the global frame) agree with `base` on projection centers?
        Median error gate at align_max_error; no common images counts as
        NOT validated (the robust fallback can still align via points)."""
        common = sorted(set(base.registered_image_ids())
                        & set(rec.registered_image_ids()))
        if not common:
            return False
        a = np.stack([base.images[i].projection_center() for i in common])
        b = np.stack([rec.images[i].projection_center() for i in common])
        err = np.linalg.norm(a - b, axis=1)
        return float(np.median(err)) <= self.options.align_max_error

    def _merge_with_pose_graph(self, recs: List[Reconstruction]
                               ) -> Reconstruction:
        """Pairwise Sim3 edges -> joint pose-graph refinement -> fuse."""
        recs = sorted(recs, key=lambda r: -r.num_registered_images())
        n = len(recs)
        if n == 1:
            return recs[0]

        edges: List[Tuple[int, int]] = []
        meas: List[np.ndarray] = []
        weights: List[float] = []
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                common = set(recs[i].registered_image_ids()) \
                    & set(recs[j].registered_image_ids())
                if len(common) < 3 or i > j:
                    continue
                t = alignment_mod.align_reconstructions_robust(
                    recs[i], recs[j], max_error=self.options.align_max_error)
                if t is None:
                    continue
                edges.append((i, j))
                meas.append(np.asarray(t))  # j_from_i
                weights.append(float(np.sqrt(len(common))))
        if not edges:
            logger.warning("no alignable cluster pairs; returning largest")
            return recs[0]

        # initial placements: BFS composition from the largest cluster
        from colmap_tpu.geometry import sim3 as s3
        import jax.numpy as jnp

        placement = [None] * n
        placement[0] = np.array([1, 1, 0, 0, 0, 0, 0, 0], np.float64)
        adj: Dict[int, List[Tuple[int, np.ndarray]]] = {}
        for (i, j), m in zip(edges, meas):
            # global_from_i = global_from_j o (j_from_i)
            adj.setdefault(i, []).append((j, m))
            adj.setdefault(j, []).append(
                (i, np.asarray(s3.inverse(jnp.asarray(m, jnp.float32)))))
        frontier = [0]
        while frontier:
            j = frontier.pop()
            for (i, m_ij) in adj.get(j, []):
                if placement[i] is None:
                    placement[i] = np.asarray(s3.compose(
                        jnp.asarray(placement[j], jnp.float32),
                        jnp.asarray(m_ij, jnp.float32)), np.float64)
                    frontier.append(i)
        connected = [k for k in range(n) if placement[k] is not None]
        if len(connected) < n:
            logger.warning("%d cluster models unreachable from the largest",
                           n - len(connected))

        # joint refinement over the connected subgraph
        remap = {k: idx for idx, k in enumerate(connected)}
        kept = [(e, m, w) for (e, m, w) in zip(edges, meas, weights)
                if e[0] in remap and e[1] in remap]
        init = np.stack([placement[k] for k in connected])
        if kept:
            sub_edges = np.array([(remap[i], remap[j]) for ((i, j), _, _)
                                  in kept], np.int64)
            sub_meas = np.stack([m for (_, m, _) in kept])
            sub_w = np.array([w for (_, _, w) in kept], np.float32)
            refined = pose_graph_mod.optimize_sim3_pose_graph(
                init, sub_edges, sub_meas, sub_w,
                num_iters=self.options.pose_graph_iters)
        else:
            refined = init

        # transform every cluster into the global frame, then fuse
        base = recs[connected[0]]
        base.transform(refined[0])
        identity = np.array([1, 1, 0, 0, 0, 0, 0, 0], np.float64)
        for idx in range(1, len(connected)):
            rec = recs[connected[idx]]
            rec.transform(refined[idx])
            # VALIDATE the pose-graph placement before fusing: the
            # precomputed-identity path skips merge_reconstructions'
            # internal alignment entirely, so one bad placement (e.g. a
            # weak 3-common-image edge) would silently corrupt the fused
            # model. Check common-image projection-center agreement and
            # fall back to robust re-alignment when it fails (reference:
            # RANSAC-gated MergeReconstructions, estimators/alignment.cc).
            if self._placement_ok(base, rec):
                ok = alignment_mod.merge_reconstructions(
                    base, rec, precomputed_sim3=identity)
            else:
                logger.warning(
                    "cluster %d pose-graph placement fails the proj-center "
                    "check; re-aligning robustly", connected[idx])
                ok = alignment_mod.merge_reconstructions(
                    base, rec,
                    max_proj_center_error=self.options.align_max_error)
            if not ok:
                logger.warning("cluster %d failed to fuse", connected[idx])
        # unreachable clusters: greedy fallback against the fused base
        # (the enlarged overlap may now align where pairwise edges could
        # not — e.g. via common 3D points)
        pending = [recs[k] for k in range(n) if k not in remap]
        progress = True
        while pending and progress:
            progress = False
            rest = []
            for rec in pending:
                if alignment_mod.merge_reconstructions(base, rec):
                    progress = True
                else:
                    rest.append(rec)
            pending = rest
        if pending:
            logger.warning("%d cluster models could not be merged",
                           len(pending))
        return base

    def run(self, seed: int = 0) -> Optional[Reconstruction]:
        weights = sc.edge_weights_from_database(
            self.database, self.options.min_num_inliers)
        image_ids = sorted(self.database.read_images().keys())
        tree = sc.cluster_scene(image_ids, weights, self.options.clustering)
        leaves = tree.leaves()
        logger.info("scene clustered into %d leaves", len(leaves))

        id_to_name = {iid: im["name"]
                      for iid, im in self.database.read_images().items()}
        recs = self._reconstruct_clusters(leaves, id_to_name, seed)
        if not recs:
            return None
        return self._merge_with_pose_graph(recs)
