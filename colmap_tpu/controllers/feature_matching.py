"""Feature matching + geometric verification pipeline: pairs -> database.

Re-design of the reference matcher/verifier worker pipeline
(reference: src/colmap/controllers/feature_matching_utils.cc:69-440 and the
per-strategy factories in controllers/feature_matching.h:64-120) as batched
device programs:

- Descriptors of a pair block are packed into fixed-capacity device arrays
  and matched with ONE fused matcher kernel launch
  (`features/pallas_matcher.py`, in place of SiftMatchGPU).
- Geometric verification runs as a batched two-view RANSAC over the block
  (`estimate_two_view_geometry` vmapped over pairs), replacing the
  per-pair VerifierWorker threads.
- Results are written to SQLite in one transaction per block, like the
  reference's batched DB writes.

The pair-block axis is the sharding axis for multi-device matching.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from colmap_tpu.estimators import two_view_geometry as tvg
from colmap_tpu.features import matching as matching_mod
from colmap_tpu.features import pairing as pairing_mod
from colmap_tpu.features import pallas_matcher
from colmap_tpu.features.sift import affine_to_keypoints
from colmap_tpu.parallel import sharded_matching
from colmap_tpu.scene.database import Database
from colmap_tpu.sensor import models as camera_models

logger = logging.getLogger("colmap_tpu")


@dataclasses.dataclass
class FeatureMatchingOptions:
    matching: matching_mod.MatchingOptions = dataclasses.field(
        default_factory=matching_mod.MatchingOptions)
    verification: tvg.TwoViewGeometryOptions = dataclasses.field(
        default_factory=tvg.TwoViewGeometryOptions)
    guided_matching: bool = False
    max_num_matches: int = 32768  # reference: sift.h:136
    # fixed per-image descriptor capacity for the batched pair program
    feature_capacity: int = 8192
    block_pairs: int = 32  # pairs per device batch
    # device-resident descriptor pool slots (images kept on device between
    # pair blocks; FIFO re-upload beyond this). 268 MB HBM at cap 2048.
    descriptor_pool_size: int = 1024
    min_num_inliers: int = 15
    # multi-device distribution (the reference's multi-GPU matcher
    # workers, controllers/feature_matching_utils.cc + comma GPU lists in
    # feature/sift.h:44-46): >1 shards each pair block's leading axis over
    # a jax.sharding.Mesh — every device matches + verifies its
    # slice of the block with the same program. 0 = all local devices;
    # 1 = single-device (default).
    num_devices: int = 1


class _ImageData:
    """Host-side per-image cache of descriptors/keypoints/rays."""

    def __init__(self, db: Database, cameras: Dict[int, dict]):
        self.db = db
        self.cameras = cameras
        self.images = db.read_images()
        self._cache: Dict[int, dict] = {}

    def get(self, image_id: int) -> dict:
        if image_id not in self._cache:
            desc = self.db.read_descriptors(image_id)
            kp = self.db.read_keypoints(image_id)
            xy, _, _ = affine_to_keypoints(kp)
            cam = self.cameras[self.images[image_id]["camera_id"]]
            params = camera_models.pad_params(list(cam["params"]))
            rays = np.asarray(camera_models.cam_from_img(
                cam["model_id"], jnp.asarray(params), jnp.asarray(xy)))
            i_fx, i_fy, _, _ = camera_models._FXFY_CXCY[
                camera_models.CameraModelId(cam["model_id"])]
            focal = 0.5 * (cam["params"][i_fx] + cam["params"][i_fy])
            self._cache[image_id] = {
                "desc": desc, "xy": xy.astype(np.float32),
                "rays": rays.astype(np.float32), "focal": float(focal),
            }
        return self._cache[image_id]


def _pad_to(arr: np.ndarray, cap: int) -> Tuple[np.ndarray, np.ndarray]:
    n = min(len(arr), cap)
    out = np.zeros((cap,) + arr.shape[1:], arr.dtype)
    out[:n] = arr[:n]
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return out, valid


# ---------------------------------------------------------------------------
# device-resident descriptor pool
#
# SiftMatchGPU keeps descriptors device-resident and matches pairs without
# re-uploading (thirdparty/SiftGPU/SiftMatchCU.cpp); the host-side analog is
# FeatureMatcherCache (feature/matcher.h:73). Here it is a pooled
# DescriptorBlock with a leading slot axis: each image's prepared
# descriptors upload ONCE (one fused prepare+scatter program), and each
# pair block is ONE program that gathers both sides from the pool and runs
# the batched matcher — host->device traffic per block drops from
# 2 x B x cap x 128 descriptor bytes to two B-length index vectors.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3))
def _pool_add(centered, row_sum, inv_norm, valid, desc_u8, new_valid, slots):
    """Prepare raw uint8 descriptors and scatter them into pool rows."""
    b = matching_mod.prepare_descriptor_batch(desc_u8, new_valid)
    return (centered.at[slots].set(b.centered),
            row_sum.at[slots].set(b.row_sum),
            inv_norm.at[slots].set(b.inv_norm),
            valid.at[slots].set(b.valid))


@functools.partial(jax.jit, static_argnames=("options",))
def _match_from_pool(centered, row_sum, inv_norm, valid, idx1, idx2,
                     options):
    """Gather both pair sides from the pool and match — one program."""
    def side(idx):
        return matching_mod.DescriptorBlock(
            centered=centered[idx], row_sum=row_sum[idx],
            inv_norm=inv_norm[idx], valid=valid[idx])

    return pallas_matcher.match_pairs(side(idx1), side(idx2), options)


class _DevicePool:
    """Slot-addressed device pool of prepared descriptor blocks."""

    def __init__(self, cap: int, pool_size: int = 1024,
                 add_bucket: int = 32):
        self.cap = cap
        self.size = pool_size
        self.add_bucket = add_bucket
        self.slot_of: Dict[int, int] = {}
        self._fifo: List[int] = []  # image ids in slot-assignment order
        self._next = 0
        self.centered = jnp.zeros((pool_size, cap, 128), jnp.int8)
        self.row_sum = jnp.zeros((pool_size, cap), jnp.float32)
        self.inv_norm = jnp.zeros((pool_size, cap), jnp.float32)
        self.valid = jnp.zeros((pool_size, cap), bool)

    def ensure(self, image_ids: Sequence[int], data: "_ImageData"):
        """Upload any images not yet pooled (one fused program per
        add_bucket of new images)."""
        unique = list(dict.fromkeys(image_ids))
        # touch already-pooled block images to the FIFO tail so eviction
        # (while adding the missing ones) can only hit out-of-block images
        present = [i for i in unique if i in self.slot_of]
        if present:
            pset = set(present)
            self._fifo = [i for i in self._fifo if i not in pset] + present
        missing = [i for i in unique if i not in self.slot_of]
        for start in range(0, len(missing), self.add_bucket):
            chunk = missing[start: start + self.add_bucket]
            m = len(chunk)
            mb = self.add_bucket
            desc = np.zeros((mb, self.cap, 128), np.uint8)
            val = np.zeros((mb, self.cap), bool)
            slots = np.zeros(mb, np.int32)
            for k, iid in enumerate(chunk):
                d = data.get(iid)["desc"]
                n = min(len(d), self.cap)
                desc[k, :n] = d[:n]
                val[k, :n] = True
                if self._next >= self.size:  # FIFO eviction
                    old = self._fifo.pop(0)
                    slots[k] = self.slot_of.pop(old)
                else:
                    slots[k] = self._next
                    self._next += 1
                self.slot_of[iid] = int(slots[k])
                self._fifo.append(iid)
            # pad the bucket by repeating the last real entry (duplicate
            # identical writes to the same slot are harmless)
            for k in range(m, mb):
                desc[k] = desc[m - 1]
                val[k] = val[m - 1]
                slots[k] = slots[m - 1]
            self.centered, self.row_sum, self.inv_norm, self.valid = \
                _pool_add(self.centered, self.row_sum, self.inv_norm,
                          self.valid, jnp.asarray(desc), jnp.asarray(val),
                          jnp.asarray(slots))

    def match_block(self, block: Sequence[Tuple[int, int]], B_full: int,
                    options: matching_mod.MatchingOptions) -> np.ndarray:
        idx1 = np.zeros(B_full, np.int32)
        idx2 = np.zeros(B_full, np.int32)
        for i, (a, b) in enumerate(block):
            idx1[i] = self.slot_of[a]
            idx2[i] = self.slot_of[b]
        return np.asarray(_match_from_pool(
            self.centered, self.row_sum, self.inv_norm, self.valid,
            jnp.asarray(idx1), jnp.asarray(idx2), options))

    def block_view(self, image_id: int) -> matching_mod.DescriptorBlock:
        """Single-image DescriptorBlock view (guided matching)."""
        s = self.slot_of[image_id]
        return matching_mod.DescriptorBlock(
            centered=self.centered[s], row_sum=self.row_sum[s],
            inv_norm=self.inv_norm[s], valid=self.valid[s])


@dataclasses.dataclass
class MatchingStats:
    num_matched_pairs: int = 0
    num_verified_pairs: int = 0
    num_inlier_matches: int = 0


def match_and_verify_blocks(
    database: Database,
    pair_blocks: Iterable[Sequence[Tuple[int, int]]],
    options: FeatureMatchingOptions = FeatureMatchingOptions(),
    seed: int = 0,
    controller=None,
) -> MatchingStats:
    """Match + verify all pair blocks and persist matches/two-view geometries.

    `controller` (util.controller.BaseController) injects Stop/Pause
    between blocks."""
    cameras = database.read_cameras()
    data = _ImageData(database, cameras)
    cap = options.feature_capacity
    stats = MatchingStats()
    pool: Optional[_DevicePool] = None
    key = jax.random.PRNGKey(seed)

    match_opts = options.matching
    verify_opts = options.verification

    # multi-device: shard the pair axis of every block over the mesh
    # (parallel/sharded_matching design, wired into the product path)
    from colmap_tpu.sfm.incremental_mapper import resolve_num_devices

    n_dev = resolve_num_devices(options.num_devices)
    pair_sharding = mesh = None
    if n_dev > 1:
        from jax.sharding import NamedSharding, PartitionSpec
        from colmap_tpu.parallel.mesh import DATA_AXIS, make_mesh

        mesh = make_mesh(n_dev)
        pair_sharding = NamedSharding(mesh, PartitionSpec(DATA_AXIS))

    def put(tree):
        if pair_sharding is None:
            return tree
        return jax.tree.map(
            lambda x: jax.device_put(x, pair_sharding), tree)

    # batched verification program (vmap over the pair axis); image sizes
    # enable watermark detection (reference: detect_watermark default on)
    @jax.jit
    def verify_batch(keys, rays1, rays2, pix1, pix2, valid, focal,
                     sizes1, sizes2):
        return jax.vmap(
            lambda k, r1, r2, p1, p2, v, f, s1, s2:
            tvg.estimate_two_view_geometry(
                k, r1, r2, p1, p2, v, f, verify_opts, sizes1=s1, sizes2=s2)
        )(keys, rays1, rays2, pix1, pix2, valid, focal, sizes1, sizes2)

    for block in pair_blocks:
        if controller is not None and controller.check_if_stopped():
            break
        block = list(block)
        if not block:
            continue
        # pad the pair axis to the device batch (one compiled shape for
        # every block) and so it splits evenly across devices; padding rows
        # have no valid features -> empty matches, skipped on host
        B_full = max(len(block), options.block_pairs)
        B_full = -(-B_full // n_dev) * n_dev
        # ---- batched matching over the block ----
        # per-block pow2 capacity: the GEMM cost is quadratic in the
        # capacity, so padding ~800-feature images to the static 8192
        # ceiling wastes ~100x GEMM work; the pow2 ladder keeps the
        # number of compiled programs logarithmic
        t_block = time.perf_counter()
        n_max = max((len(data.get(im)["desc"]) for ab in block for im in ab),
                    default=1)
        cap = min(options.feature_capacity,
                  1 << max(8, int(n_max - 1).bit_length()))
        b1 = b2 = None
        if n_dev == 1:
            # single-device: device-resident descriptor pool (upload each
            # image once; the pair block gathers from the pool on device)
            if pool is None or pool.cap < cap:
                # the pool must at least hold one block's unique images
                # (eviction inside a block would drop slots the block
                # still needs)
                pool = _DevicePool(
                    cap, pool_size=max(options.descriptor_pool_size,
                                       2 * options.block_pairs))
            pool.ensure([im for ab in block for im in ab], data)
            # the pool may hold a larger capacity than this block needs;
            # everything below (guided matching) uses the pool's
            cap = pool.cap
            midx = pool.match_block(block, B_full, match_opts)
        else:
            d1 = np.zeros((B_full, cap, 128), np.uint8)
            d2 = np.zeros_like(d1)
            v1 = np.zeros((B_full, cap), bool)
            v2 = np.zeros_like(v1)
            for i, (a, b) in enumerate(block):
                da = data.get(a)["desc"]
                db_ = data.get(b)["desc"]
                d1[i, :min(len(da), cap)] = da[:cap]
                d2[i, :min(len(db_), cap)] = db_[:cap]
                v1[i, :min(len(da), cap)] = True
                v2[i, :min(len(db_), cap)] = True
            b1 = put(matching_mod.prepare_descriptor_batch(d1, v1))
            b2 = put(matching_mod.prepare_descriptor_batch(d2, v2))
            midx = np.asarray(sharded_matching.match_pairs_sharded(
                mesh, b1, b2, match_opts))
        t_match = time.perf_counter()

        # ---- collect per-pair correspondences (host) ----
        pair_matches = []
        for i, (a, b) in enumerate(block):
            m = matching_mod.matches_to_pairs(midx[i])
            if len(m) > options.max_num_matches:
                m = m[: options.max_num_matches]
            pair_matches.append(m)
            if len(m) > 0:
                database.write_matches(a, b, m)
                stats.num_matched_pairs += 1

        # ---- batched verification ----
        mcap = max(16, max((len(m) for m in pair_matches), default=16))
        mcap = int(2 ** np.ceil(np.log2(mcap)))
        B = B_full
        rays1 = np.zeros((B, mcap, 2), np.float32)
        rays2 = np.zeros_like(rays1)
        pix1 = np.zeros_like(rays1)
        pix2 = np.zeros_like(rays1)
        mvalid = np.zeros((B, mcap), bool)
        focal = np.ones(B, np.float32)
        sizes1 = np.ones((B, 2), np.float32)
        sizes2 = np.ones((B, 2), np.float32)
        images_meta = data.images
        for i, ((a, b), m) in enumerate(zip(block, pair_matches)):
            if len(m) == 0:
                continue
            da, db_ = data.get(a), data.get(b)
            n = min(len(m), mcap)
            rays1[i, :n] = da["rays"][m[:n, 0]]
            rays2[i, :n] = db_["rays"][m[:n, 1]]
            pix1[i, :n] = da["xy"][m[:n, 0]]
            pix2[i, :n] = db_["xy"][m[:n, 1]]
            mvalid[i, :n] = True
            focal[i] = np.sqrt(da["focal"] * db_["focal"])
            cam_a = cameras[images_meta[a]["camera_id"]]
            cam_b = cameras[images_meta[b]["camera_id"]]
            sizes1[i] = (cam_a["width"], cam_a["height"])
            sizes2[i] = (cam_b["width"], cam_b["height"])

        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, B)
        res = verify_batch(*put((keys, jnp.asarray(rays1),
                                 jnp.asarray(rays2), jnp.asarray(pix1),
                                 jnp.asarray(pix2), jnp.asarray(mvalid),
                                 jnp.asarray(focal), jnp.asarray(sizes1),
                                 jnp.asarray(sizes2))))
        res = jax.tree.map(np.asarray, res)
        t_verify = time.perf_counter()
        logger.info(
            "pair block: %d pairs cap %d (match %.2fs, verify %.2fs)",
            len(block), cap, t_match - t_block, t_verify - t_match)

        # optional guided matching: re-match with the epipolar constraint
        # (reference: guided_matcher workers, feature_matching_utils.cc)
        guided = {}
        if options.guided_matching:
            for i, ((a, b), m) in enumerate(zip(block, pair_matches)):
                if len(m) == 0 or int(res.num_inliers[i]) < options.min_num_inliers:
                    continue
                da, db_ = data.get(a), data.get(b)
                xy1 = np.zeros((cap, 2), np.float32)
                xy2 = np.zeros((cap, 2), np.float32)
                xy1[: min(len(da["xy"]), cap)] = da["xy"][:cap]
                xy2[: min(len(db_["xy"]), cap)] = db_["xy"][:cap]
                gb1 = (pool.block_view(a) if b1 is None
                       else jax.tree.map(lambda x: x[i], b1))
                gb2 = (pool.block_view(b) if b2 is None
                       else jax.tree.map(lambda x: x[i], b2))
                gm = matching_mod.guided_match_descriptors(
                    gb1, gb2,
                    jnp.asarray(xy1), jnp.asarray(xy2),
                    jnp.asarray(res.F[i], jnp.float32),
                    max_epipolar_error=verify_opts.max_error_px,
                    options=match_opts)
                gmp = matching_mod.matches_to_pairs(np.asarray(gm))
                if len(gmp) > len(m):
                    guided[i] = gmp[: options.max_num_matches]

        for i, ((a, b), m) in enumerate(zip(block, pair_matches)):
            ni = int(res.num_inliers[i])
            if len(m) == 0 or ni < options.min_num_inliers:
                continue
            if int(res.config[i]) == int(tvg.TwoViewConfig.WATERMARK):
                continue  # reference: watermark pairs are not used
            if i in guided:
                inlier_matches = guided[i]
            else:
                inl = res.inlier_mask[i][: len(m)]
                inlier_matches = m[inl[: len(m)]]
            pose = res.cam2_from_cam1[i]
            database.write_two_view_geometry(
                a, b, inlier_matches,
                config=int(res.config[i]),
                F=res.F[i], E=res.E[i], H=res.H[i],
                qvec=pose[:4], tvec=pose[4:],
            )
            stats.num_verified_pairs += 1
            stats.num_inlier_matches += len(inlier_matches)

        database.commit()
    return stats


# ---------------------------------------------------------------------------
# Strategy entry points (reference: controllers/feature_matching.h:64-120)
# ---------------------------------------------------------------------------


def _chunk(pairs: List[Tuple[int, int]], n: int):
    for i in range(0, len(pairs), n):
        yield pairs[i:i + n]


def match_exhaustive(database: Database,
                     options: FeatureMatchingOptions = FeatureMatchingOptions(),
                     pairing: Optional[pairing_mod.ExhaustivePairingOptions] = None,
                     seed: int = 0) -> MatchingStats:
    ids = sorted(database.read_images().keys())
    blocks = pairing_mod.exhaustive_pairs(
        ids, pairing or pairing_mod.ExhaustivePairingOptions())
    # an image block of 50 holds up to 1225 pairs: the device takes them
    # block_pairs at a time (one program over a whole image block holds
    # B x cap^2 work at once, and its GPU compile stalled for minutes on a
    # 190-pair block)
    pairs = (p for block in blocks for p in block)
    return match_and_verify_blocks(
        database, _chunk(list(pairs), options.block_pairs), options, seed)


def _filter_existing(database: Database, pairs):
    """Skip pairs with an existing two-view geometry (reference:
    FeatureMatcherCache existing-match checks — re-running a matcher over
    a partially matched database only matches the NEW pairs)."""
    done = {tuple(sorted(k)) for k in database.read_all_two_view_geometries()}
    if not done:
        return pairs
    return [p for p in pairs if tuple(sorted(p)) not in done]


def match_sequential(database: Database,
                     options: FeatureMatchingOptions = FeatureMatchingOptions(),
                     pairing: Optional[pairing_mod.SequentialPairingOptions] = None,
                     seed: int = 0) -> MatchingStats:
    images = database.read_images()
    ids = [iid for iid, _ in sorted(images.items(), key=lambda kv: kv[1]["name"])]
    popts = pairing or pairing_mod.SequentialPairingOptions()
    pairs = pairing_mod.sequential_pairs(ids, popts)
    if popts.loop_detection:
        # vocab-tree loop closure (reference: SequentialPairGenerator,
        # feature/pairing.h:89-110) — retrieval pairs join the temporal set
        loop = pairing_mod.sequential_loop_detection_pairs(
            database, ids, popts, seed=seed)
        pairs = sorted(set(pairs) | set(loop))
    pairs = _filter_existing(database, pairs)
    return match_and_verify_blocks(
        database, _chunk(pairs, options.block_pairs), options, seed)


def match_spatial(database: Database,
                  options: FeatureMatchingOptions = FeatureMatchingOptions(),
                  pairing: Optional["pairing_mod.SpatialPairingOptions"] = None,
                  seed: int = 0) -> MatchingStats:
    pairs = pairing_mod.spatial_pairs_from_database(
        database, pairing or pairing_mod.SpatialPairingOptions())
    return match_and_verify_blocks(
        database, _chunk(pairs, options.block_pairs), options, seed)


def match_pairs(database: Database, pairs: List[Tuple[int, int]],
                options: FeatureMatchingOptions = FeatureMatchingOptions(),
                seed: int = 0) -> MatchingStats:
    """Imported pair list (reference: ImportedPairGenerator)."""
    return match_and_verify_blocks(
        database, _chunk(pairs, options.block_pairs), options, seed)


def match_vocab_tree(database: Database,
                     options: FeatureMatchingOptions = FeatureMatchingOptions(),
                     vocab_tree_path: Optional[str] = None,
                     num_neighbors: int = 5,
                     seed: int = 0) -> MatchingStats:
    """Vocab-tree retrieval matching (reference: VocabTreeFeatureMatcher,
    controllers/feature_matching.h). Builds (or loads) the visual index,
    retrieves each image's neighbors, matches those pairs."""
    from colmap_tpu.retrieval import visual_index as vi_mod

    if vocab_tree_path:
        vi = vi_mod.VisualIndex.load(vocab_tree_path)
    else:
        vi = vi_mod.build_vocab_tree_from_database(
            database, vi_mod.VisualIndexOptions(), seed=seed)
    pairs = vi_mod.vocab_tree_pairs(database, vi, num_neighbors)
    return match_and_verify_blocks(
        database, _chunk(pairs, options.block_pairs), options, seed)


def match_transitive(database: Database,
                     options: FeatureMatchingOptions = FeatureMatchingOptions(),
                     num_iterations: int = 3,
                     seed: int = 0) -> MatchingStats:
    """Transitive closure matching (reference: TransitiveFeatureMatcher)."""
    total = MatchingStats()
    for _ in range(num_iterations):
        existing = [k for k in database.read_all_two_view_geometries()]
        new_pairs = pairing_mod.transitive_pairs(existing)
        new_pairs = [p for p in new_pairs
                     if database.read_matches(*p) is None]
        if not new_pairs:
            break
        st = match_and_verify_blocks(
            database, _chunk(new_pairs, options.block_pairs), options, seed)
        total.num_matched_pairs += st.num_matched_pairs
        total.num_verified_pairs += st.num_verified_pairs
        total.num_inlier_matches += st.num_inlier_matches
    return total
