import numpy as np
import jax
import jax.numpy as jnp

from colmap_tpu.features import matching, pairing
from colmap_tpu.features.matching import DescriptorBlock, MatchingOptions


def make_descriptors(rng, n):
    return rng.integers(0, 256, size=(n, 128)).astype(np.uint8)


def test_similarity_exactness(rng):
    """int8 GEMM + rank-1 correction must reproduce exact uint8 dots."""
    d1 = make_descriptors(rng, 40)
    d2 = make_descriptors(rng, 50)
    b1 = matching.prepare_descriptors(jnp.array(d1))
    b2 = matching.prepare_descriptors(jnp.array(d2))
    sims = np.asarray(matching._cosine_similarities(b1, b2))
    dots = d1.astype(np.int64) @ d2.astype(np.int64).T
    n1 = np.linalg.norm(d1.astype(np.float64), axis=1)
    n2 = np.linalg.norm(d2.astype(np.float64), axis=1)
    want = dots / (n1[:, None] * n2[None, :])
    np.testing.assert_allclose(sims, want, atol=1e-5)


def test_match_identity(rng):
    d = make_descriptors(rng, 100)
    b = matching.prepare_descriptors(jnp.array(d))
    m = matching.match_descriptors(b, b, MatchingOptions(max_ratio=1.01, max_distance=3.2))
    np.testing.assert_array_equal(np.asarray(m), np.arange(100))


def test_match_permutation_and_padding(rng):
    d1 = make_descriptors(rng, 64)
    perm = rng.permutation(64)
    d2 = np.concatenate([d1[perm], np.zeros((16, 128), np.uint8)])
    b1 = matching.prepare_descriptors(jnp.array(d1))
    v2 = jnp.concatenate([jnp.ones(64, bool), jnp.zeros(16, bool)])
    b2 = matching.prepare_descriptors(jnp.array(d2), valid=v2)
    m = np.asarray(matching.match_descriptors(b1, b2, MatchingOptions(max_ratio=1.01, max_distance=3.2)))
    np.testing.assert_array_equal(m, np.argsort(perm))


def test_ratio_test_rejects_ambiguous(rng):
    # d2 contains two equally-noisy copies of each d1 row -> comparable
    # best/second distances -> the 0.8 ratio test rejects
    d1 = make_descriptors(rng, 10)
    n1 = rng.integers(-4, 5, d1.shape)
    n2 = rng.integers(-4, 5, d1.shape)
    d2 = np.concatenate(
        [
            np.clip(d1.astype(int) + n1, 0, 255).astype(np.uint8),
            np.clip(d1.astype(int) + n2, 0, 255).astype(np.uint8),
        ]
    )
    b1 = matching.prepare_descriptors(jnp.array(d1))
    b2 = matching.prepare_descriptors(jnp.array(d2))
    m = np.asarray(matching.match_descriptors(b1, b2, MatchingOptions(max_ratio=0.8)))
    assert (m == -1).all()


def test_cross_check_rejects_many_to_one(rng):
    # two d1 rows close to the same d2 row: cross-check keeps at most one
    d2 = make_descriptors(rng, 20)
    d1 = d2[:2].copy()
    d1[1] = np.clip(d1[0].astype(int) + rng.integers(-2, 3, 128), 0, 255).astype(np.uint8)
    b1 = matching.prepare_descriptors(jnp.array(d1))
    b2 = matching.prepare_descriptors(jnp.array(d2))
    m = np.asarray(matching.match_descriptors(b1, b2, MatchingOptions(max_ratio=1.01, cross_check=True)))
    assert (m == 0).sum() <= 1


def test_match_pairs_batch(rng):
    B, N = 4, 32
    d = np.stack([make_descriptors(rng, N) for _ in range(B)])
    b1 = matching.prepare_descriptors(jnp.array(d.reshape(B * N, 128)))
    blk = DescriptorBlock(
        centered=b1.centered.reshape(B, N, 128),
        row_sum=b1.row_sum.reshape(B, N),
        inv_norm=b1.inv_norm.reshape(B, N),
        valid=b1.valid.reshape(B, N),
    )
    m = matching.match_pairs_batch(blk, blk, MatchingOptions(max_ratio=1.01, max_distance=3.2))
    assert m.shape == (B, N)
    np.testing.assert_array_equal(np.asarray(m), np.tile(np.arange(N), (B, 1)))


def test_matches_to_pairs():
    m = np.array([3, -1, 0, -1, 7], dtype=np.int32)
    pairs = matching.matches_to_pairs(m)
    np.testing.assert_array_equal(pairs, [[0, 3], [2, 0], [4, 7]])


def test_exhaustive_pairs_cover_all():
    ids = list(range(1, 12))
    blocks = list(pairing.exhaustive_pairs(ids, pairing.ExhaustivePairingOptions(block_size=4)))
    pairs = set(p for b in blocks for p in b)
    want = set()
    for i in range(len(ids)):
        for j in range(i + 1, len(ids)):
            want.add((ids[i], ids[j]))
    got = set(tuple(sorted(p)) for p in pairs)
    assert got == want
    assert len(pairs) == len(want)  # no duplicates


def test_sequential_pairs():
    ids = list(range(1, 21))
    pairs = pairing.sequential_pairs(ids, pairing.SequentialPairingOptions(overlap=3))
    assert (1, 2) in pairs and (1, 4) in pairs
    assert all(a < b for a, b in pairs)


def test_spatial_pairs():
    ids = [1, 2, 3, 4]
    pos = np.array([[0, 0, 0], [1, 0, 0], [50, 0, 0], [1000, 0, 0]], np.float64)
    pairs = pairing.spatial_pairs(ids, pos, pairing.SpatialPairingOptions(max_num_neighbors=2, max_distance=100))
    assert (1, 2) in pairs
    assert all(4 not in p for p in pairs)  # too far


def test_transitive_pairs():
    existing = [(1, 2), (2, 3)]
    new = pairing.transitive_pairs(existing)
    assert (1, 3) in new


def test_guided_matching(rng):
    # identity geometry: F ~ [t]x for pure x-translation; points match along
    # epipolar lines y1 == y2
    d1 = make_descriptors(rng, 30)
    b1 = matching.prepare_descriptors(jnp.array(d1))
    xy1 = jnp.array(rng.uniform(0, 100, (30, 2)).astype(np.float32))
    xy2 = xy1 + jnp.array([5.0, 0.0], jnp.float32)  # same rows shifted in x
    F = jnp.array([[0, 0, 0], [0, 0, -1], [0, 1, 0]], jnp.float32)  # [e_x]_x
    m = matching.guided_match_descriptors(
        b1, b1, xy1, xy2, F, max_epipolar_error=2.0,
        options=MatchingOptions(max_ratio=1.01, max_distance=3.2),
    )
    np.testing.assert_array_equal(np.asarray(m), np.arange(30))


def test_sharded_matching_controller_matches_single(rng):
    """The matching CONTROLLER with num_devices=8 (pair blocks sharded
    over the mesh) writes the exact same matches + two-view geometries as
    the single-device run — the product path of SURVEY.md §2.11's sharded
    matching. Block size is a mesh multiple so the RNG key split is
    identical in both runs."""
    from colmap_tpu.controllers import feature_matching as fm
    from colmap_tpu.scene.database import Database
    from colmap_tpu.scene.synthetic import (SyntheticDatasetOptions,
                                            synthesize_dataset)

    def run(num_devices):
        db = Database(":memory:")
        synthesize_dataset(SyntheticDatasetOptions(
            num_images=9, num_points3D=120, point2D_stddev=0.2, seed=4), db)
        ids = sorted(db.read_images().keys())
        pairs = [(ids[i], ids[j]) for i in range(len(ids))
                 for j in range(i + 1, len(ids))][:16]  # 16 = 2 x 8
        opts = fm.FeatureMatchingOptions(num_devices=num_devices,
                                         feature_capacity=256,
                                         block_pairs=16)
        # clear preexisting synthetic matches so the controller's writes
        # are what we compare
        db.conn.execute("DELETE FROM matches")
        db.conn.execute("DELETE FROM two_view_geometries")
        stats = fm.match_pairs(db, pairs, opts, seed=7)
        tvgs = {k: db.read_two_view_geometry(*k)
                for k in db.read_all_two_view_geometries()}
        return stats, tvgs

    s1, t1 = run(1)
    s8, t8 = run(8)
    assert s1.num_matched_pairs == s8.num_matched_pairs
    assert s1.num_verified_pairs == s8.num_verified_pairs
    assert s1.num_inlier_matches == s8.num_inlier_matches
    assert set(t1) == set(t8)
    for k in t1:
        np.testing.assert_array_equal(t1[k]["matches"], t8[k]["matches"])


def test_pool_eviction_matches_unpooled(rng):
    """A descriptor pool smaller than the image set (FIFO eviction +
    re-upload) produces byte-identical matches to a pool that holds
    everything — evicted images transparently re-enter the pool."""
    from colmap_tpu.controllers import feature_matching as fm
    from colmap_tpu.scene.database import Database
    from colmap_tpu.scene.synthetic import (SyntheticDatasetOptions,
                                            synthesize_dataset)

    def run(pool_size):
        db = Database(":memory:")
        synthesize_dataset(SyntheticDatasetOptions(
            num_images=9, num_points3D=120, point2D_stddev=0.2, seed=4), db)
        ids = sorted(db.read_images().keys())
        pairs = [(ids[i], ids[j]) for i in range(len(ids))
                 for j in range(i + 1, len(ids))]
        opts = fm.FeatureMatchingOptions(feature_capacity=256,
                                         block_pairs=2,
                                         descriptor_pool_size=pool_size)
        db.conn.execute("DELETE FROM matches")
        db.conn.execute("DELETE FROM two_view_geometries")
        stats = fm.match_pairs(db, pairs, opts, seed=7)
        tvgs = {k: db.read_two_view_geometry(*k)
                for k in db.read_all_two_view_geometries()}
        return stats, tvgs

    s_small, t_small = run(4)   # forces eviction + re-upload
    s_big, t_big = run(64)
    assert s_small.num_matched_pairs == s_big.num_matched_pairs
    assert set(t_small) == set(t_big)
    for k in t_big:
        np.testing.assert_array_equal(t_small[k]["matches"],
                                      t_big[k]["matches"])


def test_guided_matching_pool_with_mixed_block_capacities():
    """Guided matching on the pooled single-device path: a block whose
    pow2 capacity is below the pool's (an earlier block grew the pool)
    must size its keypoint arrays like the pooled descriptors."""
    from colmap_tpu.controllers import feature_matching as fm
    from colmap_tpu.scene.database import Database
    from colmap_tpu.scene.synthetic import (SyntheticDatasetOptions,
                                            synthesize_dataset)

    db = Database(":memory:")
    synthesize_dataset(SyntheticDatasetOptions(
        num_images=4, num_points3D=600, point2D_stddev=0.2, seed=4), db)
    ids = sorted(db.read_images().keys())
    assert min(len(db.read_descriptors(i)) for i in ids[:2]) > 256
    rng = np.random.default_rng(0)
    for a, b in ((ids[0], ids[1]), (ids[2], ids[3])):
        # the synthetic descriptors are random: plant the true
        # correspondences (the synthetic matches) as noisy copies
        m = db.read_matches(a, b)
        da, dsc = db.read_descriptors(a), db.read_descriptors(b).copy()
        noise = rng.integers(-3, 4, (len(m), 128))
        dsc[m[:, 1]] = np.clip(da[m[:, 0]].astype(int) + noise, 0, 255)
        db.write_descriptors(b, dsc)
    for i in ids[2:]:  # the second block fits a 256 capacity
        db.write_keypoints(i, db.read_keypoints(i)[:200])
        db.write_descriptors(i, db.read_descriptors(i)[:200])
    db.conn.execute("DELETE FROM matches")
    db.conn.execute("DELETE FROM two_view_geometries")
    opts = fm.FeatureMatchingOptions(feature_capacity=1024, block_pairs=1,
                                     guided_matching=True)
    stats = fm.match_pairs(db, [(ids[0], ids[1]), (ids[2], ids[3])], opts,
                           seed=7)
    assert stats.num_verified_pairs == 2
