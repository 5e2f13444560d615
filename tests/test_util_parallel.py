"""util layer (timer, caches) + sharded matching on the virtual CPU mesh."""

import numpy as np
import pytest

import jax

from colmap_tpu.features import matching as matching_mod
from colmap_tpu.parallel import sharded_matching as sm
from colmap_tpu.parallel.mesh import make_mesh
from colmap_tpu.util.cache import (
    LRUCache,
    MemoryConstrainedLRUCache,
    ThreadSafeLRUCache,
)
from colmap_tpu.util.timer import StageTimings, Timer


def test_timer_accumulates():
    t = Timer(start=True)
    import time

    time.sleep(0.02)
    t.pause()
    s1 = t.elapsed_seconds()
    assert s1 >= 0.015
    time.sleep(0.02)
    assert abs(t.elapsed_seconds() - s1) < 1e-9  # paused
    t.resume()
    time.sleep(0.01)
    assert t.elapsed_seconds() > s1


def test_lru_cache_eviction():
    calls = []
    c = LRUCache(3, getter=lambda k: calls.append(k) or k * 10)
    for k in (1, 2, 3):
        c.get(k)
    c.get(1)  # refresh 1
    c.get(4)  # evicts 2
    assert c.exists(1) and c.exists(3) and c.exists(4)
    assert not c.exists(2)
    c.get(2)
    assert calls.count(2) == 2  # re-fetched after eviction


def test_memory_constrained_cache():
    c = MemoryConstrainedLRUCache(
        max_num_bytes=100,
        getter=lambda k: np.zeros(k, np.uint8),
        sizer=lambda v: v.nbytes)
    c.get(40)
    c.get(50)
    assert c.num_bytes == 90
    c.get(30)  # evicts 40
    assert c.num_bytes == 80
    assert not c.exists(40)


def test_thread_safe_cache_concurrent():
    import threading

    c = ThreadSafeLRUCache(64, getter=lambda k: k * k)
    errs = []

    def worker(base):
        try:
            for i in range(200):
                assert c.get((base + i) % 97) == ((base + i) % 97) ** 2
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i * 13,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs


def test_stage_timings():
    st = StageTimings()
    with st.stage("a"):
        pass
    with st.stage("a"):
        pass
    with st.stage("b"):
        pass
    assert st.counts["a"] == 2
    assert "a" in st.report()


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh()


def _desc_pairs(rng, B, N):
    d1 = rng.integers(0, 200, (B, N, 128)).astype(np.uint8)
    perms = [rng.permutation(N) for _ in range(B)]
    d2 = np.stack([np.clip(d1[b][perms[b]].astype(int)
                           + rng.integers(-3, 4, (N, 128)), 0, 255)
                   for b in range(B)]).astype(np.uint8)
    v = np.ones((B, N), bool)
    return d1, d2, v, perms


def test_sharded_pair_matching_matches_single_device(mesh8, rng):
    B, N = 8, 128
    d1, d2, v, perms = _desc_pairs(rng, B, N)
    out = sm.match_pair_blocks_sharded(mesh8, d1, d2, v, v)
    assert out.shape == (B, N)
    # compare against the single-device path
    for b in range(B):
        b1 = matching_mod.prepare_descriptors(d1[b])
        b2 = matching_mod.prepare_descriptors(d2[b])
        ref = np.asarray(matching_mod.match_descriptors(b1, b2))
        np.testing.assert_array_equal(out[b], ref)
    # and the planted permutation is recovered
    m = out[0] >= 0
    assert m.mean() > 0.9
    inv = np.argsort(perms[0])
    assert (out[0][m] == inv[m]).mean() > 0.99


def test_exhaustive_all_gather_matching(mesh8, rng):
    I, N = 8, 64
    base = rng.integers(0, 200, (N, 128)).astype(np.uint8)
    descs = np.stack([
        np.clip(base.astype(int) + rng.integers(-3, 4, (N, 128)), 0, 255)
        for _ in range(I)]).astype(np.uint8)
    valid = np.ones((I, N), bool)
    out = sm.exhaustive_match_all_gather(mesh8, descs, valid)
    assert out.shape == (I, I, N)
    # identical features across images: row i vs col j should match
    # feature k to feature k for most k (i != j)
    hits = (out[0, 1] == np.arange(N)).mean()
    assert hits > 0.9


def test_sharded_matcher_traced_once_per_mesh_and_options(mesh8, rng):
    """Pair blocks after the first reuse one jitted program: the matcher
    is traced and lowered once per (mesh, options), not once per block."""
    B, N = 8, 64
    opts = matching_mod.MatchingOptions(max_ratio=0.75)
    fn = sm._sharded_matcher(mesh8, opts)
    assert sm._sharded_matcher(mesh8, opts) is fn
    outs = []
    for _ in range(3):
        d1, d2, v, _ = _desc_pairs(rng, B, N)
        outs.append(sm.match_pair_blocks_sharded(mesh8, d1, d2, v, v, opts))
    assert fn._cache_size() == 1
    assert sm._sharded_matcher(mesh8, matching_mod.MatchingOptions()) is not fn
    assert all(o.shape == (B, N) for o in outs)
