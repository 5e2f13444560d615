"""Native C++ runtime tests (union-find, CSR, matcher, hamming) + parity
with the device matcher."""

import numpy as np
import pytest

from colmap_tpu import native


def test_native_library_builds():
    assert native.available(), "g++ toolchain present but native build failed"


def test_union_find_components(rng):
    # three chains + isolated nodes
    edges = [(0, 1), (1, 2), (5, 6), (8, 9), (9, 10), (10, 8)]
    a = np.array([e[0] for e in edges])
    b = np.array([e[1] for e in edges])
    labels = native.union_find(a, b, 12)
    assert labels[0] == labels[1] == labels[2]
    assert labels[5] == labels[6]
    assert labels[8] == labels[9] == labels[10]
    assert len({labels[0], labels[5], labels[8], labels[3]}) == 4


def test_union_find_random_vs_scipy(rng):
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = 500
    a = rng.integers(0, n, 800)
    b = rng.integers(0, n, 800)
    labels = native.union_find(a, b, n)
    g = coo_matrix((np.ones(len(a)), (a, b)), shape=(n, n))
    n_comp, sp_labels = connected_components(g, directed=False)
    assert len(np.unique(labels)) == n_comp
    # same partition
    for c in np.unique(sp_labels):
        ours = labels[sp_labels == c]
        assert (ours == ours[0]).all()


def test_build_csr(rng):
    keys = rng.integers(0, 10, 100)
    offsets, order = native.build_csr(keys, 10)
    assert offsets[0] == 0 and offsets[-1] == 100
    for b in range(10):
        grp = order[offsets[b]:offsets[b + 1]]
        assert (keys[grp] == b).all()


def test_native_matcher_parity_with_device_matcher(rng):
    from colmap_tpu.features import matching as m

    d1 = rng.integers(0, 180, (300, 128)).astype(np.uint8)
    # half of d2 are noisy copies of d1 rows, half random
    idx = rng.permutation(300)
    d2 = d1[idx].astype(np.int32) + rng.integers(-4, 5, (300, 128))
    d2 = np.clip(d2, 0, 255).astype(np.uint8)

    native_idx = native.match_descriptors_u8(d1, d2)
    b1 = m.prepare_descriptors(d1)
    b2 = m.prepare_descriptors(d2)
    device_idx = np.asarray(m.match_descriptors(b1, b2))
    agree = (native_idx == device_idx).mean()
    assert agree > 0.98, f"native/device matcher agreement {agree:.3f}"
    # and both recover the planted permutation
    matched = native_idx >= 0
    assert matched.mean() > 0.9
    assert (native_idx[matched] == np.argsort(idx)[matched]).mean() > 0.99


def test_hamming_distances(rng):
    sigs = rng.integers(0, 2**63, 50, dtype=np.uint64)
    q = int(sigs[7])
    d = native.hamming_distances(sigs, q)
    assert d[7] == 0
    expect = [bin(int(s) ^ q).count("1") for s in sigs]
    np.testing.assert_array_equal(d, expect)
