"""The fused matcher kernel vs the plain reference matcher.

The kernel runs here through the Pallas interpreter; on a GPU
`chip_smoke.py` compiles it and compares it with the same reference at the
production block size. Off the GPU the production entry runs the reference.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from colmap_tpu.features import matching as m
from colmap_tpu.features import pallas_matcher as pm


def _fused(b1, b2, options=m.MatchingOptions(), **tiles):
    stats = pm.match_statistics(b1, b2, interpret=True, **tiles)
    return np.asarray(m.select_from_statistics(*stats, b1.valid, options))


def _batch(d, v=None):
    if v is None:
        v = np.ones(d.shape[:2], bool)
    return jax.vmap(m.prepare_descriptors)(jnp.asarray(d), jnp.asarray(v))


def _noisy_copies(rng, B, n, m_rows=None):
    m_rows = m_rows or n
    d1 = rng.integers(0, 200, (B, n, 128)).astype(np.uint8)
    d2 = np.empty((B, m_rows, 128), np.uint8)
    for b in range(B):
        src = d1[b, rng.integers(0, n, m_rows)]
        d2[b] = np.clip(src.astype(int) + rng.integers(-3, 4, src.shape),
                        0, 255)
    return d1, d2


def test_pallas_matcher_agrees_with_exact(rng):
    n = 512
    d1 = rng.integers(0, 200, (1, n, 128)).astype(np.uint8)
    perm = rng.permutation(n)
    d2 = np.clip(d1[:, perm].astype(int) + rng.integers(-3, 4, (1, n, 128)),
                 0, 255).astype(np.uint8)
    b1, b2 = _batch(d1), _batch(d2)
    out = _fused(b1, b2, tile_n=128, tile_m=64)[0]
    ref = np.asarray(m.match_pairs_batch(b1, b2))[0]
    np.testing.assert_array_equal(out, ref)
    matched = out >= 0
    assert matched.mean() > 0.9
    assert (out[matched] == np.argsort(perm)[matched]).mean() > 0.99


@pytest.mark.parametrize("tiles", [dict(tile_n=64, tile_m=128),
                                   dict(tile_n=128, tile_m=32)])
def test_pallas_batched_agrees_with_exact(rng, tiles):
    B, n = 3, 256
    d1, d2 = _noisy_copies(rng, B, n)
    v1 = np.ones((B, n), bool)
    v2 = np.ones((B, n), bool)
    v2[0, : n // 4] = False  # padding rows in one pair of the block
    v1[1, : n // 8] = False
    b1, b2 = _batch(d1, v1), _batch(d2, v2)
    out = _fused(b1, b2, **tiles)
    ref = np.asarray(m.match_pairs_batch(b1, b2))
    assert out.shape == (B, n)
    np.testing.assert_array_equal(out, ref)


def test_pallas_matcher_handles_invalid_rows(rng):
    n = 256
    d1 = rng.integers(0, 200, (1, n, 128)).astype(np.uint8)
    v2 = np.ones((1, n), bool)
    v2[0, : n // 2] = False  # half of image-2 rows are padding
    out = _fused(_batch(d1), _batch(d1.copy(), v2), tile_m=64)[0]
    # no match may point at an invalid row
    assert not np.any((out >= 0) & (out < n // 2))
    # valid identical rows still match
    assert (out[n // 2:] == np.arange(n // 2, n)).mean() > 0.95


def test_pallas_matcher_ties_resolve_like_reference(rng):
    """Duplicated targets and duplicated queries: the forward argmax and the
    cross check's reverse argmax both keep the lowest index, across tile
    borders, exactly as jnp.argmax in the reference does."""
    n = 128
    base = rng.integers(0, 200, (n, 128)).astype(np.uint8)
    # target rows k and k + 64 are identical (they sit in different
    # 32-wide tiles); query rows repeat the same way
    d2 = np.concatenate([base[:64], base[:64]])[None]
    d1 = np.concatenate([base[:64], base[:64]])[None]
    b1, b2 = _batch(d1), _batch(d2)
    loose = m.MatchingOptions(max_ratio=1.01, max_distance=3.2)
    for opts in (m.MatchingOptions(), loose):
        out = _fused(b1, b2, opts, tile_n=32, tile_m=32)
        ref = np.asarray(m.match_pairs_batch(b1, b2, opts))
        np.testing.assert_array_equal(out, ref)
    # the statistics keep the first of the tied rows, and the tied
    # duplicate is the second best
    best, second, idx, rev = pm.match_statistics(b1, b2, tile_n=32,
                                                 tile_m=32, interpret=True)
    np.testing.assert_array_equal(np.asarray(idx)[0], np.arange(n) % 64)
    np.testing.assert_array_equal(np.asarray(rev)[0], np.arange(n) % 64)
    np.testing.assert_array_equal(np.asarray(best), np.asarray(second))


@pytest.mark.parametrize("n,m_rows", [(200, 300), (40, 72)])
def test_pallas_matcher_capacity_not_multiple_of_tile(rng, n, m_rows):
    """Capacities that are not a multiple of the tile are padded with
    invalid rows inside the wrapper and sliced back."""
    d1, d2 = _noisy_copies(rng, 2, n, m_rows)
    v2 = np.ones((2, m_rows), bool)
    v2[1, -7:] = False
    b1, b2 = _batch(d1), _batch(d2, v2)
    out = _fused(b1, b2, tile_n=64, tile_m=128)
    assert out.shape == (2, n)
    np.testing.assert_array_equal(out, np.asarray(m.match_pairs_batch(b1, b2)))
    assert (out >= 0).any()


@pytest.mark.parametrize("side", [1, 2])
def test_pallas_matcher_all_invalid_side(rng, side):
    """A pair whose query or target side holds no valid row (an empty slot
    of a padded pair block) yields no match, and does not disturb the
    other pairs of the block."""
    d1, d2 = _noisy_copies(rng, 2, 128)
    v = [np.ones((2, 128), bool), np.ones((2, 128), bool)]
    v[side - 1][0] = False
    b1, b2 = _batch(d1, v[0]), _batch(d2, v[1])
    out = _fused(b1, b2, tile_n=64, tile_m=64)
    assert (out[0] == -1).all()
    np.testing.assert_array_equal(out, np.asarray(m.match_pairs_batch(b1, b2)))
    assert (out[1] >= 0).mean() > 0.3


def test_production_matcher_picks_interpreter_off_gpu(rng):
    """`match_pairs` is the one production entry. Off the GPU it does not
    run the kernel's interpreter (4-8x slower than XLA on a CPU): its
    program holds no pallas_call, and it gives the reference's answer."""
    d1, d2 = _noisy_copies(rng, 2, 256)
    b1, b2 = _batch(d1), _batch(d2)
    assert jax.default_backend() != "gpu"
    assert "pallas_call" not in str(jax.make_jaxpr(pm.match_pairs)(b1, b2))
    assert "pallas_call" in str(jax.make_jaxpr(
        lambda a, b: pm.match_statistics(a, b, interpret=True))(b1, b2))
    np.testing.assert_array_equal(np.asarray(pm.match_pairs(b1, b2)),
                                  np.asarray(m.match_pairs_batch(b1, b2)))
