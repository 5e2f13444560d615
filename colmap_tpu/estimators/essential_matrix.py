"""Essential matrix estimation: Nistér 5-point, 8-point, Sampson residual.

Reference capability: src/colmap/estimators/essential_matrix.h:22,62 (5pt via
polynomial solve, 8pt with essential projection).

Design of the 5-point solver: the classical Nistér elimination is
re-expressed as dense, shape-static tensor algebra so thousands of minimal
problems solve in one vmapped program:
  1. nullspace of the 5x9 epipolar system (batched SVD),
  2. the 10 cubic constraints (det E = 0, 2*E*E^T*E - tr(E*E^T)E = 0) are
     expanded over the 20-monomial basis with *static* multiplication
     tensors (built once in numpy at import),
  3. Gauss-Jordan via a single 10x10 solve,
  4. the 3x3 polynomial determinant -> degree-10 polynomial,
  5. roots via fixed-iteration Durand-Kerner (math/polynomial.py) instead of
     a non-symmetric eigensolver (not batchable on accelerators).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from colmap_tpu.estimators.fundamental_matrix import (
    _epipolar_rows,
    sampson_residuals,
)
from colmap_tpu.estimators.utils import least_singular_vector, nullspace_from_rows
from colmap_tpu.math.polynomial import find_roots_durand_kerner

# ---------------------------------------------------------------------------
# Static monomial algebra over (x, y, z)
# ---------------------------------------------------------------------------

_MON1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]  # x, y, z, 1
_MON2 = [
    (2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1),
    (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]
# Degree-<=3 monomials, ordered so the first 10 have (x,y)-degree >= 2 and the
# last 10 have (x,y)-degree <= 1 — the split that makes the Nistér
# elimination a plain [I | D] Gauss-Jordan.
_MON3_LEFT = [
    (3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0), (2, 0, 1),
    (1, 1, 1), (0, 2, 1), (2, 0, 0), (1, 1, 0), (0, 2, 0),
]
_MON3_RIGHT = [
    (1, 0, 2), (0, 1, 2), (1, 0, 1), (0, 1, 1), (1, 0, 0),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_MON3 = _MON3_LEFT + _MON3_RIGHT


def _mul_table(mon_a, mon_b, mon_out):
    idx = {m: i for i, m in enumerate(mon_out)}
    T = np.zeros((len(mon_a), len(mon_b), len(mon_out)), dtype=np.float32)
    for i, ma in enumerate(mon_a):
        for j, mb in enumerate(mon_b):
            m = tuple(a + b for a, b in zip(ma, mb))
            T[i, j, idx[m]] = 1.0
    return T


_T11 = jnp.asarray(_mul_table(_MON1, _MON1, _MON2))  # (4, 4, 10)
_T21 = jnp.asarray(_mul_table(_MON2, _MON1, _MON3))  # (10, 4, 20)


def _mul11(a, b):
    return jnp.einsum("...i,...j,ijk->...k", a, b, _T11)


def _mul21(a, b):
    return jnp.einsum("...i,...j,ijk->...k", a, b, _T21)


# ---------------------------------------------------------------------------
# 5-point solver
# ---------------------------------------------------------------------------


def solve_5pt(p1: jax.Array, p2: jax.Array):
    """Nistér 5-point minimal solver on normalized rays.

    p1/p2: (5, 2). Returns (E (10, 3, 3), valid (10,)).
    """
    dtype = p1.dtype
    A = _epipolar_rows(p1, p2)  # (5, 9)
    ns = nullspace_from_rows(A, 4)  # (9, 4) — basis [X, Y, Z, W]

    # E entries as degree-1 polynomials over [x, y, z, 1]
    Epoly = ns.reshape(3, 3, 4)

    # det(E) as a degree-3 polynomial (20 coeffs)
    def det3(E):
        def m2(i1, j1, i2, j2):
            return _mul11(E[i1, j1], E[i2, j2])

        t0 = _mul21(m2(1, 1, 2, 2) - m2(1, 2, 2, 1), E[0, 0])
        t1 = _mul21(m2(1, 0, 2, 2) - m2(1, 2, 2, 0), E[0, 1])
        t2 = _mul21(m2(1, 0, 2, 1) - m2(1, 1, 2, 0), E[0, 2])
        return t0 - t1 + t2

    det_row = det3(Epoly)  # (20,)

    # EE^T (degree-2), trace, and the 9 trace-constraint rows (degree-3)
    EEt = jnp.einsum("ika,jkb,abm->ijm", Epoly, Epoly, _T11)  # (3, 3, 10)
    tr = EEt[0, 0] + EEt[1, 1] + EEt[2, 2]  # (10,)
    C = 2.0 * jnp.einsum("ika,kjb,abm->ijm", EEt, Epoly, _T21) - jnp.einsum(
        "a,ijb,abm->ijm", tr, Epoly, _T21
    )  # (3, 3, 20)

    M = jnp.concatenate([det_row[None, :], C.reshape(9, 20)], axis=0)  # (10, 20)

    ML = M[:, :10]
    MR = M[:, 10:]
    # Gauss-Jordan: equations become L_i = -D[i] . R
    D = jnp.linalg.solve(ML, MR)  # (10, 10)

    # Row i gives: alpha_i(z) x + beta_i(z) y + gamma_i(z) with
    # R = [xz^2, yz^2, xz, yz, x, y, z^3, z^2, z, 1]
    def alpha(i):  # quadratic in z: [c0, c1, c2] ascending
        return jnp.stack([D[i, 4], D[i, 2], D[i, 0]])

    def beta(i):
        return jnp.stack([D[i, 5], D[i, 3], D[i, 1]])

    def gamma(i):  # cubic
        return jnp.stack([D[i, 9], D[i, 8], D[i, 7], D[i, 6]])

    def shift(p):  # multiply polynomial by z (ascending coeffs)
        return jnp.concatenate([jnp.zeros((1,), dtype), p])

    def sub(a, b):  # a - b with padding to max len
        n = max(a.shape[0], b.shape[0])
        a = jnp.concatenate([a, jnp.zeros((n - a.shape[0],), dtype)])
        b = jnp.concatenate([b, jnp.zeros((n - b.shape[0],), dtype)])
        return a - b

    # constraint rows: z * (xy-deg-2 monomial row) - (same monomial * z row)
    # pairs: (x^2: row 7, x^2 z: row 4), (xy: 8, xyz: 5), (y^2: 9, y^2 z: 6)
    rows = []
    for lo, hi in ((7, 4), (8, 5), (9, 6)):
        a = sub(shift(alpha(lo)), alpha(hi))  # degree 3 -> len 4
        b = sub(shift(beta(lo)), beta(hi))
        c = sub(shift(gamma(lo)), gamma(hi))  # degree 4 -> len 5
        rows.append((a, b, c))

    def conv(p, q):
        # polynomial product, ascending coeffs, static shapes
        n = p.shape[0] + q.shape[0] - 1
        out = jnp.zeros((n,), dtype)
        for i in range(p.shape[0]):
            out = out.at[i : i + q.shape[0]].add(p[i] * q)
        return out

    (a1, b1, c1), (a2, b2, c2), (a3, b3, c3) = rows
    # det of [[a1 b1 c1], [a2 b2 c2], [a3 b3 c3]] -> degree 10 (len 11)
    def pad(p, n):
        return jnp.concatenate([p, jnp.zeros((n - p.shape[0],), dtype)])

    term1 = conv(a1, sub(conv(b2, c3), conv(b3, c2)))
    term2 = conv(b1, sub(conv(a2, c3), conv(a3, c2)))
    term3 = conv(c1, sub(conv(a2, b3), conv(a3, b2)))
    n = 11
    det_poly = pad(term1, n) - pad(term2, n) + pad(term3, n)  # ascending

    # roots (descending coeff order for the root finder)
    roots = find_roots_durand_kerner(det_poly[::-1], num_iters=80)  # (10,) complex
    z = jnp.real(roots)
    is_real = jnp.abs(jnp.imag(roots)) <= 1e-3 * (1.0 + jnp.abs(z))

    def eval_asc(p, zz):
        out = jnp.zeros_like(zz)
        for i in range(p.shape[0] - 1, -1, -1):
            out = out * zz + p[i]
        return out

    # back-substitute x, y for each root via the best 2x2 subsystem
    B = jnp.stack(
        [
            jnp.stack([eval_asc(pad(a, 5), z), eval_asc(pad(b, 5), z), eval_asc(pad(c, 5), z)], axis=-1)
            for (a, b, c) in rows
        ],
        axis=-2,
    )  # (10, 3, 3): per root, the 3x3 numeric matrix

    # nullspace of B via cross products of row pairs; pick the pair with the
    # largest result norm (most numerically stable)
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    cands = jnp.stack([c01, c02, c12], axis=-2)  # (10, 3, 3)
    norms = jnp.linalg.norm(cands, axis=-1)
    best = jnp.argmax(norms, axis=-1)
    sol = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    w = sol[..., 2]
    w_safe = jnp.where(jnp.abs(w) > 1e-12, w, 1e-12)
    x = sol[..., 0] / w_safe
    y = sol[..., 1] / w_safe

    # E = x X + y Y + z Z + W
    coeffs = jnp.stack([x, y, z, jnp.ones_like(z)], axis=-1)  # (10, 4)
    E = jnp.einsum("rk,ijk->rij", coeffs, Epoly)
    E = E / (jnp.linalg.norm(E, axis=(-2, -1), keepdims=True) + 1e-12)
    valid = is_real & (jnp.abs(w) > 1e-10) & jnp.isfinite(E).all(axis=(-2, -1))
    return E, valid


# ---------------------------------------------------------------------------
# 8-point + essential projection (also the LO refit)
# ---------------------------------------------------------------------------


def project_to_essential(F: jax.Array) -> jax.Array:
    """Nearest essential matrix: singular values -> (s, s, 0)."""
    U, s, Vt = jnp.linalg.svd(F)
    sigma = 0.5 * (s[..., 0] + s[..., 1])
    s_new = jnp.stack([sigma, sigma, jnp.zeros_like(sigma)], axis=-1)
    E = U @ (s_new[..., :, None] * Vt)
    return E / (jnp.linalg.norm(E, axis=(-2, -1), keepdims=True) + 1e-12)


def _solve_8pt_essential(p1, p2, weights=None):
    A = _epipolar_rows(p1, p2)
    if weights is not None:
        A = A * jnp.sqrt(weights)[..., None]
    f = least_singular_vector(A)
    E = project_to_essential(f.reshape(f.shape[:-1] + (3, 3)))
    ok = jnp.isfinite(E).all(axis=(-2, -1))
    return E, ok


def solve_8pt(p1: jax.Array, p2: jax.Array):
    E, ok = _solve_8pt_essential(p1, p2)
    return E[None], ok[None]


def refit(model: jax.Array, data: tuple, weights: jax.Array):
    del model
    p1, p2 = data
    return _solve_8pt_essential(p1, p2, weights)


residuals = sampson_residuals
