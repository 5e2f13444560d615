"""Polynomial root finding as fixed-iteration JAX programs.

Reference capability: src/colmap/math/polynomial.h (companion-matrix +
Durand-Kerner). A general non-symmetric eig does not batch on
accelerators, so we use the
Aberth-Ehrlich / Durand-Kerner simultaneous iteration in complex arithmetic
with a fixed iteration count — fully vmappable, so RANSAC can solve
thousands of minimal-problem polynomials in one fused program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def find_roots_durand_kerner(coeffs: jax.Array, num_iters: int = 60) -> jax.Array:
    """Roots of a polynomial with leading coefficient first.

    coeffs: (..., D+1) real or complex, highest degree first. Degenerate
    (near-zero) leading coefficients are regularized; callers should mask
    spurious roots downstream (standard fixed-capacity RANSAC practice).
    Returns complex roots (..., D).
    """
    coeffs = jnp.asarray(coeffs)
    D = coeffs.shape[-1] - 1
    lead = coeffs[..., :1]
    lead = jnp.where(jnp.abs(lead) > 1e-12, lead, 1e-12)
    cm = coeffs / lead  # monic, real

    # Rescale z = s*w so roots w are O(1): coefficient i (descending order)
    # scales by s^-i. Keeps w^D in comfortable float32 range during
    # iteration (unscaled DK overflows f32 when roots are ~10).
    cauchy_r = 1.0 + jnp.max(jnp.abs(cm[..., 1:]), axis=-1, keepdims=True)
    s = jnp.maximum(cauchy_r ** (1.0 / D), 1e-6)
    powers = jnp.arange(D + 1, dtype=cm.dtype)
    cm = cm / s**powers
    c = cm.astype(jnp.complex64)

    # Initial guesses: roots of unity with an irrational-angle offset
    # (avoids symmetry stalls). Radius ~ scaled Cauchy bound (~O(1)).
    cauchy = 1.0 + jnp.max(jnp.abs(c[..., 1:]), axis=-1, keepdims=True)
    k = jnp.arange(D, dtype=jnp.float32)
    angles = 2.0 * jnp.pi * k / D + 0.4
    unit = jax.lax.complex(jnp.cos(angles), jnp.sin(angles))  # complex exp is
    # unimplemented on some backends; build from cos/sin instead.
    init = (0.7 * cauchy).astype(jnp.complex64) * unit

    def poly_eval(z):
        # Horner over the last axis of c (static unroll; D <= ~10 in practice)
        acc = jnp.broadcast_to(c[..., 0:1], z.shape).astype(jnp.complex64)
        for i in range(1, D + 1):
            acc = acc * z + c[..., i : i + 1]
        return acc

    def step(_, z):
        p = poly_eval(z)
        # denominator: prod_{j != i} (z_i - z_j)
        diff = z[..., :, None] - z[..., None, :]
        diff = diff + jnp.eye(D, dtype=jnp.complex64)  # diagonal -> 1
        denom = jnp.prod(diff, axis=-1)
        denom = jnp.where(jnp.abs(denom) > 1e-20, denom, 1e-20)
        delta = p / denom
        # trust-region clamp: keeps transient f32 overflows from poisoning
        # the iteration (roots are O(1) after rescaling)
        mag = jnp.abs(delta)
        delta = jnp.where(mag > 1.0, delta / mag, delta)
        return z - delta

    w = jax.lax.fori_loop(0, num_iters, step, init)
    return w * s.astype(jnp.complex64)  # undo root scaling


def real_roots(coeffs: jax.Array, num_iters: int = 60, imag_tol: float = 1e-4):
    """Return (roots_real (..., D), valid_mask (..., D)) of the real roots.

    Validity uses a relative imaginary tolerance |im| <= tol * (1 + |re|).
    """
    z = find_roots_durand_kerner(coeffs, num_iters)
    re, im = jnp.real(z), jnp.imag(z)
    valid = jnp.abs(im) <= imag_tol * (1.0 + jnp.abs(re))
    return re, valid


def eval_poly(coeffs: jax.Array, x: jax.Array) -> jax.Array:
    """Evaluate polynomial (highest degree first) at x, broadcasting."""
    D = coeffs.shape[-1]

    acc = coeffs[..., 0] * jnp.ones_like(x)
    for i in range(1, D):
        acc = acc * x + coeffs[..., i]
    return acc


def cubic_real_roots(c3, c2, c1, c0):
    """All-real-branch cubic solver via trigonometric method.

    Returns (roots (..., 3), valid (..., 3)). For the one-real-root case the
    first root is valid and the rest masked. Used by the 7-point F solver.
    """
    c3 = jnp.where(jnp.abs(c3) > 1e-12, c3, 1e-12)
    a = c2 / c3
    b = c1 / c3
    c = c0 / c3
    q = (3.0 * b - a * a) / 9.0
    r = (9.0 * a * b - 27.0 * c - 2.0 * a**3) / 54.0
    disc = q**3 + r**2

    # three real roots (disc <= 0): trig method
    theta = jnp.arccos(jnp.clip(r / jnp.sqrt(jnp.maximum(-(q**3), 1e-24)), -1.0, 1.0))
    m = 2.0 * jnp.sqrt(jnp.maximum(-q, 0.0))
    r1 = m * jnp.cos(theta / 3.0) - a / 3.0
    r2 = m * jnp.cos((theta + 2.0 * jnp.pi) / 3.0) - a / 3.0
    r3 = m * jnp.cos((theta + 4.0 * jnp.pi) / 3.0) - a / 3.0

    # one real root (disc > 0): Cardano
    s = jnp.cbrt(r + jnp.sqrt(jnp.maximum(disc, 0.0)))
    t = jnp.cbrt(r - jnp.sqrt(jnp.maximum(disc, 0.0)))
    r_single = s + t - a / 3.0

    three = disc <= 0
    roots = jnp.stack(
        [jnp.where(three, r1, r_single), jnp.where(three, r2, r_single), jnp.where(three, r3, r_single)],
        axis=-1,
    )
    valid = jnp.stack([jnp.ones_like(three), three, three], axis=-1)
    return roots, valid
