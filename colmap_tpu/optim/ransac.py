"""Batched RANSAC / LO-RANSAC as a single fused JAX program.

The reference's RANSAC (src/colmap/optim/ransac.h:77-120, loransac.h:51) is a
sequential trial loop with dynamic termination. The batched re-design
inverts this: solve a *fixed budget* of minimal problems simultaneously
(vmapped solver), score every hypothesis against every observation with one
batched residual evaluation (a GEMM-shaped op), pick the best, and run a
fixed number of local-optimization refits on the inlier set. The fixed
budget is chosen so that the success probability matches or exceeds the
reference's adaptive loop at its default confidence (0.9999) for inlier
ratios >= min_inlier_ratio, while mapping to dense device compute.

Support scoring uses MSAC-style truncated quadratic loss (never worse than
plain inlier counting, subsumes the reference's InlierSupportMeasurer
choice; reference: src/colmap/optim/support_measurement.h:41-92).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class RansacOptions:
    max_error: float = 4.0
    min_inlier_ratio: float = 0.25
    confidence: float = 0.9999
    # Hypothesis budget. If None, derived from confidence/min_inlier_ratio.
    num_samples: Optional[int] = 1024
    lo_iterations: int = 3
    # maximum K for dyn_num_trials parity checks
    max_num_trials: int = 65536
    # support measurer: "msac" (truncated-loss score, default) or
    # "inlier_count" (reference: optim/support_measurement.h
    # InlierSupportMeasurer vs MEstimatorSupportMeasurer)
    support: str = "msac"

    def resolved_num_samples(self, sample_size: int) -> int:
        if self.num_samples is not None:
            return self.num_samples
        # Same formula as the reference's adaptive bound, evaluated at the
        # pessimistic inlier ratio: N = log(1-conf) / log(1 - w^k).
        w = self.min_inlier_ratio
        p_good = max(w**sample_size, 1e-12)
        n = math.log(max(1.0 - self.confidence, 1e-12)) / math.log(1.0 - p_good)
        n = int(min(max(n, 64), self.max_num_trials))
        # round up to a multiple of 64 for nice tiling
        return (n + 63) // 64 * 64


class RansacResult(NamedTuple):
    model: jax.Array  # best model parameters
    inlier_mask: jax.Array  # (N,) bool
    num_inliers: jax.Array  # scalar int
    score: jax.Array  # scalar float (negated MSAC loss; higher better)
    success: jax.Array  # scalar bool


def draw_minimal_samples(key: jax.Array, valid: jax.Array, num_samples: int,
                         sample_size: int,
                         weights: Optional[jax.Array] = None) -> jax.Array:
    """Draw (num_samples, sample_size) index sets without replacement.

    Implemented as per-hypothesis top-k over random keys — one fused op, no
    sequential Fisher-Yates. Invalid points get -inf keys so they are never
    selected (callers must ensure >= sample_size valid points).

    `weights` (optional, (N,) >= 0) biases the draw toward high-quality
    points — the batched analog of the reference's PROSAC
    ProgressiveSampler (optim/progressive_sampler.h): instead of growing a
    ranked prefix over sequential trials, every hypothesis samples
    proportional-to-quality without replacement (exponential race).
    """
    n = valid.shape[0]
    if weights is None:
        r = jax.random.uniform(key, (num_samples, n))
    else:
        # Gumbel/exponential race: keys = log(w) + Gumbel gives weighted
        # sampling without replacement via top-k
        g = jax.random.gumbel(key, (num_samples, n))
        r = jnp.log(jnp.maximum(weights, 1e-12))[None, :] + g
    r = jnp.where(valid[None, :], r, -jnp.inf)
    _, idx = jax.lax.top_k(r, sample_size)
    return idx


def ransac(
    key: jax.Array,
    solver: Callable,  # (sample_data...) -> (models (M, ...), model_valid (M,))
    residual_fn: Callable,  # (model, data) -> (N,) squared errors
    refit_fn: Optional[Callable],  # (model, data, weights (N,)) -> (model, ok)
    data: tuple,  # tuple of arrays with leading axis N
    valid: jax.Array,  # (N,) bool
    sample_size: int,
    options: RansacOptions,
    sample_weights: Optional[jax.Array] = None,
) -> RansacResult:
    """Run batched (LO-)RANSAC. Fully jittable; all shapes static.

    `solver` is vmapped over hypothesis samples and may return multiple
    candidate models per sample (M axis) with a validity mask.
    `residual_fn` is vmapped over models.
    `refit_fn` (optional) implements the local-optimization non-minimal fit
    on weighted observations (LO-RANSAC; reference optim/loransac.h).
    """
    n = valid.shape[0]
    num_samples = options.resolved_num_samples(sample_size)
    max_err2 = options.max_error**2

    k_sample, _ = jax.random.split(key)
    idx = draw_minimal_samples(k_sample, valid, num_samples, sample_size,
                               weights=sample_weights)

    sample_data = tuple(jnp.take(d, idx, axis=0) for d in data)  # (S, k, ...)
    models, model_valid = jax.vmap(solver)(*sample_data)
    # flatten hypothesis x multiplicity axes
    models = models.reshape((-1,) + models.shape[2:])
    model_valid = model_valid.reshape(-1)

    def score_model(model):
        r2 = residual_fn(model, data)  # (N,)
        r2 = jnp.where(valid, r2, jnp.inf)
        inl = r2 < max_err2
        if options.support == "inlier_count":
            score = jnp.sum(inl).astype(jnp.float32)
        else:
            # negative MSAC loss: sum over valid of
            # (max_err2 - min(r2, max_err2))
            score = jnp.sum(jnp.where(valid,
                                      max_err2 - jnp.minimum(r2, max_err2),
                                      0.0))
        return score, inl

    scores, inlier_masks = jax.vmap(score_model)(models)
    scores = jnp.where(model_valid, scores, -jnp.inf)
    best = jnp.argmax(scores)
    best_model = models[best]
    best_score = scores[best]
    best_mask = inlier_masks[best]

    # --- local optimization: iterative non-minimal refit on inliers --------
    if refit_fn is not None:

        def lo_step(carry, _):
            model, mask, score = carry
            w = jnp.where(mask & valid, 1.0, 0.0)
            new_model, ok = refit_fn(model, data, w)
            new_score, new_mask = score_model(new_model)
            better = ok & (new_score > score)
            model = jnp.where(better, new_model, model)
            mask = jnp.where(better, new_mask, mask)
            score = jnp.where(better, new_score, score)
            return (model, mask, score), None

        (best_model, best_mask, best_score), _ = jax.lax.scan(
            lo_step, (best_model, best_mask, best_score), None,
            length=options.lo_iterations,
        )

    num_inliers = jnp.sum(best_mask & valid)
    success = num_inliers >= sample_size
    return RansacResult(
        model=best_model,
        inlier_mask=best_mask & valid,
        num_inliers=num_inliers,
        score=best_score,
        success=success,
    )
