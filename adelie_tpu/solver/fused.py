"""Fused per-lambda device step for the gaussian path.

The host<->device round trip dominates warm per-lambda cost, so the whole
lambda iteration — screen-gradient, covariance-form pin solve, residual
reconstruction, full-gradient invariance, per-group KKT norms and the KKT
verdict — is ONE jitted device computation with a single host pull of
small outputs.  (The reference keeps all of this inside one C++ call per
path for the same reason: one Python<->C++ crossing, py_state.cpp:63-110.)
"""

import jax
import jax.numpy as jnp

from .pin import pin_cov_solve
from .state_core import screen_grad_kernel

_PRECISION = jax.lax.Precision.HIGHEST


def build_gaussian_chunk_step(X, intercept: bool, num_groups: int):
    """Chunked path step: a ``lax.scan`` over several lambdas per device
    call (the BASIL batching idea — screen once for a batch of lambdas,
    fit them back-to-back, verify KKT per lambda).  One host round trip
    per CHUNK instead of per lambda: the difference between
    round-trip-bound and compute-bound paths.

    The scan carry advances through accepted lambdas and freezes once a
    lambda fails KKT (host then grows the screen set and resumes there) or
    the early-exit rule fires.  Per-lambda emissions are small (S-sized
    betas + scalars); the (G,) abs_grad is carried and pulled once.
    """
    mul_fn, _ = X.mul_spec()

    @jax.jit
    def chunk_step(
        X_data,
        A, Xs, means_s, cols_padded,
        slot_begin, slot_size, eigvals, eigvecs, penalty_slots,
        beta0, active0,
        resid0, w, X_means,
        group_ids, penalty_cols, penalty_groups, is_screen_mask,
        lmdas, valid,                    # (C,), (C,) bool
        alpha, tol, dbeta_tol, newton_tol,
        newton_max_iters, max_iters, rsq0,
        y_var, adev_tol, ddev_tol, early_exit_on, prev_dev, have_prev_dev,
        sweep_budget,
    ):
        dtype = beta0.dtype

        def per_lambda(carry, inp):
            (beta, active, resid, rsq, abs_grad_c, stopped, prev_dev,
             have_prev, cum_iters, early_seen) = carry
            lmda, is_valid = inp
            run_it = is_valid & (~stopped)

            def run(args):
                (beta, active, resid, rsq, abs_grad_c, stopped, prev_dev,
                 have_prev, cum_iters, early_seen) = args
                resid_sum0 = jnp.vdot(w, resid, precision=_PRECISION)
                vw = w * resid
                grad_s = jnp.einsum("ns,n->s", Xs, vw, precision=_PRECISION)
                if intercept:
                    grad_s = grad_s - means_s * resid_sum0

                beta_n, _, active_n, rsq_n, iters, done = pin_cov_solve(
                    A, grad_s, beta, slot_begin, slot_size, eigvals, eigvecs,
                    penalty_slots, active, lmda, alpha, tol, dbeta_tol,
                    newton_tol, newton_max_iters, max_iters, rsq,
                )

                dbeta = beta_n - beta
                resid_n = resid - jnp.matmul(Xs, dbeta, precision=_PRECISION)
                resid_sum = jnp.vdot(w, resid_n, precision=_PRECISION)

                grad = mul_fn(X_data, resid_n, w)
                if intercept:
                    grad = grad - resid_sum * X_means

                ok = cols_padded >= 0
                # OOB sentinel: drop padded slots (clamping to 0 races with column 0)
                safe = jnp.where(ok, cols_padded, grad.shape[0])
                beta_cols = jnp.zeros_like(grad).at[safe].set(
                    beta_n, mode="drop"
                )
                l2s = (1.0 - alpha) * jnp.minimum(lmda, 1e30)
                gadj = grad - l2s * (penalty_cols * beta_cols)
                sq = jax.ops.segment_sum(
                    gadj * gadj, group_ids, num_segments=num_groups
                )
                abs_grad = jnp.sqrt(jnp.maximum(sq, 0.0))

                viol = abs_grad > lmda * alpha * penalty_groups
                kkt = ~jnp.any(viol & ~is_screen_mask)
                accept = done & kkt

                dev = jnp.where(y_var > 0, rsq_n / y_var, 0.0)
                early = early_exit_on & accept & (
                    (dev >= adev_tol)
                    | (have_prev & (jnp.abs(dev - prev_dev) < ddev_tol))
                )
                # cooperative watchdog guard: freeze the scan once the
                # chunk's total sweep budget is spent (the host resumes
                # at the next un-accepted lambda)
                cum_n = cum_iters + iters
                stopped_n = (~accept) | early | (cum_n >= sweep_budget)

                carry_n = (
                    beta_n, active_n, resid_n, rsq_n, abs_grad,
                    stopped_n,
                    jnp.where(accept, dev, prev_dev),
                    have_prev | accept,
                    cum_n,
                    early_seen | early,
                )
                emit = (beta_n, rsq_n, resid_sum, accept, kkt, done, dev,
                        jnp.ones((), bool), iters)
                return carry_n, emit

            def skip(args):
                beta, active, *_ = args
                emit = (beta, jnp.zeros((), dtype), jnp.zeros((), dtype),
                        jnp.zeros((), bool), jnp.zeros((), bool),
                        jnp.zeros((), bool), jnp.zeros((), dtype),
                        jnp.zeros((), bool), jnp.zeros((), jnp.int32))
                return args, emit

            return jax.lax.cond(run_it, run, skip, carry)

        init = (beta0, active0, resid0, rsq0,
                jnp.zeros((num_groups,), dtype),
                jnp.zeros((), bool), prev_dev, have_prev_dev,
                jnp.zeros((), jnp.int32), jnp.zeros((), bool))
        carry, emits = jax.lax.scan(per_lambda, init, (lmdas, valid))
        # expose (leading 8 fields, early_seen): cum_iters is internal
        return carry[:8] + (carry[9],), emits

    return chunk_step


_STEP_CACHE = {}


def get_gaussian_step(X, intercept: bool, num_groups: int):
    """Memoized fused step per matrix *structure* — a fresh grpnet call on a
    new dataset with the same shapes reuses the in-process jit cache."""
    try:
        key = ("single", X.structure_key(), bool(intercept), int(num_groups))
    except Exception:
        return build_gaussian_step(X, intercept, num_groups)
    hit = _STEP_CACHE.get(key)
    if hit is None:
        hit = _STEP_CACHE[key] = build_gaussian_step(X, intercept, num_groups)
    return hit


def get_gaussian_chunk_step(X, intercept: bool, num_groups: int):
    try:
        key = ("chunk", X.structure_key(), bool(intercept), int(num_groups))
    except Exception:
        return build_gaussian_chunk_step(X, intercept, num_groups)
    hit = _STEP_CACHE.get(key)
    if hit is None:
        hit = _STEP_CACHE[key] = build_gaussian_chunk_step(
            X, intercept, num_groups
        )
    return hit


def build_gaussian_step(X, intercept: bool, num_groups: int):
    """Create the fused step for a given matrix object.

    The matrix payload travels through ``X_data`` (see
    ``MatrixNaiveBase.mul_spec``) so the compiled program is data-
    independent: the persistent XLA cache hits across datasets and the HLO
    carries no giant constants.  Recompiles only per screen-cache bucket.
    """
    mul_fn, _ = X.mul_spec()

    @jax.jit
    def step(
        X_data,
        A, Xs, means_s, cols_padded,
        slot_begin, slot_size, eigvals, eigvecs, penalty_slots,
        beta0, active0,
        resid, w, X_means,
        group_ids, penalty_cols, penalty_groups, is_screen_mask,
        lmda, alpha, tol, dbeta_tol, newton_tol,
        newton_max_iters, max_iters, rsq,
    ):
        dtype = beta0.dtype
        resid_sum0 = jnp.vdot(w, resid, precision=_PRECISION)
        vw = w * resid
        grad_s = jnp.einsum("ns,n->s", Xs, vw, precision=_PRECISION)
        if intercept:
            grad_s = grad_s - means_s * resid_sum0

        beta, grad_s_new, active, rsq_new, iters, done = pin_cov_solve(
            A, grad_s, beta0, slot_begin, slot_size, eigvals, eigvecs,
            penalty_slots, active0, lmda, alpha, tol, dbeta_tol,
            newton_tol, newton_max_iters, max_iters, rsq,
        )

        dbeta = beta - beta0
        resid_new = resid - jnp.matmul(Xs, dbeta, precision=_PRECISION)
        resid_sum = jnp.vdot(w, resid_new, precision=_PRECISION)

        grad = mul_fn(X_data, resid_new, w)
        if intercept:
            grad = grad - resid_sum * X_means

        # abs_grad (reference update_abs_grad, solver_base.hpp:21-110)
        ok = cols_padded >= 0
        # OOB sentinel: drop padded slots (clamping to 0 races with column 0)
        safe = jnp.where(ok, cols_padded, grad.shape[0])
        beta_cols = jnp.zeros_like(grad).at[safe].set(
            beta, mode="drop"
        )
        l2s = (1.0 - alpha) * jnp.minimum(lmda, 1e30)
        gadj = grad - l2s * (penalty_cols * beta_cols)
        sq = jax.ops.segment_sum(gadj * gadj, group_ids, num_segments=num_groups)
        abs_grad = jnp.sqrt(jnp.maximum(sq, 0.0))

        # KKT verdict (reference solver_base.hpp:410-433)
        viol = abs_grad > lmda * alpha * penalty_groups
        kkt_passed = ~jnp.any(viol & ~is_screen_mask)

        return (beta, active, rsq_new, resid_new, resid_sum, grad, abs_grad,
                kkt_passed, iters, done)

    return step
