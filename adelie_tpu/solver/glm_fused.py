"""Fused per-lambda / per-chunk GLM (IRLS) device steps.

The unfused GLM driver (glm_driver.py) syncs the host several times per
IRLS iteration (hess_sum, convergence criterion, done flag) — hundreds of
host round trips per path.  Here the ENTIRE
proximal-Newton fit at one lambda — IRLS reweighting, screen Gram +
eigendecomposition refresh, covariance-form pin solve, working-residual
update, convergence check — runs as ONE ``lax.while_loop``, with the
invariance gradient, per-group KKT norms, and the KKT verdict folded in
(the gaussian fused step's trick, fused.py).  ``build_glm_chunk_step``
additionally scans a BATCH of lambdas per device call, freezing at the
first KKT failure / early exit (one host round trip per chunk).

Mirrors reference ``solver_glm_naive.hpp`` fit (:241-459) + invariance
(:495-503) + the deviance early-exit (solver_base.hpp:241-263).
"""

import jax
import jax.numpy as jnp

from ..configs import configs
from .pin import pin_cov_solve, screen_eigh, screen_gram

_PRECISION = jax.lax.Precision.HIGHEST


def _make_irls_fit(glm, intercept: bool, qmax: int, dtype):
    """Shared IRLS core: fit one lambda over a fixed screen block."""
    hmin = (
        configs.hessian_min
        if jnp.dtype(dtype) == jnp.float64
        else configs.hessian_min_f32
    )

    def irls_fit(
        Xs, slot_begin, slot_size, penalty_slots,
        beta0, active0, eta0, resid0, b0_init, offsets,
        lmda, alpha, tol_base, irls_tol, irls_max_iters,
        dbeta_tol, newton_tol, newton_max_iters, max_iters,
    ):
        def hessian_floor(h):
            return jnp.maximum(h, 0.0) + hmin * (h <= 0)

        def irls_body(carry):
            (beta, active, eta, resid, b0, _, it, _, pin_ok) = carry
            grad_n = resid
            hess = hessian_floor(glm.hessian(eta, grad_n))
            irls_resid = glm.inv_hessian_gradient(eta, grad_n, hess)
            hess_sum = jnp.sum(hess)
            irls_w = hess / hess_sum
            irls_y = irls_resid + eta - offsets
            y_mean = jnp.vdot(irls_w, irls_y, precision=_PRECISION)
            if intercept:
                irls_resid = irls_resid + (b0 - y_mean)
            resid_sum = jnp.vdot(irls_w, irls_resid, precision=_PRECISION)
            lmda_adj = lmda / hess_sum
            tol_adj = tol_base / hess_sum

            # refresh weighted Gram + eigendecomposition (reference
            # solver_glm_naive.hpp:361-385)
            A, means_s = screen_gram(Xs, irls_w, intercept)
            eigvals, eigvecs = screen_eigh(A, slot_begin, slot_size, qmax)

            wv = irls_w * irls_resid
            grad_s = jnp.einsum("ns,n->s", Xs, wv, precision=_PRECISION)
            if intercept:
                grad_s = grad_s - means_s * resid_sum

            beta_n, _, active_n, _, _, done = pin_cov_solve(
                A, grad_s, beta, slot_begin, slot_size, eigvals, eigvecs,
                penalty_slots, active, lmda_adj, alpha, tol_adj, dbeta_tol,
                newton_tol, newton_max_iters, max_iters, jnp.zeros((), dtype),
            )

            dbeta = beta_n - beta
            irls_resid = irls_resid - jnp.matmul(Xs, dbeta,
                                                 precision=_PRECISION)
            resid_sum_n = jnp.vdot(irls_w, irls_resid, precision=_PRECISION)
            b0_n = jnp.where(intercept, y_mean + resid_sum_n, 0.0)

            eta_n = irls_y + offsets - irls_resid
            if intercept:
                eta_n = eta_n + (b0_n - y_mean)
            resid_n = glm.gradient(eta_n)
            crit = jnp.abs(jnp.vdot(resid_n - resid, eta_n - eta,
                                    precision=_PRECISION))
            # divergence guard: a non-finite criterion (f32 overflow in a
            # saturating GLM) would otherwise never satisfy any exit test
            # and spin the loop to its full budget
            it_n = jnp.where(jnp.isfinite(crit), it + 1, irls_max_iters)
            return (beta_n, active_n, eta_n, resid_n, b0_n, crit, it_n,
                    crit <= irls_tol, done)

        def irls_cond(carry):
            _, _, _, _, _, _, it, converged, pin_ok = carry
            return (~converged) & pin_ok & (it < irls_max_iters)

        init = (beta0, active0, eta0, resid0, b0_init,
                jnp.asarray(jnp.inf, dtype), jnp.zeros((), jnp.int32),
                jnp.zeros((), bool), jnp.ones((), bool))
        (beta, active, eta, resid, b0, crit, irls_iters, converged,
         pin_ok) = jax.lax.while_loop(irls_cond, irls_body, init)
        return beta, active, eta, resid, b0, irls_iters, converged, pin_ok

    return irls_fit


def _kkt_block(mul_fn, X_data, resid, beta, cols_padded, group_ids,
               penalty_cols, penalty_groups, is_screen_mask, lmda, alpha,
               num_groups):
    """Full gradient + abs_grad + KKT verdict (solver_base.hpp:21-110,
    410-433)."""
    ones = jnp.ones_like(resid)
    grad = mul_fn(X_data, resid, ones)
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
    viol = abs_grad > lmda * alpha * penalty_groups
    kkt_passed = ~jnp.any(viol & ~is_screen_mask)
    return grad, abs_grad, kkt_passed


def build_glm_step(glm, X, intercept: bool, num_groups: int, qmax: int,
                   dtype):
    """Single-lambda fused IRLS step."""
    mul_fn, _ = X.mul_spec()
    irls_fit = _make_irls_fit(glm, intercept, qmax, dtype)

    @jax.jit
    def step(
        X_data,
        Xs, cols_padded, slot_begin, slot_size, penalty_slots,
        beta0, active0,
        eta0, resid0, b0_init, offsets,
        group_ids, penalty_cols, penalty_groups, is_screen_mask,
        lmda, alpha, tol_base,
        irls_tol, irls_max_iters,
        dbeta_tol, newton_tol, newton_max_iters, max_iters,
    ):
        beta, active, eta, resid, b0, irls_iters, converged, pin_ok = (
            irls_fit(
                Xs, slot_begin, slot_size, penalty_slots,
                beta0, active0, eta0, resid0, b0_init, offsets,
                lmda, alpha, tol_base, irls_tol, irls_max_iters,
                dbeta_tol, newton_tol, newton_max_iters, max_iters,
            )
        )
        grad, abs_grad, kkt_passed = _kkt_block(
            mul_fn, X_data, resid, beta, cols_padded, group_ids,
            penalty_cols, penalty_groups, is_screen_mask, lmda, alpha,
            num_groups,
        )
        loss = glm.loss(eta)
        return (beta, active, eta, resid, b0, grad, abs_grad, kkt_passed,
                loss, irls_iters, converged, pin_ok)

    return step


def build_glm_chunk_step(glm, X, intercept: bool, num_groups: int, qmax: int,
                         dtype):
    """Chunked path step: ``lax.scan`` over a batch of lambdas per device
    call (the gaussian chunk idea, fused.py:20).  The carry freezes at the
    first KKT failure, IRLS failure, or deviance early exit; failed lambdas
    do NOT advance the iterate (reference retry semantics + the exception-
    safe rollback of solver_glm_naive.hpp:315-322)."""
    mul_fn, _ = X.mul_spec()
    irls_fit = _make_irls_fit(glm, intercept, qmax, dtype)

    @jax.jit
    def chunk_step(
        X_data,
        Xs, cols_padded, slot_begin, slot_size, penalty_slots,
        beta0, active0,
        eta0, resid0, b0_init, offsets,
        group_ids, penalty_cols, penalty_groups, is_screen_mask,
        lmdas, valid,                       # (C,), (C,) bool
        alpha, tol_base, irls_tol, irls_max_iters,
        dbeta_tol, newton_tol, newton_max_iters, max_iters,
        loss_null, loss_full, adev_tol, ddev_tol, early_exit_on,
        prev_dev, have_prev_dev,
        sweep_budget,
    ):
        def per_lambda(carry, inp):
            (beta, active, eta, resid, b0, abs_grad_c, stopped, prev_dev,
             have_prev, cum_irls, early_seen) = carry
            lmda, is_valid = inp
            run_it = is_valid & (~stopped)

            def run(args):
                (beta, active, eta, resid, b0, abs_grad_c, stopped,
                 prev_dev, have_prev, cum_irls, early_seen) = args
                (beta_n, active_n, eta_n, resid_n, b0_n, irls_iters,
                 converged, pin_ok) = irls_fit(
                    Xs, slot_begin, slot_size, penalty_slots,
                    beta, active, eta, resid, b0, offsets,
                    lmda, alpha, tol_base, irls_tol, irls_max_iters,
                    dbeta_tol, newton_tol, newton_max_iters, max_iters,
                )
                fit_ok = converged & pin_ok
                grad, abs_grad, kkt = _kkt_block(
                    mul_fn, X_data, resid_n, beta_n, cols_padded, group_ids,
                    penalty_cols, penalty_groups, is_screen_mask, lmda,
                    alpha, num_groups,
                )
                accept = fit_ok & kkt
                loss = glm.loss(eta_n)
                dev = (loss_null - loss) / (loss_null - loss_full)
                early = early_exit_on & accept & (
                    (dev >= adev_tol)
                    | (have_prev & (jnp.abs(dev - prev_dev) < ddev_tol))
                )
                # cooperative watchdog guard (configs.chunk_sweep_budget)
                cum_n = cum_irls + irls_iters
                stopped_n = (~accept) | early | (cum_n >= sweep_budget)

                # failed lambdas do not advance the iterate (rollback)
                def commit(_):
                    return (beta_n, active_n, eta_n, resid_n, b0_n, abs_grad,
                            stopped_n, jnp.where(accept, dev, prev_dev),
                            have_prev | accept, cum_n, early_seen | early)

                def keep(_):
                    return (beta, active, eta, resid, b0, abs_grad,
                            jnp.ones((), bool), prev_dev, have_prev, cum_n,
                            early_seen)

                carry_n = jax.lax.cond(fit_ok, commit, keep, None)
                emit = (beta_n, b0_n, accept, kkt, fit_ok, pin_ok, dev,
                        loss, jnp.ones((), bool), irls_iters)
                return carry_n, emit

            def skip(args):
                beta = args[0]
                emit = (beta, jnp.zeros((), dtype), jnp.zeros((), bool),
                        jnp.zeros((), bool), jnp.zeros((), bool),
                        jnp.ones((), bool), jnp.zeros((), dtype),
                        jnp.zeros((), dtype), jnp.zeros((), bool),
                        jnp.zeros((), jnp.int32))
                return args, emit

            return jax.lax.cond(run_it, run, skip, carry)

        init = (beta0, active0, eta0, resid0, b0_init,
                jnp.zeros((num_groups,), dtype), jnp.zeros((), bool),
                prev_dev, have_prev_dev, jnp.zeros((), jnp.int32),
                jnp.zeros((), bool))
        carry, emits = jax.lax.scan(per_lambda, init, (lmdas, valid))
        # expose the leading 9 fields + early_seen (cum sweeps internal)
        return carry[:9] + (carry[10],), emits

    return chunk_step


_GLM_STEP_CACHE = {}


def get_glm_step(glm, X, intercept: bool, num_groups: int, qmax: int, dtype):
    return _get(build_glm_step, "single", glm, X, intercept, num_groups,
                qmax, dtype)


def get_glm_chunk_step(glm, X, intercept: bool, num_groups: int, qmax: int,
                       dtype):
    return _get(build_glm_chunk_step, "chunk", glm, X, intercept, num_groups,
                qmax, dtype)


def _get(builder, tag, glm, X, intercept, num_groups, qmax, dtype):
    try:
        key = (tag, id(glm), X.structure_key(), bool(intercept),
               int(num_groups), int(qmax), jnp.dtype(dtype).name)
    except Exception:
        return builder(glm, X, intercept, num_groups, qmax, dtype)
    hit = _GLM_STEP_CACHE.get(key)
    if hit is None:
        hit = _GLM_STEP_CACHE[key] = builder(
            glm, X, intercept, num_groups, qmax, dtype
        )
    return hit
