"""Constraint-aware pin solver.

Extends the covariance-form CD of pin.py with per-group convex constraints
(reference: solver_gaussian_pin_naive.hpp:420-459 dispatches each group
update to ``constraint->solve``).  Constrained groups run an inline ADMM
block solve (see adelie_tpu/constraint) whose x-update reuses the same
eigenbasis Newton solver; the whole sweep — unconstrained Newton updates,
constrained ADMM updates, active-set bookkeeping — remains ONE jitted
device computation over padded buffers:

* ``A_pad``  (G, mmax, qmax): per-group constraint matrix ``A_g`` times the
  group eigenbasis ``V_g`` (i.e. ``P_g = A_g V_g``), zero on padding,
* ``DH/UH``  (G, qmax[, qmax]): eigendecomposition of
  ``H_g = diag(lam_g) + rho P_g' P_g`` — the ADMM x-update curvature,
  precomputed once per (screen-set, weights) change (lambda-independent),
* ``lo/hi``  (G, mmax): interval bounds on ``z = A_g beta_g``,
* ``mu``     (G, mmax): dual variables, carried across lambdas (the
  reference keeps ``_mu`` inside each constraint object).
"""

import functools

import jax
import jax.numpy as jnp

from ..bcd import newton_solver
from ..constraint._pn import pn_block_solve

_PRECISION = jax.lax.Precision.HIGHEST


@jax.jit
def prep_constraint_buffers(A_pad, eigvecs, eigvals, rho):
    """P = A_g V_g and eigh of H = diag(lam) + rho P'P, batched over groups."""
    P = jnp.einsum("gmq,gqr->gmr", A_pad, eigvecs, precision=_PRECISION)
    PtP = jnp.einsum("gmq,gmr->gqr", P, P, precision=_PRECISION)
    qmax = eigvals.shape[1]
    H = PtP * rho + jax.vmap(jnp.diag)(eigvals)
    DH, UH = jnp.linalg.eigh(H)
    DH = jnp.maximum(DH, 0.0)
    return P, DH, UH


def _admm_update(P, DH, UH, v_t, l1, l2, lo, hi, x0, mu0, rho,
                 cons_tol, cons_max_iters, newton_tol, newton_max_iters):
    """Inline ADMM (same math as constraint.admm_block_solve) on one group."""
    m = P.shape[0]
    d = P.shape[1]
    dtype = v_t.dtype
    sqm = jnp.sqrt(jnp.asarray(float(m), dtype))
    sqd = jnp.sqrt(jnp.asarray(float(d), dtype))

    def xupdate(z, u):
        c = v_t + rho * (P.T @ (z - u))
        ct = UH.T @ c
        xt, _ = newton_solver(DH, ct, l1, l2, newton_tol, newton_max_iters)
        return UH @ xt

    Px0 = P @ x0
    z0 = jnp.clip(Px0, lo, hi)
    u0 = mu0 / rho

    def cond(carry):
        _, _, _, it, done = carry
        return (~done) & (it < cons_max_iters)

    def body(carry):
        x, z, u, it, _ = carry
        x = xupdate(z, u)
        Px = P @ x
        z_new = jnp.clip(Px + u, lo, hi)
        u = u + Px - z_new
        r_norm = jnp.linalg.norm(Px - z_new)
        s_norm = rho * jnp.linalg.norm(P.T @ (z_new - z))
        eps_pri = sqm * cons_tol + cons_tol * jnp.maximum(
            jnp.linalg.norm(Px), jnp.linalg.norm(z_new)
        )
        eps_dual = sqd * cons_tol + cons_tol * rho * jnp.linalg.norm(P.T @ u)
        done = (r_norm <= eps_pri) & (s_norm <= eps_dual)
        return x, z_new, u, it + 1, done

    x, z, u, _, _ = jax.lax.while_loop(
        cond, body, (x0, z0, u0, jnp.zeros((), jnp.int32), jnp.zeros((), bool))
    )
    return x, rho * u


def _sweep_constrained(carry, consts, idx, n, cons_method="admm"):
    """Gauss-Seidel pass with constraint dispatch over the slots listed
    in ``idx[:n]`` (compacted, ascending — see pin._compact: iterating
    the compacted list instead of cond-skipping all G_cap slots removes
    ~12 us of while-loop machinery per skipped slot).

    ``cons_method`` (trace-time constant) selects the per-group
    constrained block solver: inline ADMM or the reference's dual
    proximal Newton (constraint/_pn.py)."""
    (A, slot_begin, slot_size, eigvals, eigvecs, penalty,
     has_cons, P_pad, DH, UH, lo_pad, hi_pad, rho,
     cons_tol, cons_max_iters,
     l1, l2, newton_tol, newton_max_iters, dbeta_tol,
     pn_slack, pn_nnls_tol, pn_nnls_max_iters,
     pn_pinball_tol, pn_pinball_max_iters, big) = consts
    beta0, grad0, is_active0, rsq0, mu0 = carry
    S = A.shape[0]
    G, qmax = eigvals.shape

    def body(k, loop_carry):
        beta, grad, is_active, rsq, mu, convg = loop_carry
        i = idx[k]
        q = slot_size[i]

        def do(args):
            beta, grad, is_active, rsq, mu, convg = args
            b = slot_begin[i]
            qf = q.astype(beta.dtype)
            mask = jnp.arange(qmax) < q
            beta_w = jax.lax.dynamic_slice(beta, (b,), (qmax,))
            beta_g = jnp.where(mask, beta_w, 0.0)
            grad_g = jnp.where(
                mask, jax.lax.dynamic_slice(grad, (b,), (qmax,)), 0.0
            )
            V = eigvecs[i]
            lam = eigvals[i]
            beta_t = V.T @ beta_g
            g_t = V.T @ grad_g
            v_t = g_t + lam * beta_t
            pk = penalty[i]

            def unconstrained(_):
                x_t, _ = newton_solver(
                    lam, v_t, l1 * pk, l2 * pk, newton_tol, newton_max_iters
                )
                return x_t, mu[i]

            def constrained(_):
                if cons_method == "proximal_newton":
                    return pn_block_solve(
                        P_pad[i], lam, eigvecs[i], v_t, l1 * pk, l2 * pk,
                        lo_pad[i], hi_pad[i], beta_t, mu[i], big,
                        tol=cons_tol, slack=pn_slack,
                        max_iters=cons_max_iters,
                        nnls_tol=pn_nnls_tol,
                        nnls_max_iters=pn_nnls_max_iters,
                        pinball_tol=pn_pinball_tol,
                        pinball_max_iters=pn_pinball_max_iters,
                        newton_tol=newton_tol,
                        newton_max_iters=newton_max_iters,
                    )
                return _admm_update(
                    P_pad[i], DH[i], UH[i], v_t, l1 * pk, l2 * pk,
                    lo_pad[i], hi_pad[i], beta_t, mu[i], rho,
                    cons_tol, cons_max_iters, newton_tol, newton_max_iters,
                )

            x_t, mu_i = jax.lax.cond(has_cons[i], constrained, unconstrained,
                                     None)
            d_t = x_t - beta_t
            dnorm2 = jnp.sum(d_t * d_t)
            thresh = jnp.where(q > 1, (dbeta_tol * dbeta_tol) * qf, 0.0)
            changed = (dnorm2 > thresh) | (has_cons[i] & (dnorm2 > 0))

            def apply(args):
                beta, grad, is_active, rsq, mu, convg = args
                convg_c = jnp.sum(lam * d_t * d_t) / qf
                convg = jnp.maximum(convg, convg_c)
                rsq = rsq + jnp.sum(d_t * (2.0 * g_t - d_t * lam))
                beta_new_g = V @ x_t
                dbeta_g = jnp.where(mask, beta_new_g - beta_g, 0.0)
                Acols = jax.lax.dynamic_slice(
                    A, (jnp.zeros((), b.dtype), b), (S, qmax)
                )
                grad = grad - Acols @ dbeta_g
                new_w = jnp.where(mask, beta_new_g, beta_w)
                beta = jax.lax.dynamic_update_slice(beta, new_w, (b,))
                is_active = is_active.at[i].set(True)
                return beta, grad, is_active, rsq, mu, convg

            beta, grad, is_active, rsq, mu, convg = jax.lax.cond(
                changed, apply, lambda a: a,
                (beta, grad, is_active, rsq, mu, convg),
            )
            mu = mu.at[i].set(mu_i)
            return beta, grad, is_active, rsq, mu, convg

        return do((beta, grad, is_active, rsq, mu, convg))

    beta, grad, is_active, rsq, mu, convg = jax.lax.fori_loop(
        0, n, body,
        (beta0, grad0, is_active0, rsq0, mu0, jnp.zeros((), beta0.dtype)),
    )
    return beta, grad, is_active, rsq, mu, convg


@functools.partial(jax.jit, static_argnames=("cons_method", "pn_nnls_max_iters", "pn_pinball_max_iters"))
def pin_cov_solve_constrained(
    A,
    grad,
    beta,
    slot_begin,
    slot_size,
    eigvals,
    eigvecs,
    penalty,
    is_active,
    has_cons,
    P_pad,
    DH,
    UH,
    lo_pad,
    hi_pad,
    mu,
    rho,
    cons_tol,
    cons_max_iters,
    lmda,
    alpha,
    tol,
    dbeta_tol,
    newton_tol,
    newton_max_iters,
    max_iters,
    rsq,
    cons_method: str = "admm",
    pn_slack=1e-4,
    pn_nnls_tol=1e-7,
    pn_nnls_max_iters=100000,
    pn_pinball_tol=1e-7,
    pn_pinball_max_iters=100000,
):
    """Constraint-aware variant of pin.pin_cov_solve.

    Returns (beta, grad, is_active, rsq, mu, iters, converged).
    """
    dtype = beta.dtype
    l1 = lmda * alpha
    l2 = lmda * (1.0 - alpha)

    # Dtype-feasibility floors.  The defaults (cons_tol=1e-9) are f64
    # values: in f32 the ADMM residuals plateau around eps, so every inner
    # solve would burn its full cons_max_iters budget, and the CD energy
    # criterion stagnates at ~lam*(ADMM noise)^2 — the sweep loop then
    # grinds until an external watchdog kills the device program (observed
    # on constrained multinomial fits).
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    cons_tol = jnp.maximum(cons_tol, 10.0 * eps)
    lam_max = jnp.maximum(jnp.max(jnp.abs(eigvals)), 1.0)
    tol = jnp.maximum(tol, 100.0 * lam_max * (10.0 * eps) ** 2)

    pn_nnls_tol = jnp.maximum(jnp.asarray(pn_nnls_tol, dtype), 10.0 * eps)
    pn_pinball_tol = jnp.maximum(
        jnp.asarray(pn_pinball_tol, dtype), 10.0 * eps
    )
    big = jnp.asarray(jnp.finfo(dtype).max, dtype) * 0.25
    consts = (A, slot_begin, slot_size, eigvals, eigvecs, penalty,
              has_cons, P_pad, DH, UH, lo_pad, hi_pad, rho,
              cons_tol, cons_max_iters,
              l1, l2, newton_tol, newton_max_iters, dbeta_tol,
              jnp.asarray(pn_slack, dtype), pn_nnls_tol,
              pn_nnls_max_iters, pn_pinball_tol, pn_pinball_max_iters, big)

    # Floor-gated stall (see pin.py): the achievable CD plateau is set by
    # the inner constrained-solver noise (~cons_tol per coordinate) as well
    # as the dtype eps, so the floor accounts for both.  Above the floor,
    # slow problems run to tol or max_iters (honest failure).
    stall_floor = lam_max * jnp.maximum(
        1e8 * eps * eps, 1e6 * cons_tol * cons_tol
    )

    def _slow_count(slow, convg, prev):
        return jnp.where(convg >= 0.99 * prev, slow + 1,
                         jnp.zeros((), jnp.int32))

    def _is_stalled(slow, convg):
        return (slow >= 3) & (convg <= stall_floor)

    from .pin import _compact

    valid = slot_size > 0
    idx_valid, n_valid = _compact(valid)

    def active_phase(state):
        beta, grad, is_active, rsq, mu, iters = state
        # the active set is fixed throughout this phase: compact once
        idx_a, n_a = _compact(is_active & valid)

        def cond(c):
            _, _, _, _, _, convg, slow, it = c
            stalled = _is_stalled(slow, convg)
            return (convg >= tol) & (it < max_iters) & (~stalled)

        def body(c):
            beta, grad, is_active, rsq, mu, prev, slow, it = c
            beta, grad, is_active, rsq, mu, convg = _sweep_constrained(
                (beta, grad, is_active, rsq, mu), consts, idx_a, n_a,
                cons_method,
            )
            return (beta, grad, is_active, rsq, mu, convg,
                    _slow_count(slow, convg, prev), it + 1)

        beta, grad, is_active, rsq, mu, convg = _sweep_constrained(
            (beta, grad, is_active, rsq, mu), consts, idx_a, n_a, cons_method
        )
        out = jax.lax.while_loop(
            cond, body,
            (beta, grad, is_active, rsq, mu, convg,
             jnp.zeros((), jnp.int32), iters + 1),
        )
        beta, grad, is_active, rsq, mu, convg, _, iters = out
        return beta, grad, is_active, rsq, mu, iters

    def outer_cond(state):
        _, _, _, _, _, convg, slow, iters, done = state
        stalled = _is_stalled(slow, convg)
        return (~done) & (iters < max_iters) & (~stalled) & ~jnp.isnan(convg)

    def outer_body(state):
        beta, grad, is_active, rsq, mu, prev, slow, iters, _ = state
        beta, grad, is_active, rsq, mu, iters = active_phase(
            (beta, grad, is_active, rsq, mu, iters)
        )
        beta, grad, is_active, rsq, mu, convg = _sweep_constrained(
            (beta, grad, is_active, rsq, mu), consts, idx_valid, n_valid,
            cons_method,
        )
        iters = iters + 1
        done = convg < tol
        return (beta, grad, is_active, rsq, mu, convg,
                _slow_count(slow, convg, prev), iters, done)

    init = (beta, grad, is_active, rsq, mu, jnp.asarray(jnp.inf, dtype),
            jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
            jnp.zeros((), bool))
    (beta, grad, is_active, rsq, mu, convg, slow, iters, done
     ) = jax.lax.while_loop(outer_cond, outer_body, init)
    # a floor-gated stall exit = converged at the numerical floor; any
    # other early exit (incl. NaN) is a genuine failure and not promoted
    done = (done | _is_stalled(slow, convg)) & ~jnp.isnan(convg)
    return beta, grad, is_active, rsq, mu, iters, done
