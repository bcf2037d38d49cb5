"""Screen-set ("pin") solver — coordinate descent in covariance form.

Accelerator re-design of the reference's pin solvers
(``solver_gaussian_pin_naive.hpp:26-400`` and ``solver_gaussian_pin_cov.hpp``):

The reference's *naive* CD touches an O(n) residual for every group update.
Here we instead gather the screened columns into a dense block ``X_s``
once per screen-set change, form its weighted, centered Gram

    A = X_s^T diag(w) X_s - xbar_s xbar_s^T        (one matmul)

and run Gauss-Seidel CD entirely in covariance form: each group update is
O(S q) against device-resident data, with **zero** O(n) work inside the hot
loop.  The O(n) pieces (Gram, residual reconstruction, full-gradient
invariance) become three large sharded matmuls per lambda.  The two forms
are algebraically identical: with centered gradient ``g = X~^T W r`` the
naive identity ``g = v - A beta`` holds exactly, so convergence behavior,
iterate sequence, and the rsq/convergence bookkeeping
(solver_gaussian_pin_base.hpp:100-183) all match the reference.

Dynamic screen/active sets become fixed-capacity masked buffers
(capacities bucketed to bound recompiles); the group sweep is a
``lax.fori_loop`` whose body predicates on slot validity/activeness, and the
whole pin solve (active-set refinement loop included,
solver_gaussian_pin_naive.hpp:181-400) is ONE jitted device computation.
"""

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..bcd import newton_solver
from .pin_triton import MAX_KERNEL_S, pin_lasso_solve

_PRECISION = jax.lax.Precision.HIGHEST

# Past this screen capacity the q = 1 XLA loop filters its full sweeps
# (``_full_sweep_q1``) instead of visiting every screened slot.
FILTERED_SWEEP_MIN_S = 1024


# --------------------------------------------------------------------------- #
# screen-set derived quantities                                                #
# --------------------------------------------------------------------------- #


def screen_gram(Xs, w, intercept: bool):
    """Weighted (optionally centered) Gram of the gathered screen block.

    ``Xs`` is (n, S) with zero-padded columns; returns (A, means) where
    ``A = Xs^T diag(w) Xs - means means^T`` (reference
    solver_gaussian_naive.hpp:53-133 computes this per group + eigh; here one
    matmul for the whole screen set).  Assumes sum(w) == 1 when
    ``intercept`` (reference normalizes weights, solver.py).

    With ``configs.compensated_reductions`` the contraction runs through the
    chunked-Kahan path (utils/compensated.py) — the flag is read at trace
    time, consistent with the configs contract.  Mesh-sharded blocks skip
    the compensated path: its lax.scan over observation chunks would force
    GSPMD to gather the sharded axis on every Gram recompute (the same
    gate dense.mul_spec applies).
    """
    from ..configs import configs

    try:
        sharded = len(Xs.devices()) > 1
    except Exception:
        sharded = False
    if configs.compensated_reductions and not sharded:
        return _screen_gram_comp(
            Xs, w, intercept, int(configs.compensated_chunk)
        )
    return _screen_gram_plain(Xs, w, intercept)


@functools.partial(jax.jit, static_argnames=("intercept",))
def _screen_gram_plain(Xs, w, intercept: bool):
    # configs.matmul_precision governs the Gram contraction (see
    # configs.py); read at trace time per the configs contract.
    from ..configs import matmul_precision_value

    prec = matmul_precision_value()
    Xw = Xs * w[:, None]
    means = jnp.einsum("ns,n->s", Xs, w, precision=prec)
    A = jnp.einsum("ns,nt->st", Xs, Xw, precision=prec)
    if intercept:
        A = A - jnp.outer(means, means)
    return A, means


@functools.partial(jax.jit, static_argnames=("intercept", "chunk"))
def _screen_gram_comp(Xs, w, intercept: bool, chunk: int):
    from ..utils import compensated

    A, means = compensated.gram_tn(Xs, w, chunk=chunk)
    if intercept:
        A = A - jnp.outer(means, means)
    return A, means


@jax.jit
def insert_cols(Xs, Xnew, s_old):
    """Splice newly gathered screen columns into the padded block at the
    (traced) old S_val offset; one compile per (cap, dS_pad) shape pair."""
    return jax.lax.dynamic_update_slice(
        Xs, Xnew, (jnp.zeros((), jnp.int32), s_old.astype(jnp.int32))
    )


def screen_gram_extend(A_pad, Xs, Xnew, w, means_pad, s_old, intercept: bool):
    """Incrementally extend the screen Gram after screen-set growth.

    The BASIL screen set only ever grows by appending groups
    (``extend_screen_set``), so the old Gram is the leading principal block
    of the new one.  Instead of recomputing the full (S, S) Gram (one
    S^2 n matmul — the dominant non-CD cost late in the path), compute
    only the new cross block ``Xs^T diag(w) Xnew`` (S x dS, cost S dS n)
    and scatter it into the padded buffers.  ``A_pad``/``means_pad`` are
    already padded to the new capacities with the old values in their
    leading block; ``Xs`` already contains the new columns (insert_cols);
    ``Xnew`` is the (n, dS_pad) zero-padded buffer of the new columns and
    ``s_old`` the (traced) old S_val offset.

    Returns (A, means) identical (up to f.p. association) to a full
    ``screen_gram`` over the extended block.
    """
    from ..configs import configs

    if configs.compensated_reductions:
        return _screen_gram_extend_impl(
            A_pad, Xs, Xnew, w, means_pad, s_old, intercept,
            int(configs.compensated_chunk),
        )
    return _screen_gram_extend_impl(
        A_pad, Xs, Xnew, w, means_pad, s_old, intercept, 0
    )


@functools.partial(jax.jit, static_argnames=("intercept", "chunk"))
def _screen_gram_extend_impl(
    A_pad, Xs, Xnew, w, means_pad, s_old, intercept: bool, chunk: int
):
    zero = jnp.zeros((), jnp.int32)
    s_old = s_old.astype(jnp.int32)
    if chunk > 0:
        from ..utils import compensated

        means_new = compensated.mul_tn(Xnew, w, chunk=chunk)
        cross = compensated.cross_tn(Xs, Xnew, w, chunk=chunk)
    else:
        from ..configs import matmul_precision_value

        prec = matmul_precision_value()
        means_new = jnp.einsum("nd,n->d", Xnew, w, precision=prec)
        cross = jnp.einsum(
            "ns,nd->sd", Xs, Xnew * w[:, None], precision=prec
        )
    means = jax.lax.dynamic_update_slice(means_pad, means_new, (s_old,))
    if intercept:
        cross = cross - means[:, None] * means_new[None, :]
    A = jax.lax.dynamic_update_slice(A_pad, cross, (zero, s_old))
    A = jax.lax.dynamic_update_slice(A, cross.T, (s_old, zero))
    return A, means


@functools.partial(jax.jit, static_argnames=("qmax",))
def screen_eigh(A, slot_begin, slot_size, qmax: int):
    """Batched eigendecomposition of the per-group diagonal blocks of A.

    Replaces the reference's per-group ``SelfAdjointEigenSolver`` loop
    (solver_gaussian_naive.hpp:113) with one batched ``jnp.linalg.eigh`` over
    zero-padded (qmax, qmax) blocks.  Padding lanes produce eigenvalue 0 with
    padding-subspace eigenvectors, which the masked BCD update treats as
    inert.  Negative eigenvalues are clamped to 0 (reference :127-131).
    """
    S = A.shape[0]

    def get_block(b, q):
        blk = jax.lax.dynamic_slice(A, (b, b), (qmax, qmax))
        mask = jnp.arange(qmax) < q
        m2 = mask[:, None] & mask[None, :]
        return jnp.where(m2, blk, 0.0)

    blocks = jax.vmap(get_block)(slot_begin, slot_size)
    if qmax == 1:
        lam = jnp.maximum(blocks[:, :, 0], 0.0)
        V = jnp.ones_like(blocks)
        return lam, V
    lam, V = jnp.linalg.eigh(blocks)
    lam = jnp.maximum(lam, 0.0)
    return lam, V


# --------------------------------------------------------------------------- #
# the CD kernel                                                                #
# --------------------------------------------------------------------------- #


def _compact(mask):
    """Ascending indices of True slots + their count (static shapes: the
    index buffer keeps length G; entries past the count are never read).

    Sweeping over the COMPACTED index list instead of cond-skipping all G
    slots is the difference between O(n_active) and O(G_cap) sequential
    fori iterations per active-set pass — on LD-structured designs the
    screen set can hold ~30x as many groups as the active set.  Visit
    order is unchanged (ascending), so iterates are bit-identical to the
    cond-skip formulation."""
    idx = jnp.nonzero(mask, size=mask.shape[0], fill_value=0)[0]
    return idx, jnp.sum(mask).astype(jnp.int32)


def _sweep(carry, consts, plan):
    """One Gauss-Seidel pass over the slots listed in ``plan`` (reference
    coordinate_descent, solver_gaussian_pin_naive.hpp:26-168, in cov
    form).

    carry: (beta, grad, is_active, rsq)
    returns: (beta, grad, is_active, rsq, convg)
    """
    (A, slot_begin, slot_size, eigvals, eigvecs, penalty,
     l1, l2, newton_tol, newton_max_iters, dbeta_tol) = consts
    beta0, grad0, is_active0, rsq0 = carry
    S = A.shape[0]
    G, qmax = eigvals.shape
    idx, n = plan[0], plan[1]

    if qmax == 1:
        return _sweep_q1(carry, consts, plan)

    def body(k, loop_carry):
        beta, grad, is_active, rsq, convg = loop_carry
        i = idx[k]
        q = slot_size[i]

        def do(args):
            beta, grad, is_active, rsq, convg = args
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
            beta_t = jnp.matmul(V.T, beta_g, precision=_PRECISION)
            g_t = jnp.matmul(V.T, grad_g, precision=_PRECISION)
            v_t = g_t + lam * beta_t
            pk = penalty[i]
            x_t, _ = newton_solver(
                lam, v_t, l1 * pk, l2 * pk, newton_tol, newton_max_iters
            )
            d_t = x_t - beta_t
            dnorm2 = jnp.sum(d_t * d_t)
            # skip-threshold: exact zero for q==1, dbeta_tol*sqrt(q) else
            # (reference :97 'if (ak_old == ak) continue' / :145 dbeta_tol)
            thresh = jnp.where(q > 1, (dbeta_tol * dbeta_tol) * qf, 0.0)
            changed = dnorm2 > thresh

            def apply(args):
                beta, grad, is_active, rsq, convg = args
                convg_c = jnp.sum(lam * d_t * d_t) / qf
                convg = jnp.maximum(convg, convg_c)
                rsq = rsq + jnp.sum(d_t * (2.0 * g_t - d_t * lam))
                beta_new_g = jnp.matmul(V, x_t, precision=_PRECISION)
                dbeta_g = jnp.where(mask, beta_new_g - beta_g, 0.0)
                Acols = jax.lax.dynamic_slice(A, (jnp.zeros((), b.dtype), b), (S, qmax))
                grad = grad - jnp.matmul(Acols, dbeta_g,
                                         precision=_PRECISION)
                new_w = jnp.where(mask, beta_new_g, beta_w)
                beta = jax.lax.dynamic_update_slice(beta, new_w, (b,))
                is_active = is_active.at[i].set(True)
                return beta, grad, is_active, rsq, convg

            return jax.lax.cond(changed, apply, lambda a: a,
                                (beta, grad, is_active, rsq, convg))

        return do((beta, grad, is_active, rsq, convg))

    beta, grad, is_active, rsq, convg = jax.lax.fori_loop(
        0, n, body, (beta0, grad0, is_active0, rsq0, jnp.zeros((), beta0.dtype))
    )
    return beta, grad, is_active, rsq, convg


def _sweep_q1(carry, consts, plan):
    """Lasso fast path: all groups size 1, closed-form soft threshold per
    coordinate (reference update_coordinate scalar overload,
    solver_gaussian_pin_base.hpp:181-196) — no eigvec rotation, no Newton.
    (Where the kernel table has a lasso kernel, ``pin_cov_solve`` hands
    the whole solve to it and this loop serves only S > MAX_KERNEL_S.)"""
    (A, slot_begin, slot_size, eigvals, eigvecs, penalty,
     l1, l2, newton_tol, newton_max_iters, dbeta_tol) = consts
    beta0, grad0, is_active0, rsq0 = carry
    S = A.shape[0]
    idx, n = plan[0], plan[1]

    def body(k, loop_carry):
        beta, grad, is_active, rsq, convg = loop_carry
        i = idx[k]

        def do(args):
            beta, grad, is_active, rsq, convg = args
            b = slot_begin[i]
            akk = eigvals[i, 0]
            bk = beta[b]
            gk = grad[b]
            u = gk + akk * bk
            pk = penalty[i]
            vthr = jnp.abs(u) - l1 * pk
            bnew = jnp.where(
                vthr > 0, jnp.sign(u) * vthr / (akk + l2 * pk), 0.0
            )
            d = bnew - bk

            def apply(args):
                beta, grad, is_active, rsq, convg = args
                convg = jnp.maximum(convg, akk * d * d)
                rsq = rsq + d * (2.0 * gk - d * akk)
                grad = grad - d * jax.lax.dynamic_slice(
                    A, (b, jnp.zeros((), b.dtype)), (1, S)
                )[0]
                beta = beta.at[b].set(bnew)
                is_active = is_active.at[i].set(True)
                return beta, grad, is_active, rsq, convg

            return jax.lax.cond(d != 0.0, apply, lambda a: a,
                                (beta, grad, is_active, rsq, convg))

        return do((beta, grad, is_active, rsq, convg))

    beta, grad, is_active, rsq, convg = jax.lax.fori_loop(
        0, n, body, (beta0, grad0, is_active0, rsq0, jnp.zeros((), beta0.dtype))
    )
    return beta, grad, is_active, rsq, convg


def _full_sweep_q1(carry, consts, plan_valid):
    """Screen-set sweep, q == 1: vectorize the GRADIENT phase, serialize
    only the UPDATE phase (SURVEY section 7 design stance).

    One vectorized soft-threshold proposal at the sweep-entry gradient
    selects the slots that want to move; only those run the sequential
    Gauss-Seidel pass (with fresh gradients).  A slot whose stale
    proposal is zero but would move after earlier in-sweep updates is
    caught by the NEXT full sweep — the outer loop re-sweeps until a
    pass applies no change, and a no-change pass leaves the gradient
    untouched, so stale == fresh at termination (the per-lambda KKT
    certificate still guards the final iterate).  Selection size tracks
    the ACTIVE count, so a full sweep costs one vector op plus
    O(n_active) sequential steps instead of O(n_screen) — the screen set
    can be 30x the active set on LD-structured designs."""
    (A, slot_begin, slot_size, eigvals, eigvecs, penalty,
     l1, l2, newton_tol, newton_max_iters, dbeta_tol) = consts
    beta0, grad0, is_active0, rsq0 = carry

    valid = slot_size > 0
    pos = jnp.where(valid, slot_begin, 0)
    akk = eigvals[:, 0]
    bk = jnp.where(valid, beta0[pos], 0.0)
    gk = jnp.where(valid, grad0[pos], 0.0)
    u = gk + akk * bk
    vthr = jnp.abs(u) - l1 * penalty
    denom = akk + l2 * penalty
    bnew = jnp.where(vthr > 0, jnp.sign(u) * vthr
                     / jnp.where(denom > 0, denom, 1.0), 0.0)
    sel = valid & (bnew != bk)
    return _sweep_q1(carry, consts, _compact(sel))


def _pin_lasso_kernel_dispatch(
    A, grad, beta, slot_begin, slot_size, eigvals, penalty, is_active,
    l1, l2, tol, stall_floor, max_iters, rsq, interpret,
):
    """Adapt (G_cap,)-shaped slot buffers to the (S_cap,)-positional lasso
    kernel (q == 1: one position per valid slot; invalid slots scatter out
    of bounds and are dropped)."""
    S = A.shape[0]
    m = slot_size > 0
    pos = jnp.where(m, slot_begin, S)

    def at_pos(fill, vals):
        return jnp.full((S,), fill, vals.dtype).at[pos].set(vals, mode="drop")

    beta_n, grad_n, act_n, rsq_n, iters, done = pin_lasso_solve(
        A, grad, beta, at_pos(0.0, eigvals[:, 0]),
        at_pos(False, m), at_pos(False, is_active & m),
        at_pos(1.0, penalty.astype(A.dtype)),
        l1, l2, tol, stall_floor, max_iters, rsq, interpret=interpret,
    )
    active_out = act_n[jnp.minimum(pos, S - 1)] & m
    return beta_n, grad_n, active_out, rsq_n, iters, done


@functools.partial(jax.jit, static_argnames=())
def pin_cov_solve(
    A,
    grad,
    beta,
    slot_begin,
    slot_size,
    eigvals,
    eigvecs,
    penalty,
    is_active,
    lmda,
    alpha,
    tol,
    dbeta_tol,
    newton_tol,
    newton_max_iters,
    max_iters,
    rsq,
):
    """Solve the pinned group elastic net at one lambda, entirely on device.

    Mirrors reference ``pin::naive::solve`` (solver_gaussian_pin_naive.hpp:
    317-400): alternate (a) CD over the active set until ``convg < tol``
    with (b) full screen-set sweeps that grow the active set; stop when a
    full sweep converges.  Returns (beta, grad, is_active, rsq, iters,
    converged).
    """
    dtype = beta.dtype
    l1 = lmda * alpha
    l2 = lmda * (1.0 - alpha)
    # dtype-feasibility floor + floor-gated stall detection: f64-calibrated
    # tolerances are unreachable in f32 — the CD energy criterion plateaus
    # at ~lam * (eps*|beta|)^2 and the loop would spin its full max_iters
    # budget (observed: a cox path at f32 burning 1e5 sweeps per small
    # lambda).  A stall exit requires BOTH (a) three consecutive sweeps
    # improving convg by <1% and (b) convg at the dtype floor
    # (stall_floor ~ 1e8*lam*eps^2: ~1e-6*lam in f32, ~5e-24*lam in f64 so
    # f64 never stalls spuriously).  Slow-but-convergent problems above the
    # floor keep iterating to tol or hit max_iters and surface as
    # MaxCDsError — a stall is never promoted to converged above the floor.
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    lam_max = jnp.maximum(jnp.max(jnp.abs(eigvals)), 1.0)
    tol = jnp.maximum(tol, 100.0 * lam_max * (10.0 * eps) ** 2)
    stall_floor = 1e8 * lam_max * eps * eps

    # lasso solves run as one kernel where the kernel table has one
    # (kernels.py); grouped (q > 1) solves stay on the XLA loop below
    from ..kernels import choose

    kernel = choose(dtype)
    if kernel and eigvals.shape[1] == 1 and A.shape[0] <= MAX_KERNEL_S:
        return _pin_lasso_kernel_dispatch(
            A, grad, beta, slot_begin, slot_size, eigvals, penalty,
            is_active, l1, l2, tol, stall_floor, max_iters, rsq,
            interpret=kernel == "interpret",
        )

    consts = (A, slot_begin, slot_size, eigvals, eigvecs, penalty,
              l1, l2, newton_tol, newton_max_iters, dbeta_tol)

    def _slow_count(slow, convg, prev):
        return jnp.where(convg >= 0.99 * prev, slow + 1,
                         jnp.zeros((), jnp.int32))

    def _is_stalled(slow, convg):
        return (slow >= 3) & (convg <= stall_floor)

    valid = slot_size > 0
    plan_valid = _compact(valid)

    def active_phase(state):
        beta, grad, is_active, rsq, iters = state
        # the active set is FIXED throughout this phase (active sweeps
        # only revisit already-active slots), so compact + gather once
        plan_a = _compact(is_active & valid)

        def cond(c):
            _, _, _, _, convg, slow, it = c
            stalled = _is_stalled(slow, convg)
            return (convg >= tol) & (it < max_iters) & (~stalled)

        def body(c):
            beta, grad, is_active, rsq, prev, slow, it = c
            beta, grad, is_active, rsq, convg = _sweep(
                (beta, grad, is_active, rsq), consts, plan_a)
            return (beta, grad, is_active, rsq, convg,
                    _slow_count(slow, convg, prev), it + 1)

        # always at least one active sweep (reference solve_active :181-215)
        beta, grad, is_active, rsq, convg = _sweep(
            (beta, grad, is_active, rsq), consts, plan_a)
        beta, grad, is_active, rsq, convg, _, iters = jax.lax.while_loop(
            cond, body,
            (beta, grad, is_active, rsq, convg,
             jnp.zeros((), jnp.int32), iters + 1),
        )
        return beta, grad, is_active, rsq, iters

    def outer_cond(state):
        _, _, _, _, convg, slow, iters, done = state
        stalled = _is_stalled(slow, convg)
        # a NaN-poisoned iterate fails every comparison: bail out fast
        # (done stays False -> reported as a genuine failure)
        return (~done) & (iters < max_iters) & (~stalled) & ~jnp.isnan(convg)

    # Filtered full sweeps only in the big-S regime, where O(S) sequential
    # GS passes are the wall-clock problem.  Small problems keep exact
    # Gauss-Seidel semantics: the filtered sweep's mover SELECTION
    # branches on knife-edge f32 comparisons, which lets
    # SPMD-vs-single-device reduction-order noise flip a selection and
    # perturb trajectories past the test suite's strict equality
    # tolerances.
    full_sweep = (_full_sweep_q1
                  if eigvals.shape[1] == 1 and A.shape[0] > FILTERED_SWEEP_MIN_S
                  else _sweep)

    def outer_body(state):
        beta, grad, is_active, rsq, prev, slow, iters, _ = state
        beta, grad, is_active, rsq, iters = active_phase(
            (beta, grad, is_active, rsq, iters)
        )
        beta, grad, is_active, rsq, convg = full_sweep(
            (beta, grad, is_active, rsq), consts, plan_valid
        )
        iters = iters + 1
        done = convg < tol
        return (beta, grad, is_active, rsq, convg,
                _slow_count(slow, convg, prev), iters, done)

    init = (beta, grad, is_active, rsq, jnp.asarray(jnp.inf, dtype),
            jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
            jnp.zeros((), bool))
    beta, grad, is_active, rsq, convg, slow, iters, done = jax.lax.while_loop(
        outer_cond, outer_body, init
    )
    # a floor-gated stall exit means the iterate is at the dtype's numerical
    # floor: report converged (it cannot improve further).  Any other early
    # exit (incl. NaN) is a genuine failure and is NOT promoted.
    done = (done | _is_stalled(slow, convg)) & ~jnp.isnan(convg)
    return beta, grad, is_active, rsq, iters, done
