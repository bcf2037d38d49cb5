"""Lasso (all groups of size 1) pin solve as one Pallas kernel for the GPU.

The covariance-form coordinate descent of ``pin.pin_cov_solve`` is a
serial Gauss-Seidel chain.  Under XLA each coordinate update is one
iteration of a ``fori_loop`` holding a ``lax.cond``, and on the GPU every
such iteration costs kernel launches plus a read of the loop predicate.
This kernel runs the whole solve — active-set refinement loop included
(solver_gaussian_pin_naive.hpp:317-400) — in ONE program: the
coefficients, gradient, active flags and per-coordinate constants stay in
registers, and each update reads one Gram row from global memory (the
L2-resident rows of the active set).

Each step recomputes the soft-threshold proposal for every coordinate
(elementwise work spread over the block's threads), picks the next
coordinate past the previous one whose proposal moves it (one min
reduction), and applies that single update.  Coordinates whose update is
exactly zero are the ones the XLA loop's ``lax.cond`` skips, so the
applied updates, their order and their arithmetic are those of the XLA
path; only the per-sweep ``rsq`` sum is associated differently.

Capacity: the state lives in registers, so ``S <= MAX_KERNEL_S``; the
capacity is padded to a power of two (Triton block sizes).
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

MAX_KERNEL_S = 4096


def _num_warps(S):
    # 8-32 register-resident values per thread for each (S,) vector; 1-16
    # warps measured within ~30% of each other on the H100 (PERF.md)
    return 4 if S <= 1024 else (8 if S <= 2048 else 16)


def _pin_kernel(A_ref, diag_ref, grad_ref, beta_ref, active_ref, valid_ref,
                pen_ref, scal_ref, beta_out, grad_out, active_out, stat_out):
    S = diag_ref.shape[0]
    dtype = diag_ref.dtype
    col = jax.lax.broadcasted_iota(jnp.int32, (S,), 0)
    diag = diag_ref[...]
    valid = valid_ref[...] != 0
    pen = pen_ref[...]
    l1 = scal_ref[0]
    l2 = scal_ref[1]
    tol = scal_ref[2]
    stall_floor = scal_ref[3]
    rsq0 = scal_ref[4]
    max_iters = scal_ref[5].astype(jnp.int32)

    thr = l1 * pen
    den = diag + l2 * pen
    den_ok = den > 0
    den_safe = jnp.where(den_ok, den, 1.0)
    zero = jnp.zeros((S,), dtype)

    def proposal(beta, grad):
        u = grad + diag * beta
        mag = jnp.maximum(jnp.abs(u) - thr, 0.0)
        return jnp.where(den_ok, jnp.sign(u) * mag / den_safe, beta)

    def next_update(beta, grad, sel, prev):
        bnew = proposal(beta, grad)
        cand = sel & (bnew != beta) & (col > prev)
        p = jnp.min(jnp.where(cand, col, S))
        return p, bnew

    def row(p):
        return A_ref[jnp.minimum(p, S - 1), :]   # A is symmetric

    def sweep(beta, grad, active, rsq, active_only):
        sel = valid & (active != 0) if active_only else valid
        p, bnew = next_update(beta, grad, sel, -1)

        def cond(c):
            return c[0] < S

        def body(c):
            p, bnew, a_row, beta, grad, active, racc, cacc = c
            onehot = col == p
            d = jnp.sum(jnp.where(onehot, bnew - beta, zero))
            racc = racc + jnp.where(onehot, d * (2.0 * grad - d * diag), zero)
            cacc = jnp.maximum(cacc, jnp.where(onehot, diag * d * d, zero))
            grad = grad - d * a_row
            beta = jnp.where(onehot, bnew, beta)
            active = jnp.where(onehot, 1.0, active)
            p, bnew = next_update(beta, grad, sel, p)
            return p, bnew, row(p), beta, grad, active, racc, cacc

        _, _, _, beta, grad, active, racc, cacc = jax.lax.while_loop(
            cond, body, (p, bnew, row(p), beta, grad, active, zero, zero))
        return beta, grad, active, rsq + jnp.sum(racc), jnp.max(cacc)

    def slow_count(slow, convg, prev):
        return jnp.where(convg >= 0.99 * prev, slow + 1, 0)

    def stalled(slow, convg):
        return (slow >= 3) & (convg <= stall_floor)

    def active_phase(beta, grad, active, rsq, it):
        beta, grad, active, rsq, convg = sweep(beta, grad, active, rsq, True)

        def cond(c):
            convg, slow, it = c[4], c[5], c[6]
            return (convg >= tol) & (it < max_iters) & ~stalled(slow, convg)

        def body(c):
            beta, grad, active, rsq, prev, slow, it = c
            beta, grad, active, rsq, convg = sweep(
                beta, grad, active, rsq, True)
            return (beta, grad, active, rsq, convg,
                    slow_count(slow, convg, prev), it + 1)

        beta, grad, active, rsq, _, _, it = jax.lax.while_loop(
            cond, body,
            (beta, grad, active, rsq, convg, jnp.int32(0), it + 1))
        return beta, grad, active, rsq, it

    def outer_cond(c):
        convg, slow, it, done = c[4], c[5], c[6], c[7]
        return ((done == 0) & (it < max_iters) & ~stalled(slow, convg)
                & ~jnp.isnan(convg))

    def outer_body(c):
        beta, grad, active, rsq, prev, slow, it, _ = c
        beta, grad, active, rsq, it = active_phase(beta, grad, active, rsq, it)
        beta, grad, active, rsq, convg = sweep(beta, grad, active, rsq, False)
        return (beta, grad, active, rsq, convg,
                slow_count(slow, convg, prev), it + 1,
                (convg < tol).astype(jnp.int32))

    beta, grad, active, rsq, convg, slow, it, done = jax.lax.while_loop(
        outer_cond, outer_body,
        (beta_ref[...], grad_ref[...], active_ref[...], rsq0,
         jnp.asarray(jnp.inf, dtype), jnp.int32(0), jnp.int32(0),
         jnp.int32(0)))
    # a floor-gated stall exit is convergence at the dtype's numerical
    # floor; any other early exit (incl. NaN) is a genuine failure
    done = ((done != 0) | stalled(slow, convg)) & ~jnp.isnan(convg)

    beta_out[...] = beta
    grad_out[...] = grad
    active_out[...] = active
    lane = jax.lax.broadcasted_iota(jnp.int32, (8,), 0)
    stat_out[...] = jnp.where(
        lane == 0, rsq,
        jnp.where(lane == 1, it.astype(dtype),
                  jnp.where(lane == 2, done.astype(dtype), 0.0)))


@functools.partial(jax.jit, static_argnames=("interpret",))
def pin_lasso_solve(A, grad, beta, diag, valid, active, penalty,
                    l1, l2, tol, stall_floor, max_iters, rsq,
                    interpret: bool = False):
    """Lasso pin solve over positions ``0..S-1`` of the (S, S) Gram ``A``.

    ``diag``/``penalty`` are per position; ``valid``/``active`` boolean
    masks.  ``tol`` and ``stall_floor`` are the already-floored values of
    ``pin.pin_cov_solve``.  Returns (beta, grad, active, rsq, iters, done).
    """
    S = A.shape[0]
    dtype = A.dtype
    Sk = max(16, pl.next_power_of_2(S))
    if Sk != S:
        pad = Sk - S
        A = jnp.pad(A, ((0, pad), (0, pad)))
        grad, beta, diag, penalty = (jnp.pad(v, (0, pad))
                                     for v in (grad, beta, diag, penalty))
        valid, active = (jnp.pad(v, (0, pad)) for v in (valid, active))
    scal = jnp.stack([
        jnp.asarray(x, dtype) for x in
        (l1, l2, tol, stall_floor, rsq, max_iters, 0.0, 0.0)])
    vec = jax.ShapeDtypeStruct((Sk,), dtype)
    beta2, grad2, active2, stat = pl.pallas_call(
        _pin_kernel,
        out_shape=(vec, vec, vec, jax.ShapeDtypeStruct((8,), dtype)),
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(Sk), num_stages=1),
        interpret=interpret,
        name="pin_lasso_solve",
    )(A, diag.astype(dtype), grad.astype(dtype), beta.astype(dtype),
      active.astype(dtype), valid.astype(dtype), penalty.astype(dtype), scal)
    return (beta2[:S], grad2[:S], active2[:S] != 0, stat[0],
            stat[1].astype(jnp.int32), stat[2] != 0)
