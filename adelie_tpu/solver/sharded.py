"""Sharded one-lambda fit step — the multi-chip compute path.

This is the full per-lambda device computation of the gaussian path solver
(Gram + batched eigh + covariance-form CD + residual/gradient invariance)
expressed as one jittable function over a row-sharded design block.  Under a
``jax.sharding.Mesh`` with the observation axis sharded, XLA inserts
all-reduce collectives for the three contractions (Gram ``Xs^T W Xs``, full
gradient ``X^T W r``, residual update) — the device-native replacement for the
reference's OpenMP row-blocked kernels (matrix/utils.hpp, SURVEY.md 2.12).
"""

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .pin import pin_cov_solve, screen_eigh, screen_gram

_PRECISION = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("intercept", "qmax"))
def fit_lambda_step(
    X,            # (n, p) full design, row-sharded
    Xs,           # (n, S) gathered screen block, row-sharded
    resid,        # (n,)   row-sharded
    w,            # (n,)   row-sharded
    beta_s,       # (S,)   replicated
    is_active,    # (G,)   replicated
    slot_begin, slot_size, penalty_slots,
    lmda, alpha, tol, dbeta_tol, newton_tol,
    newton_max_iters, max_iters, rsq,
    intercept: bool,
    qmax: int,
):
    """One full lambda iteration: returns (beta, is_active, rsq, resid, grad,
    resid_sum, iters, done)."""
    A, means_s = screen_gram(Xs, w, intercept)
    eigvals, eigvecs = screen_eigh(A, slot_begin, slot_size, qmax)
    resid_sum0 = jnp.vdot(w, resid, precision=_PRECISION)
    grad_s = jnp.einsum("ns,n->s", Xs, w * resid, precision=_PRECISION)
    if intercept:
        grad_s = grad_s - means_s * resid_sum0

    beta, grad_s_new, is_active, rsq, iters, done = pin_cov_solve(
        A, grad_s, beta_s, slot_begin, slot_size, eigvals, eigvecs,
        penalty_slots, is_active, lmda, alpha, tol, dbeta_tol,
        newton_tol, newton_max_iters, max_iters, rsq,
    )

    dbeta = beta - beta_s
    resid = resid - jnp.matmul(Xs, dbeta, precision=_PRECISION)
    resid_sum = jnp.vdot(w, resid, precision=_PRECISION)

    # invariance: full centered gradient
    grad = jnp.einsum("n,np->p", w * resid, X, precision=_PRECISION)
    if intercept:
        X_means = jnp.einsum("n,np->p", w, X, precision=_PRECISION)
        grad = grad - resid_sum * X_means

    return beta, is_active, rsq, resid, grad, resid_sum, iters, done


def shard_step_inputs(mesh, X, Xs, resid, w):
    """Place the O(n) operands row-sharded on the mesh."""
    axis = mesh.axis_names[0]
    row = NamedSharding(mesh, P(axis))
    row2 = NamedSharding(mesh, P(axis, None))
    return (
        jax.device_put(X, row2),
        jax.device_put(Xs, row2),
        jax.device_put(resid, row),
        jax.device_put(w, row),
    )
