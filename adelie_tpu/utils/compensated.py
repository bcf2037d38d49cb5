"""Compensated float32 reductions (chunked Kahan accumulation).

The f32 device paths keep their big reductions in f32, so the big
reductions — the gradient ``X^T (v w)`` that drives KKT checks and the
screen Gram ``Xs^T diag(w) Xs`` that drives CD — carry an accumulation
error that grows with ``n`` and keeps f32 paths from reaching the
reference's f64-calibrated tolerances (reference solves at tol=1e-7 in
double, adelie/solver.py:366-377).

This module attacks the dominant error term, sequential accumulation over
the observation axis, with an error-free-transform scheme that stays in
matmuls:

- the n axis is split into chunks; each chunk's contribution is one
  ``Precision.HIGHEST`` matmul (full matmul throughput, per-chunk error
  bounded by the chunk length, not n);
- chunk partials are combined with Kahan compensated summation
  (`two_sum` error-free transforms inside a ``lax.scan``), so the
  cross-chunk accumulation contributes O(eps) instead of O((n/c) eps).

Net effect: worst-case accumulated rounding drops by ~n/chunk (e.g. 100k
observations / 4096-chunk ~ 24x; in practice 1-2 digits). Enabled by
``configs.compensated_reductions`` — see `adelie_tpu.configs`.

No reference counterpart (the reference simply computes in f64);
this is the device-native answer to the same accuracy requirement.
"""

import functools

import jax
import jax.numpy as jnp

_PRECISION = jax.lax.Precision.HIGHEST


def two_sum(a, b):
    """Error-free transform: returns (s, e) with s = fl(a+b), s + e == a + b.

    Knuth's branch-free TwoSum; exact for any a, b (no magnitude ordering
    assumed), elementwise on arrays.
    """
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def kahan_sum(parts, axis=0):
    """Sum ``parts`` along ``axis`` with Kahan compensation via lax.scan."""
    parts = jnp.moveaxis(parts, axis, 0)

    def body(carry, x):
        s, c = carry
        y = x + c          # fold running compensation into the addend
        s, e = two_sum(s, y)
        return (s, e), None

    zero = jnp.zeros(parts.shape[1:], parts.dtype)
    (s, c), _ = jax.lax.scan(body, (zero, zero), parts)
    return s + c


def _chunk(n, chunk):
    chunk = max(int(chunk), 1)
    if n <= chunk:
        return 1, n
    k = -(-n // chunk)
    return k, chunk


def _split(a):
    """Dekker split: a == hi + lo exactly, hi carries the top 12 mantissa
    bits (so products of hi/lo pieces of two f32 values are exact in f32)."""
    c = a * jnp.asarray(4097.0, a.dtype)  # 2^12 + 1
    hi = c - (c - a)
    return hi, a - hi


def _two_product(a, b):
    """Error-free product: returns (p, e) with p = fl(a*b), p + e == a*b."""
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def _pairwise_compensated_colsum(P):
    """Sum ``P`` (c, p) over axis 0 with pairwise two_sum compensation.

    log2(c) vectorized halving levels; every addition's rounding error is
    captured and folded back, so the result carries O(eps) error instead of
    O(c eps) (second-order error terms are O(c eps^2), negligible).
    Returns (s, e): the f32 pairwise sum and the accumulated correction.
    """
    err = jnp.zeros(P.shape[1:], P.dtype)
    while P.shape[0] > 1:
        if P.shape[0] % 2:
            P = jnp.concatenate([P, jnp.zeros_like(P[:1])], axis=0)
        s, e = two_sum(P[0::2], P[1::2])
        err = err + jnp.sum(e, axis=0)
        P = s
    return P[0], err


@functools.partial(jax.jit, static_argnames=("chunk",))
def mul_tn(X, v, chunk: int = 4096):
    """Dot2-quality ``X^T v`` over the leading (observation) axis.

    X: (n, p), v: (n,) -> (p,). Full compensation: elementwise products are
    error-free-transformed (Dekker ``_two_product``), per-chunk column sums
    use pairwise two_sum compensation, and cross-chunk accumulation is a
    two-float (hi, err) carry.  Result error ~ O(eps) + O(n eps^2 cond) —
    effectively f64-quality for the KKT gradient while every op stays f32
    (Ogita-Rump-Oishi Dot2; no f64 needed).
    """
    n, p = X.shape
    k, c = _chunk(n, chunk)
    pad = k * c - n
    Xp = jnp.pad(X, ((0, pad), (0, 0))).reshape(k, c, p)
    vp = jnp.pad(v, (0, pad)).reshape(k, c)

    def body(carry, xs):
        s, err = carry
        Xc, vc = xs
        P, E = _two_product(Xc, vc[:, None])
        ps, pe = _pairwise_compensated_colsum(P)
        s, e2 = two_sum(s, ps)
        err = err + (e2 + pe + jnp.sum(E, axis=0))
        return (s, err), None

    zero = jnp.zeros((p,), X.dtype)
    if k == 1:
        (s, err), _ = body((zero, zero), (Xp[0], vp[0]))
    else:
        (s, err), _ = jax.lax.scan(body, (zero, zero), (Xp, vp))
    return s + err


@functools.partial(jax.jit, static_argnames=("chunk",))
def gram_tn(Xs, w, chunk: int = 4096):
    """Compensated weighted Gram ``Xs^T diag(w) Xs`` (and weighted means).

    Xs: (n, S), w: (n,) -> (A (S, S), means (S,)). Scans n-chunks so the
    partial buffer is one (S, S) block regardless of n; Kahan-accumulates
    the running Gram and means across chunks.
    """
    n, S = Xs.shape
    k, c = _chunk(n, chunk)
    if k == 1:
        Xw = Xs * w[:, None]
        means = jnp.einsum("ns,n->s", Xs, w, precision=_PRECISION)
        A = jnp.einsum("ns,nt->st", Xs, Xw, precision=_PRECISION)
        return A, means
    pad = k * c - n
    Xp = jnp.pad(Xs, ((0, pad), (0, 0))).reshape(k, c, S)
    wp = jnp.pad(w, (0, pad)).reshape(k, c)

    def body(carry, xs):
        A, cA, m, cm = carry
        Xc, wc = xs
        partA = jnp.einsum(
            "cs,ct->st", Xc, Xc * wc[:, None], precision=_PRECISION
        )
        partm = jnp.einsum("cs,c->s", Xc, wc, precision=_PRECISION)
        A, eA = two_sum(A, partA + cA)
        m, em = two_sum(m, partm + cm)
        return (A, eA, m, em), None

    zA = jnp.zeros((S, S), Xs.dtype)
    zm = jnp.zeros((S,), Xs.dtype)
    (A, cA, m, cm), _ = jax.lax.scan(body, (zA, zA, zm, zm), (Xp, wp))
    return A + cA, m + cm


@functools.partial(jax.jit, static_argnames=("chunk",))
def cross_tn(Xs, Y, w, chunk: int = 4096):
    """Compensated cross block ``Xs^T diag(w) Y``.

    Xs: (n, S), Y: (n, D), w: (n,) -> (S, D). Used by the incremental
    screen-Gram extension.
    """
    n, S = Xs.shape
    D = Y.shape[1]
    k, c = _chunk(n, chunk)
    if k == 1:
        return jnp.einsum("ns,nd->sd", Xs, Y * w[:, None], precision=_PRECISION)
    pad = k * c - n
    Xp = jnp.pad(Xs, ((0, pad), (0, 0))).reshape(k, c, S)
    Yp = jnp.pad(Y * w[:, None], ((0, pad), (0, 0))).reshape(k, c, D)
    parts = jnp.einsum("kcs,kcd->ksd", Xp, Yp, precision=_PRECISION)
    return kahan_sum(parts, axis=0)
