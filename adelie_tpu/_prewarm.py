"""Ahead-of-time compile warming for known problem signatures.

Cold start on a fresh process is dominated by XLA compilation of the
fused lambda-chunk programs — one compile per screen-capacity bucket the
path visits.  ``prewarm`` drives those exact jitted programs once per bucket
with zero-filled buffers of the right shapes (``valid`` all-False, so the
scan skips every lambda and execution is ~free), which

* populates the in-process jit cache — the first real fit in THIS
  process pays no compiles for warmed buckets, and
* serializes every compiled executable into the persistent compilation
  cache (enabled at import, ``adelie_tpu/__init__.py``) — a SECOND
  process skips XLA entirely for the same signatures.

The compile key depends only on shapes/dtypes + static flags, never on
data, so a deployment can warm once (e.g. in CI or at image build) for
its (n, p, groups, dtype) signature and serve cold fits at warm speed.

Scope: the gaussian fast path (fused in-HBM chunk step and the
host-streamed chunk step + streamed-KKT programs).  GLM/IRLS programs
compile on first use as before.
"""

import numpy as np

import jax
import jax.numpy as jnp

from .configs import f32_contractions
from .utils import Stopwatch, bucket, bucket_pow2


def _bucket_pairs(group_sizes, max_screen, screen_cap_min, group_cap_min):
    """(S_cap, G_cap, qmax) bucket ladder a growing screen set visits.

    Mirrors ScreenCache.rebuild_structure: S_cap = bucket(S_val + qmax),
    G_cap = bucket(n_screen_groups).  Screen growth is data-dependent, so
    the ladder is generated from the mean group size; unwarmed buckets
    simply compile on demand."""
    gs = np.asarray(group_sizes)
    qmax = bucket_pow2(int(gs.max()))
    mean_q = float(gs.mean())
    pairs = []
    s_groups = 1
    while True:
        s_groups = min(s_groups, len(gs))
        # sample both sides of each capacity step (s and s+1): sizes just
        # past a bucket boundary produce (S_cap, G_cap) combinations the
        # power-of-two samples alone would skip
        for s in (s_groups, min(s_groups + 1, len(gs))):
            S_val = int(round(mean_q * s))
            S_cap = bucket(S_val + qmax, screen_cap_min)
            G_cap = bucket(s, group_cap_min)
            pairs.append((S_cap, G_cap, qmax))
            # the +qmax margin can push S_cap one bucket past G_cap's step
            pairs.append((bucket(S_cap + 1, screen_cap_min), G_cap, qmax))
        if s_groups >= len(gs) or int(round(mean_q * s_groups)) >= max_screen:
            break
        s_groups *= 2
    seen, out = set(), []
    for pr in pairs:
        if pr not in seen:
            seen.add(pr)
            out.append(pr)
    return out


def _zero_chunk_args(n, p, G, S_cap, G_cap, qmax, C, dtype, intercept):
    """Zero-filled (cache-shaped) argument bundle shared by both chunk
    steps.  ``valid`` is all-False so the scan body never executes."""
    z = lambda *s: jnp.zeros(s, dtype)  # noqa: E731
    return dict(
        A=z(S_cap, S_cap), Xs=z(n, S_cap), means_s=z(S_cap),
        cols_padded=jnp.full((S_cap,), -1, jnp.int32),
        slot_begin=jnp.zeros((G_cap,), jnp.int32),
        slot_size=jnp.zeros((G_cap,), jnp.int32),
        eigvals=jnp.ones((G_cap, qmax), dtype),
        eigvecs=jnp.ones((G_cap, qmax, qmax), dtype),
        penalty_slots=jnp.ones((G_cap,), dtype),
        beta0=z(S_cap), active0=jnp.zeros((G_cap,), bool),
        resid=z(n), w=z(n), X_means=z(p),
        group_ids=jnp.zeros((p,), jnp.int32),
        penalty_cols=jnp.ones((p,), dtype),
        penalty_groups=jnp.ones((G,), dtype),
        screen_mask=jnp.zeros((G,), bool),
        lmdas=jnp.ones((C,), dtype), valid=jnp.zeros((C,), bool),
        alpha=jnp.asarray(1.0, dtype), tol=jnp.asarray(1e-7, dtype),
        dbeta_tol=jnp.asarray(1e-12, dtype),
        newton_tol=jnp.asarray(1e-12, dtype),
        newton_max_iters=jnp.asarray(10, jnp.int32),
        max_iters=jnp.asarray(1, jnp.int32),
        rsq0=jnp.asarray(0.0, dtype),
        y_var=jnp.asarray(1.0, dtype), adev_tol=jnp.asarray(0.9, dtype),
        ddev_tol=jnp.asarray(0.0, dtype),
        early=jnp.asarray(False), prev_dev=jnp.asarray(0.0, dtype),
        have_prev=jnp.asarray(False),
        budget=jnp.asarray(1, jnp.int32),
        intercept_on=jnp.asarray(bool(intercept)),
    )


# traced under the same default matmul precision as the fits it warms:
# that context is part of every jit cache key
@f32_contractions
def prewarm(
    X=None,
    *,
    n=None,
    p=None,
    groups=None,
    dtype=np.float32,
    intercept: bool = True,
    max_screen: int = 512,
    lmda_chunk: int = 100,
    verbose: bool = False,
):
    """Compile the gaussian-path device programs for a problem signature.

    Pass either a constructed matrix ``X`` (dense / SNP / streamed — its
    exact payload shapes are used) or plain ``n``/``p`` (a dense
    signature is assumed).  Returns a dict of per-bucket compile times.
    """
    from .configs import configs
    from .solver.fused import get_gaussian_chunk_step
    from .solver.streamed import (
        get_streamed_chunk_step, kkt_finalize, residual_stack,
    )

    if X is None:
        if n is None or p is None:
            raise ValueError("prewarm needs either X or both n= and p=")
        from . import matrix as mx

        X = mx.dense(np.zeros((int(n), int(p)), dtype))
    n, p = X.rows(), X.cols()
    dtype = np.dtype(getattr(X, "dtype", dtype))
    if groups is None:
        groups = np.arange(p)
    groups = np.asarray(groups, int)
    group_sizes = np.diff(np.concatenate([groups, [p]])).astype(int)
    G = len(groups)
    C = int(lmda_chunk)

    pairs = _bucket_pairs(
        group_sizes, min(int(max_screen), G),
        configs.screen_cap_min, configs.group_cap_min,
    )
    timings = {}
    streamed = bool(getattr(X, "is_streaming", False))
    if streamed:
        step = get_streamed_chunk_step()
        # the mul_many tile program's compile key is bucket-INDEPENDENT
        # (the tile and (C, n) shapes never change), so sweep the packed
        # bytes once here rather than once per bucket pair
        Gf_shared = X.mul_many(jnp.zeros((C, n), np.dtype(dtype)))
        jax.block_until_ready(Gf_shared)
    else:
        step = get_gaussian_chunk_step(X, bool(intercept), G)
        X_data = X.mul_spec()[1]

    for (S_cap, G_cap, qmax) in pairs:
        sw = Stopwatch().start()
        a = _zero_chunk_args(n, p, G, S_cap, G_cap, qmax, C, dtype, intercept)
        if streamed:
            out = step(
                a["A"], a["Xs"], a["means_s"],
                a["slot_begin"], a["slot_size"], a["eigvals"], a["eigvecs"],
                a["penalty_slots"], a["beta0"], a["active0"],
                a["resid"], a["w"], a["lmdas"], a["valid"],
                a["alpha"], a["tol"], a["dbeta_tol"], a["newton_tol"],
                a["newton_max_iters"], a["max_iters"], a["rsq0"],
                a["y_var"], a["adev_tol"], a["ddev_tol"], a["early"],
                a["prev_dev"], a["have_prev"], a["budget"], a["intercept_on"],
            )
            jax.block_until_ready(out[0][0])
            # streamed-KKT programs for this bucket
            U, rs = residual_stack(a["resid"], a["Xs"],
                                   jnp.zeros((C, S_cap), dtype), a["beta0"],
                                   a["w"])
            fin = kkt_finalize(
                Gf_shared, a["X_means"], rs, a["lmdas"], a["alpha"],
                a["penalty_cols"], jnp.zeros((C, S_cap), dtype),
                a["cols_padded"], a["group_ids"], a["penalty_groups"],
                a["screen_mask"], G, bool(intercept),
            )
            jax.block_until_ready(fin[1])
        else:
            out = step(
                X_data,
                a["A"], a["Xs"], a["means_s"], a["cols_padded"],
                a["slot_begin"], a["slot_size"], a["eigvals"], a["eigvecs"],
                a["penalty_slots"], a["beta0"], a["active0"],
                a["resid"], a["w"], a["X_means"],
                a["group_ids"], a["penalty_cols"], a["penalty_groups"],
                a["screen_mask"], a["lmdas"], a["valid"],
                a["alpha"], a["tol"], a["dbeta_tol"], a["newton_tol"],
                a["newton_max_iters"], a["max_iters"], a["rsq0"],
                a["y_var"], a["adev_tol"], a["ddev_tol"], a["early"],
                a["prev_dev"], a["have_prev"], a["budget"],
            )
            jax.block_until_ready(out[0][0])
        timings[f"S{S_cap}_G{G_cap}_q{qmax}"] = round(sw.elapsed(), 3)
        if verbose:
            print(f"prewarm bucket S={S_cap} G={G_cap} qmax={qmax}: "
                  f"{timings[f'S{S_cap}_G{G_cap}_q{qmax}']:.1f}s")
    return timings
