"""Streamed gaussian path driver — BASIL over host-resident packed matrices.

The fused chunk step (``fused.py``) computes the full-p KKT gradient per
lambda *inside* the device scan, which requires the matrix payload in
HBM.  For host-streamed matrices (``matrix/_snp_stream.py``, the 25 GB
north-star GWAS case) the chunk is restructured:

1. **Optimistic fit scan** (device): fit the whole lambda chunk
   back-to-back against the HBM-resident *screened* block only — no
   full-p work, no KKT verdicts.  Emits per-lambda betas/actives/rsq.
2. **Streamed KKT** (one pass over the packed bytes): reconstruct every
   lambda's weighted residual from the emitted betas, then
   ``X.mul_many`` sweeps host tiles through the device ONCE to get the
   (p, C) gradient stack; a single jitted finalize turns it into
   per-lambda group norms and KKT verdicts.
3. **Certify + rollback** (host): accepted prefix = lambdas before the
   first KKT failure; on failure the state keeps the failed lambda's
   iterate (reference retry semantics, solver_base.hpp:605-686), the
   screen set grows from that lambda's abs_grad, and the path resumes.

Fitting optimistically wastes the post-failure fits of a chunk, but
chunk-aware screening makes failures rare (~1 per path), while the
amortization is huge: the packed bytes stream host->HBM once per chunk
instead of once per lambda.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..configs import configs
from ..exceptions import MaxCDsError, SolverError
from ..utils import Stopwatch
from .gaussian import GaussianNaiveDriver
from .glm_driver import GlmNaiveDriver
from .pin import pin_cov_solve

_PRECISION = jax.lax.Precision.HIGHEST

_STREAM_STEP_CACHE = {}


def build_streamed_chunk_step():
    """Optimistic lambda-chunk scan: per-lambda pin solves with deviance
    early exit and sweep budget, NO full-matrix gradient / KKT (those run
    streamed afterwards).  Shapes specialize at call time."""

    @jax.jit
    def chunk_step(
        A, Xs, means_s,
        slot_begin, slot_size, eigvals, eigvecs, penalty_slots,
        beta0, active0,
        resid0, w,
        lmdas, valid,
        alpha, tol, dbeta_tol, newton_tol,
        newton_max_iters, max_iters, rsq0,
        y_var, adev_tol, ddev_tol, early_exit_on, prev_dev, have_prev_dev,
        sweep_budget, intercept_on,
    ):
        dtype = beta0.dtype

        def per_lambda(carry, inp):
            beta, active, resid, rsq, stopped, prev_dev, have_prev, cum = carry
            lmda, is_valid = inp
            run_it = is_valid & (~stopped)

            def run(args):
                beta, active, resid, rsq, stopped, prev_dev, have_prev, cum = args
                resid_sum0 = jnp.vdot(w, resid, precision=_PRECISION)
                vw = w * resid
                grad_s = jnp.einsum("ns,n->s", Xs, vw, precision=_PRECISION)
                grad_s = jnp.where(
                    intercept_on, grad_s - means_s * resid_sum0, grad_s
                )

                beta_n, _, active_n, rsq_n, iters, done = pin_cov_solve(
                    A, grad_s, beta, slot_begin, slot_size, eigvals, eigvecs,
                    penalty_slots, active, lmda, alpha, tol, dbeta_tol,
                    newton_tol, newton_max_iters, max_iters, rsq,
                )

                dbeta = beta_n - beta
                resid_n = resid - jnp.matmul(Xs, dbeta, precision=_PRECISION)
                resid_sum = jnp.vdot(w, resid_n, precision=_PRECISION)

                dev = jnp.where(y_var > 0, rsq_n / y_var, 0.0)
                early = early_exit_on & done & (
                    (dev >= adev_tol)
                    | (have_prev & (jnp.abs(dev - prev_dev) < ddev_tol))
                )
                cum_n = cum + iters
                stopped_n = (~done) | early | (cum_n >= sweep_budget)

                carry_n = (beta_n, active_n, resid_n, rsq_n, stopped_n,
                           jnp.where(done, dev, prev_dev), have_prev | done,
                           cum_n)
                emit = (beta_n, active_n, rsq_n, resid_sum, done, dev, early,
                        jnp.ones((), bool), iters)
                return carry_n, emit

            def skip(args):
                beta, active, *_ = args
                emit = (beta, active, jnp.zeros((), dtype),
                        jnp.zeros((), dtype), jnp.zeros((), bool),
                        jnp.zeros((), dtype), jnp.zeros((), bool),
                        jnp.zeros((), bool), jnp.zeros((), jnp.int32))
                return args, emit

            return jax.lax.cond(run_it, run, skip, carry)

        init = (beta0, active0, resid0, rsq0, jnp.zeros((), bool),
                prev_dev, have_prev_dev, jnp.zeros((), jnp.int32))
        carry, emits = jax.lax.scan(per_lambda, init, (lmdas, valid))
        return carry, emits

    return chunk_step


def get_streamed_chunk_step():
    hit = _STREAM_STEP_CACHE.get("chunk")
    if hit is None:
        hit = _STREAM_STEP_CACHE["chunk"] = build_streamed_chunk_step()
    return hit


@jax.jit
def residual_stack(resid0, Xs, betas_e, beta0, w):
    """Per-lambda residuals/weighted residuals from emitted betas.

    resid_c = resid0 - Xs @ (beta_c - beta0);  U_c = w * resid_c.
    Returns (U (C, n), resid_sums (C,))."""
    dB = betas_e - beta0[None, :]                    # (C, S_cap)
    R = resid0[None, :] - jnp.einsum(
        "cs,ns->cn", dB, Xs, precision=_PRECISION
    )
    U = R * w[None, :]
    rsums = jnp.einsum("cn,n->c", R, w, precision=_PRECISION)
    return U, rsums


@functools.partial(jax.jit, static_argnames=("num_groups", "intercept"))
def kkt_finalize(
    Gfull, X_means, rsums, lmdas, alpha,
    penalty_cols, betas_e, cols_padded, group_ids, penalty_groups,
    screen_mask, num_groups, intercept,
):
    """Per-lambda abs_grad + KKT verdicts from the streamed (p, C) gradient
    stack (reference update_abs_grad solver_base.hpp:21-110 + kkt
    :410-433, vectorized over the whole lambda chunk)."""
    G = Gfull - X_means[:, None] * rsums[None, :] if intercept else Gfull
    ok = cols_padded >= 0
    # OOB sentinel: drop padded slots (clamping to 0 races with column 0)
    safe = jnp.where(ok, cols_padded, G.shape[0])
    Bcols = jnp.zeros_like(G).at[safe, :].set(betas_e.T, mode="drop")
    l2s = (1.0 - alpha) * jnp.minimum(lmdas, 1e30)   # (C,)
    gadj = G - (penalty_cols[:, None] * Bcols) * l2s[None, :]
    sq = jax.ops.segment_sum(gadj * gadj, group_ids, num_segments=num_groups)
    abs_grad_all = jnp.sqrt(jnp.maximum(sq, 0.0))    # (G, C)
    viol = abs_grad_all > lmdas[None, :] * alpha * penalty_groups[:, None]
    kkts = ~jnp.any(viol & ~screen_mask[:, None], axis=0)
    return abs_grad_all, kkts, G


@jax.jit
def _resid_at(resid0, Xs, beta_t, beta0):
    return resid0 - jnp.matmul(Xs, beta_t - beta0, precision=_PRECISION)


@jax.jit
def _spec_viol_margin(abs_grad_all, lmdas, alpha, penalty_groups,
                      screen_mask, ok_mask):
    """Per-group worst RELATIVE KKT-violation margin across the chunk's
    converged lambdas (-inf for screened groups / no violation anywhere).

    Normalizing by the per-lambda threshold keeps margins comparable
    across lambdas — raw margins let small-lambda speculative violators
    dominate the truncation ordering (ADVICE r3 #1).  Unpenalized groups
    (thr == 0) are always screened, so the eps floor never selects."""
    thr = lmdas[None, :] * alpha * penalty_groups[:, None]
    marg = (abs_grad_all - thr) / jnp.maximum(thr, 1e-30)
    marg = jnp.where(ok_mask[None, :], marg, -jnp.inf)
    marg = jnp.max(marg, axis=1)
    return jnp.where(screen_mask, -jnp.inf, marg)


def _union_speculative_violators(s, penalty_groups_dev, screen_mask_dev,
                                 abs_grad_all, lm_dev, ok_mask_np,
                                 first_fail=None):
    """Grow the screen set with every group that violates KKT at ANY
    converged lambda of the failed chunk — not just the first failure.

    The post-failure fits are speculative (fit against the too-small
    screen block), but their gradient stack is already paid for by the
    chunk's single full-p streamed pass, and it predicts the groups the
    coming retries would add one rollback at a time.  Unioning them all
    now trades O(S^2) Gram growth for whole full-p re-sweeps — at
    north-star scale one avoided retry saves a 25 GB host->HBM pass.
    Correctness is unaffected: every accepted lambda still has to pass
    the next streamed-KKT certificate.  Gated by
    ``configs.stream_speculative_union`` (the screen trajectory — and
    hence the exact iterate within solver tolerance — differs from the
    in-HBM driver's when it fires).
    """
    if not configs.stream_speculative_union:
        return
    room = s.max_screen_size - len(s.screen_set)
    if room <= 0:
        return
    marg = _spec_viol_margin(
        abs_grad_all, lm_dev, jnp.asarray(s.alpha, s.dtype),
        penalty_groups_dev, screen_mask_dev, jnp.asarray(ok_mask_np),
    )
    marg_h = np.asarray(jax.device_get(marg))
    idx = np.flatnonzero(marg_h > 0)
    if not len(idx):
        return
    hash_ = s.screen_hash
    idx = np.asarray([int(i) for i in idx if int(i) not in hash_], int)
    if len(idx) > room:
        # Over max_screen_size: the violators at the FIRST failed lambda
        # are what the retry's screen() must add anyway — evicting them
        # for larger-margin small-lambda speculative ones can fill the
        # set and turn a recoverable retry into MaxScreenSetError
        # (ADVICE r3 #1).  Retain them first, then spend the remaining
        # room on speculative violators by relative margin.
        order = np.argsort(-marg_h[idx], kind="stable")
        if first_fail is not None:
            ff = int(first_fail)
            thr_ff = float(lm_dev[ff]) * float(s.alpha) * \
                np.asarray(s.penalty, float)
            ag_ff = np.asarray(jax.device_get(abs_grad_all[:, ff]))
            mand = np.asarray(
                [int(i) for i in idx if ag_ff[i] > thr_ff[i]], int)
            spec = idx[order]
            spec = spec[~np.isin(spec, mand)]
            mand = mand[np.argsort(-marg_h[mand], kind="stable")]
            idx = np.concatenate([mand, spec])[:room]
        else:
            idx = idx[order][:room]
    s.extend_screen_set(idx)


class StreamedGaussianDriver(GaussianNaiveDriver):
    """Gaussian BASIL driver over a host-streamed matrix.

    Reuses ``GaussianNaiveDriver.solve_path`` (screening, chunk
    scheduling) with ``_run_chunk`` replaced by the optimistic-fit +
    streamed-KKT + certify protocol described in the module docstring.
    """

    def __init__(self, state):
        self.s = state
        self._chunk_step = get_streamed_chunk_step()
        self._step = None                  # single-lambda fused step unused
        self._X_data = None
        self._prev_dev = 0.0
        self._have_prev_dev = False
        self._is_screen_dev = None
        self._is_screen_version = -1
        self._penalty_groups_dev = jnp.asarray(
            state.penalty.astype(state.dtype)
        )

    def fit(self, lmda):  # pragma: no cover - solve_path never calls it
        raise NotImplementedError(
            "streamed driver runs chunked solve_path only"
        )

    def _run_chunk(self, lmdas, record):
        s = self.s
        sw = Stopwatch().start()
        cache = s.ensure_screen_cache()
        if cache.A is None:
            cache.rebuild_weighted(s.weights, s.intercept)

        dtype = s.dtype
        C = int(s.lmda_chunk)
        lmdas = np.asarray(lmdas, float)
        nval = len(lmdas)
        lm_pad = np.full(C, lmdas[-1] if nval else 1.0)
        lm_pad[:nval] = lmdas
        valid = np.zeros(C, bool)
        valid[:nval] = True

        beta0_dev = cache.pad_screen_values(s.screen_beta, dtype)
        active0 = cache.pad_group_bools(s.screen_is_active)
        resid0 = s.resid
        lm_dev = jnp.asarray(lm_pad, dtype)

        carry, emits = self._chunk_step(
            cache.A, cache.Xs, cache.means_s,
            cache.slot_begin, cache.slot_size, cache.eigvals, cache.eigvecs,
            cache.penalty_slots,
            beta0_dev, active0,
            resid0, s.weights,
            lm_dev, jnp.asarray(valid),
            jnp.asarray(s.alpha, dtype), jnp.asarray(s.tol, dtype),
            jnp.asarray(configs.dbeta_tol, dtype),
            jnp.asarray(s.newton_tol, dtype),
            jnp.asarray(s.newton_max_iters, jnp.int32),
            jnp.asarray(s.max_iters, jnp.int32),
            jnp.asarray(s.rsq, dtype),
            jnp.asarray(s.y_var, dtype), jnp.asarray(s.adev_tol, dtype),
            jnp.asarray(s.ddev_tol, dtype),
            jnp.asarray(bool(s.early_exit)),
            jnp.asarray(self._prev_dev, dtype),
            jnp.asarray(self._have_prev_dev),
            jnp.asarray(configs.chunk_sweep_budget, jnp.int32),
            jnp.asarray(bool(s.intercept)),
        )
        (betas_e, actives_e, rsqs_e, rsums_e, dones_e, devs_e, earlys_e,
         processed_e, iters_e) = emits

        (dones, devs, earlys, processed, rsqs, rsums_h, iters_np) = \
            jax.device_get((dones_e, devs_e, earlys_e, processed_e, rsqs_e,
                            rsums_e, iters_e))
        n_proc = int(processed.sum())
        if n_proc == 0:
            s.benchmark["fit_screen"].append(sw.elapsed())
            return 0, False, True

        # ---- streamed KKT: ONE pass over the packed bytes for the chunk ---
        sw_k = Stopwatch().start()
        U, rsums_dev = residual_stack(
            resid0, cache.Xs, betas_e, beta0_dev, s.weights
        )
        Gfull = s.X.mul_many(U)                       # (p, C) streamed
        abs_grad_all, kkts, Gstack = kkt_finalize(
            Gfull, s.X_means, rsums_dev, lm_dev,
            jnp.asarray(s.alpha, dtype),
            s._penalty_cols, betas_e, cache.cols_padded, s._group_ids,
            self._penalty_groups_dev, self._screen_mask(),
            len(s.groups), bool(s.intercept),
        )
        kkts_h = np.asarray(jax.device_get(kkts))
        s.benchmark["kkt"].append(sw_k.elapsed())

        # ---- certify: accepted prefix ends at the first KKT failure or
        # pin non-convergence; pin failures AFTER a KKT failure are
        # speculative fits invalidated by the retry and do not raise ------
        kkts_eff = np.ones(n_proc, bool) if self.pin_mode \
            else kkts_h[:n_proc]
        accept = dones[:n_proc] & kkts_eff
        fails = np.flatnonzero(~accept)
        pin_failed = bool(len(fails)) and not bool(dones[fails[0]])
        if len(fails):
            t = int(fails[0])
            n_acc = t
            kkt_clean = False
            early_stopped = False
            if pin_failed:
                # keep the last ACCEPTED iterate, not the unconverged one
                t = t - 1
        else:
            t = n_proc - 1
            n_acc = n_proc
            kkt_clean = True
            early_stopped = bool(earlys[:n_proc].any())

        # ---- record accepted solutions ----------------------------------
        if record and n_acc:
            S_val = cache.S_val
            G_s = len(s.screen_set)
            betas_acc, actives_acc = jax.device_get(
                (betas_e[:n_acc], actives_e[:n_acc])
            )
            for i in range(n_acc):
                self._record(
                    lm_pad[i], np.asarray(betas_acc[i][:S_val]),
                    rsqs[i], rsums_h[i], cache,
                )
                s.n_valid_solutions.append(True)
                s.active_sizes.append(int(np.asarray(actives_acc[i]).sum()))
                s.screen_sizes.append(len(s.screen_set))
                s.benchmark["cd_iters"].append(int(iters_np[i]))
                s.benchmark["cd_updates"].append(int(iters_np[i]) * G_s)

        # ---- advance state to the target iterate (reference keeps the
        # failed fit's iterate for the retry, solver_base.hpp:605-686) -----
        if t >= 0:
            beta_t = betas_e[t]
            active_t = actives_e[t]
            beta_h, active_h, agrad_h, grad_col = jax.device_get(
                (beta_t, active_t, abs_grad_all[:, t], Gstack[:, t])
            )
            s.screen_beta = np.asarray(beta_h)[: cache.S_val].copy()
            s.screen_is_active = \
                np.asarray(active_h)[: len(s.screen_set)].copy()
            s.resid = _resid_at(resid0, cache.Xs, beta_t, beta0_dev)
            s.rsq = float(rsqs[t])
            s.resid_sum = float(rsums_h[t])
            s.abs_grad = np.asarray(agrad_h)
            s.grad = jnp.asarray(grad_col)
            s.lmda = float(lm_pad[t])
        if record and n_acc:
            self._prev_dev = float(devs[n_acc - 1])
            self._have_prev_dev = True
        s.benchmark["fit_screen"].append(sw.elapsed())
        if pin_failed:
            raise MaxCDsError(int(fails[0]))
        if not kkt_clean and not self.pin_mode:
            _union_speculative_violators(
                s, self._penalty_groups_dev, self._screen_mask(),
                abs_grad_all, lm_dev, processed & dones,
                first_fail=None if pin_failed else int(fails[0]),
            )
        if configs.debug_check_state:
            from ..state import check_state

            check_state(s)
        return n_acc, early_stopped, kkt_clean


# ===================================================================== #
# streamed GLM (IRLS) driver                                            #
# ===================================================================== #


def build_streamed_glm_chunk_step(glm, intercept: bool, qmax: int, dtype):
    """Optimistic IRLS lambda-chunk scan over the screened block only.

    The fused GLM chunk step (glm_fused.build_glm_chunk_step) folds the
    full-p KKT gradient into the scan, which needs the matrix in HBM.
    Here each lambda runs the SAME fused IRLS core
    (glm_fused._make_irls_fit: reweighting, screen-Gram/eigh refresh,
    covariance-form pin solve, one lax.while_loop — reference
    solver_glm_naive.hpp:241-459) but emits its converged
    eta/resid/beta stacks instead of verdicts; the caller streams ONE
    X.mul_many pass over the packed bytes to get every lambda's KKT
    verdict, then certifies the accepted prefix on host (rolling back
    exactly like the streamed gaussian driver above).
    """
    from .glm_fused import _make_irls_fit

    irls_fit = _make_irls_fit(glm, intercept, qmax, dtype)

    @jax.jit
    def chunk_step(
        Xs, slot_begin, slot_size, penalty_slots,
        beta0, active0, eta0, resid0, b0_init, offsets,
        lmdas, valid,
        alpha, tol_base, irls_tol, irls_max_iters,
        dbeta_tol, newton_tol, newton_max_iters, max_iters,
        loss_null, loss_full, adev_tol, ddev_tol, early_exit_on,
        prev_dev, have_prev_dev, sweep_budget,
    ):
        def per_lambda(carry, inp):
            (beta, active, eta, resid, b0, stopped, prev_dev, have_prev,
             cum_irls) = carry
            lmda, is_valid = inp
            run_it = is_valid & (~stopped)

            def run(args):
                (beta, active, eta, resid, b0, stopped, prev_dev,
                 have_prev, cum_irls) = args
                (beta_n, active_n, eta_n, resid_n, b0_n, irls_iters,
                 converged, pin_ok) = irls_fit(
                    Xs, slot_begin, slot_size, penalty_slots,
                    beta, active, eta, resid, b0, offsets,
                    lmda, alpha, tol_base, irls_tol, irls_max_iters,
                    dbeta_tol, newton_tol, newton_max_iters, max_iters,
                )
                fit_ok = converged & pin_ok
                loss = glm.loss(eta_n)
                dev = (loss_null - loss) / (loss_null - loss_full)
                # optimistic: the early exit is decided on fit_ok alone;
                # the host certify truncates at the first streamed-KKT
                # failure, discarding any post-failure exit decision
                early = early_exit_on & fit_ok & (
                    (dev >= adev_tol)
                    | (have_prev & (jnp.abs(dev - prev_dev) < ddev_tol))
                )
                cum_n = cum_irls + irls_iters
                stopped_n = (~fit_ok) | early | (cum_n >= sweep_budget)

                # failed IRLS fits do not advance the iterate (rollback,
                # reference solver_glm_naive.hpp:315-322)
                def commit(_):
                    return (beta_n, active_n, eta_n, resid_n, b0_n,
                            stopped_n, jnp.where(fit_ok, dev, prev_dev),
                            have_prev | fit_ok, cum_n)

                def keep(_):
                    return (beta, active, eta, resid, b0,
                            jnp.ones((), bool), prev_dev, have_prev, cum_n)

                carry_n = jax.lax.cond(fit_ok, commit, keep, None)
                emit = (beta_n, active_n, eta_n, resid_n, b0_n, fit_ok,
                        pin_ok, dev, loss, early, jnp.ones((), bool),
                        irls_iters)
                return carry_n, emit

            def skip(args):
                beta, active, eta, resid, b0 = args[:5]
                emit = (beta, active, eta, resid, b0,
                        jnp.zeros((), bool), jnp.ones((), bool),
                        jnp.zeros((), dtype), jnp.zeros((), dtype),
                        jnp.zeros((), bool), jnp.zeros((), bool),
                        jnp.zeros((), jnp.int32))
                return args, emit

            return jax.lax.cond(run_it, run, skip, carry)

        init = (beta0, active0, eta0, resid0, b0_init,
                jnp.zeros((), bool), prev_dev, have_prev_dev,
                jnp.zeros((), jnp.int32))
        carry, emits = jax.lax.scan(per_lambda, init, (lmdas, valid))
        return carry, emits

    return chunk_step


def get_streamed_glm_chunk_step(glm, intercept: bool, qmax: int, dtype):
    key = ("glm_chunk", id(glm), bool(intercept), int(qmax),
           jnp.dtype(dtype).name)
    hit = _STREAM_STEP_CACHE.get(key)
    if hit is None:
        hit = _STREAM_STEP_CACHE[key] = build_streamed_glm_chunk_step(
            glm, intercept, qmax, dtype
        )
    return hit


class StreamedGlmDriver(GlmNaiveDriver):
    """GLM (IRLS) BASIL driver over a host-streamed matrix.

    Reuses ``GlmNaiveDriver.solve_path`` (loss_null setup, lmda_max,
    screening, chunk scheduling) with ``_run_chunk`` replaced by the
    optimistic-IRLS + streamed-KKT + certify protocol.  The GLM KKT
    gradient is ``X^T resid`` with NO mean-centering (the intercept is a
    coordinate of eta inside IRLS, glm_fused._kkt_block), so
    ``kkt_finalize`` runs with ``intercept=False``.
    """

    def fit(self, lmda):  # pragma: no cover - solve_path never calls it
        raise NotImplementedError(
            "streamed GLM driver runs chunked solve_path only"
        )

    def _run_chunk(self, lmdas, record):
        import scipy.sparse as sp

        s = self.s
        glm = s.glm
        dtype = s.dtype
        sw = Stopwatch().start()
        cache = s.ensure_screen_cache()
        step = get_streamed_glm_chunk_step(
            glm, bool(s.intercept), cache.qmax, dtype
        )

        C = int(s.lmda_chunk)
        lmdas = np.asarray(lmdas, float)
        nval = len(lmdas)
        lm_pad = np.full(C, lmdas[-1] if nval else 1.0)
        lm_pad[:nval] = lmdas
        valid = np.zeros(C, bool)
        valid[:nval] = True
        lm_dev = jnp.asarray(lm_pad, dtype)

        beta0_dev = cache.pad_screen_values(s.screen_beta, dtype)
        active0 = cache.pad_group_bools(s.screen_is_active)
        tol_base = s.tol * (s.loss_null - s.loss_full)

        carry, emits = step(
            cache.Xs, cache.slot_begin, cache.slot_size, cache.penalty_slots,
            beta0_dev, active0,
            s.eta, s.resid, jnp.asarray(s.beta0, dtype), s.offsets,
            lm_dev, jnp.asarray(valid),
            jnp.asarray(s.alpha, dtype), jnp.asarray(tol_base, dtype),
            jnp.asarray(s.irls_tol, dtype),
            jnp.asarray(s.irls_max_iters, jnp.int32),
            jnp.asarray(configs.dbeta_tol, dtype),
            jnp.asarray(s.newton_tol, dtype),
            jnp.asarray(s.newton_max_iters, jnp.int32),
            jnp.asarray(s.max_iters, jnp.int32),
            jnp.asarray(s.loss_null, dtype), jnp.asarray(s.loss_full, dtype),
            jnp.asarray(s.adev_tol, dtype), jnp.asarray(s.ddev_tol, dtype),
            jnp.asarray(bool(s.early_exit)),
            jnp.asarray(self._prev_dev, dtype),
            jnp.asarray(self._have_prev_dev),
            jnp.asarray(configs.chunk_sweep_budget, jnp.int32),
        )
        (betas_e, actives_e, etas_e, resids_e, b0s_e, fitoks_e, pinoks_e,
         devs_e, losses_e, earlys_e, processed_e, irls_e) = emits

        (fitoks, pinoks, devs, earlys, processed, b0s_np, irls_np) = \
            jax.device_get((fitoks_e, pinoks_e, devs_e, earlys_e,
                            processed_e, b0s_e, irls_e))
        n_proc = int(processed.sum())
        if n_proc == 0:
            s.benchmark["fit_screen"].append(sw.elapsed())
            return 0, False, True

        # ---- streamed KKT: ONE pass over the packed bytes ---------------
        sw_k = Stopwatch().start()
        Gfull = s.X.mul_many(resids_e)                # (p, C) streamed
        zero = jnp.zeros((), dtype)
        abs_grad_all, kkts, Gstack = kkt_finalize(
            Gfull, zero, zero, lm_dev, jnp.asarray(s.alpha, dtype),
            s._penalty_cols, betas_e, cache.cols_padded, s._group_ids,
            self._penalty_groups_dev, self._screen_mask(),
            len(s.groups), False,
        )
        kkts_h = np.asarray(jax.device_get(kkts))
        s.benchmark["kkt"].append(sw_k.elapsed())

        # ---- certify (first fit failure or KKT failure ends the prefix;
        # fit failures AFTER a KKT failure are speculative -> retried) ----
        accept = fitoks[:n_proc] & kkts_h[:n_proc]
        fails = np.flatnonzero(~accept)
        fit_failed = bool(len(fails)) and not bool(fitoks[fails[0]])
        if len(fails):
            t = int(fails[0])
            n_acc = t
            kkt_clean = False
            early_stopped = False
            if fit_failed:
                # IRLS/pin never converged there: keep the last ACCEPTED
                # iterate (the scan carry rolled the failure back too)
                t = t - 1
        else:
            t = n_proc - 1
            n_acc = n_proc
            kkt_clean = True
            early_stopped = bool(earlys[:n_proc].any())

        # ---- record accepted solutions ----------------------------------
        if record and n_acc:
            S_val = cache.S_val
            G_s = len(s.screen_set)
            betas_acc, actives_acc = jax.device_get(
                (betas_e[:n_acc], actives_e[:n_acc])
            )
            for i in range(n_acc):
                sb = np.asarray(betas_acc[i][:S_val])
                nz = np.abs(sb) > 0
                beta_row = sp.csr_matrix(
                    (sb[nz], (np.zeros(int(nz.sum()), int), cache.cols[nz])),
                    shape=(1, s.p),
                )
                s.betas.append(beta_row)
                s.intercepts.append(float(b0s_np[i]) if s.intercept else 0.0)
                s.lmdas.append(float(lm_pad[i]))
                s.devs.append(float(devs[i]))
                s.n_valid_solutions.append(True)
                s.active_sizes.append(
                    int(np.asarray(actives_acc[i]).sum())
                )
                s.screen_sizes.append(len(s.screen_set))
                s.benchmark["cd_iters"].append(int(irls_np[i]))

        # ---- advance state to the target iterate ------------------------
        if t >= 0:
            beta_h, active_h, agrad_h, grad_col = jax.device_get(
                (betas_e[t], actives_e[t], abs_grad_all[:, t], Gstack[:, t])
            )
            s.screen_beta = np.asarray(beta_h)[: cache.S_val].copy()
            s.screen_is_active = \
                np.asarray(active_h)[: len(s.screen_set)].copy()
            s.eta = etas_e[t]
            s.resid = resids_e[t]
            s.beta0 = float(b0s_np[t])
            s.abs_grad = np.asarray(agrad_h)
            s.grad = jnp.asarray(grad_col)
            s.lmda = float(lm_pad[t])
        if record and n_acc:
            self._prev_dev = float(devs[n_acc - 1])
            self._have_prev_dev = True
        s.benchmark["fit_screen"].append(sw.elapsed())

        # IRLS failures raise AFTER the state advance (valid partial state,
        # reference py_state.cpp:83-89)
        if fit_failed:
            if not bool(pinoks[fails[0]]):
                raise MaxCDsError(int(fails[0]))
            raise SolverError("Maximum IRLS iterations reached.")
        if not kkt_clean:
            # fit failures raised above, so fails[0] is a KKT failure
            _union_speculative_violators(
                s, self._penalty_groups_dev, self._screen_mask(),
                abs_grad_all, lm_dev, processed & fitoks,
                first_fail=int(fails[0]),
            )
        if configs.debug_check_state:
            from ..state import check_state

            check_state(s)
        return n_acc, early_stopped, kkt_clean


# ===================================================================== #
# streamed constrained gaussian driver                                  #
# ===================================================================== #

from .constrained import ConstrainedGaussianDriver  # noqa: E402


def build_streamed_constrained_chunk_step(pn_cfg):
    """Optimistic constrained lambda-chunk scan: per-lambda constrained
    pin solves (duals on the carry, reference retry semantics) with NO
    full-matrix gradient/KKT — those run streamed afterwards and the host
    certifies the accepted prefix, exactly like the unconstrained
    streamed driver above.  ``pn_cfg`` as in
    constrained.get_constrained_chunk_step."""
    from .pin_constrained import pin_cov_solve_constrained

    pn_kw = {} if pn_cfg is None else dict(
        cons_method="proximal_newton",
        pn_slack=pn_cfg[0], pn_nnls_tol=pn_cfg[1],
        pn_nnls_max_iters=pn_cfg[2], pn_pinball_tol=pn_cfg[3],
        pn_pinball_max_iters=pn_cfg[4],
    )

    @jax.jit
    def chunk_step(
        A, Xs, means_s,
        slot_begin, slot_size, eigvals, eigvecs, penalty_slots,
        beta0, active0,
        resid0, w,
        has_cons, P, DH, UH, lo_pad, hi_pad, mu0,
        rho, cons_tol, cons_max_iters,
        lmdas, valid,
        alpha, tol, dbeta_tol, newton_tol,
        newton_max_iters, max_iters, rsq0,
        y_var, adev_tol, ddev_tol, early_exit_on, prev_dev, have_prev_dev,
        sweep_budget, intercept_on,
    ):
        dtype = beta0.dtype

        def per_lambda(carry, inp):
            (beta, active, resid, rsq, mu, stopped, prev_dev, have_prev,
             cum) = carry
            lmda, is_valid = inp
            run_it = is_valid & (~stopped)

            def run(args):
                (beta, active, resid, rsq, mu, stopped, prev_dev,
                 have_prev, cum) = args
                resid_sum0 = jnp.vdot(w, resid, precision=_PRECISION)
                vw = w * resid
                grad_s = jnp.einsum("ns,n->s", Xs, vw, precision=_PRECISION)
                grad_s = jnp.where(
                    intercept_on, grad_s - means_s * resid_sum0, grad_s
                )

                (beta_n, _, active_n, rsq_n, mu_n, iters, done
                 ) = pin_cov_solve_constrained(
                    A, grad_s, beta, slot_begin, slot_size, eigvals,
                    eigvecs, penalty_slots, active,
                    has_cons, P, DH, UH, lo_pad, hi_pad, mu,
                    rho, cons_tol, cons_max_iters,
                    lmda, alpha, tol, dbeta_tol,
                    newton_tol, newton_max_iters, max_iters, rsq,
                    **pn_kw,
                )

                dbeta = beta_n - beta
                resid_n = resid - jnp.matmul(Xs, dbeta, precision=_PRECISION)
                resid_sum = jnp.vdot(w, resid_n, precision=_PRECISION)

                dev = jnp.where(y_var > 0, rsq_n / y_var, 0.0)
                early = early_exit_on & done & (
                    (dev >= adev_tol)
                    | (have_prev & (jnp.abs(dev - prev_dev) < ddev_tol))
                )
                # cooperative watchdog guard (see fused.py:100-104): the
                # chunk's total CD sweeps are bounded so an effectively
                # stuck constrained pin solve cannot spin the device
                # program past the platform watchdog
                cum_n = cum + iters
                stopped_n = (~done) | early | (cum_n >= sweep_budget)

                carry_n = (beta_n, active_n, resid_n, rsq_n, mu_n,
                           stopped_n, jnp.where(done, dev, prev_dev),
                           have_prev | done, cum_n)
                emit = (beta_n, active_n, rsq_n, resid_sum, done, dev,
                        early, jnp.ones((), bool), iters, mu_n)
                return carry_n, emit

            def skip(args):
                beta, active, _, _, mu, *_ = args
                emit = (beta, active, jnp.zeros((), dtype),
                        jnp.zeros((), dtype), jnp.zeros((), bool),
                        jnp.zeros((), dtype), jnp.zeros((), bool),
                        jnp.zeros((), bool), jnp.zeros((), jnp.int32), mu)
                return args, emit

            return jax.lax.cond(run_it, run, skip, carry)

        init = (beta0, active0, resid0, rsq0, mu0,
                jnp.zeros((), bool), prev_dev, have_prev_dev,
                jnp.zeros((), jnp.int32))
        carry, emits = jax.lax.scan(per_lambda, init, (lmdas, valid))
        return carry, emits

    return chunk_step


def get_streamed_constrained_chunk_step(pn_cfg):
    key = ("cons_chunk", pn_cfg)
    hit = _STREAM_STEP_CACHE.get(key)
    if hit is None:
        hit = _STREAM_STEP_CACHE[key] = \
            build_streamed_constrained_chunk_step(pn_cfg)
    return hit


@functools.partial(jax.jit, static_argnames=("num_groups", "intercept"))
def kkt_finalize_constrained(
    Gfull, X_means, rsums, lmdas, alpha,
    penalty_cols, betas_e, cols_padded, group_ids, penalty_groups,
    screen_mask, mus_e,
    cons_gids, cons_A, cons_lo, cons_hi, cons_start, cons_size,
    cons_slot, cons_big, nnls_tol, nnls_max_iters,
    num_groups, intercept,
):
    """kkt_finalize + the dual-corrected constrained abs_grad (reference
    update_abs_grad, solver_base.hpp:21-110), vectorized over the whole
    lambda chunk: screened constrained groups subtract A^T mu_c (the
    per-lambda dual emitted by the optimistic scan), non-screen ones run
    the sign-boxed solve_zero on their gradient window."""
    from ..constraint._pn import _min_mu_resid

    G = Gfull - X_means[:, None] * rsums[None, :] if intercept else Gfull
    ok = cols_padded >= 0
    # OOB sentinel: drop padded slots (clamping to 0 races with column 0)
    safe = jnp.where(ok, cols_padded, G.shape[0])
    Bcols = jnp.zeros_like(G).at[safe, :].set(betas_e.T, mode="drop")
    l2s = (1.0 - alpha) * jnp.minimum(lmdas, 1e30)   # (C,)
    gadj = G - (penalty_cols[:, None] * Bcols) * l2s[None, :]
    sq = jax.ops.segment_sum(gadj * gadj, group_ids, num_segments=num_groups)
    abs_grad_all = jnp.sqrt(jnp.maximum(sq, 0.0))    # (G, C)

    C = lmdas.shape[0]
    qc = cons_A.shape[2]
    dtype = gadj.dtype
    # pad so a trailing group's (qc,) window never clamps (dynamic_slice
    # clamps out-of-bounds starts, silently reading the WRONG window)
    gadj_pad = jnp.concatenate([gadj, jnp.zeros((qc, C), dtype)], axis=0)

    def one_group(Ac, lo_c, hi_c, cstart, csize, slot):
        cmask = (jnp.arange(qc) < csize)[:, None]
        g_sl = jax.lax.dynamic_slice(
            gadj_pad, (cstart, jnp.zeros((), cstart.dtype)), (qc, C)
        )
        g_sl = jnp.where(cmask, g_sl, 0.0)           # (qc, C)

        def per_lambda(g_c, mu_c):
            def screened(_):
                corr = g_c - Ac.T @ mu_c[slot]
                return jnp.sqrt(jnp.sum(corr * corr))

            def unscreened(_):
                _, rsq_z = _min_mu_resid(
                    Ac, g_c, jnp.zeros((Ac.shape[0],), dtype),
                    lo_c, hi_c, cons_big, nnls_tol, nnls_max_iters,
                )
                return jnp.sqrt(jnp.maximum(rsq_z, 0.0))

            return jax.lax.cond(slot >= 0, screened, unscreened, None)

        return jax.vmap(per_lambda, in_axes=(1, 0))(g_sl, mus_e)  # (C,)

    corr_vals = jax.vmap(one_group)(
        cons_A, cons_lo, cons_hi, cons_start, cons_size, cons_slot
    )                                                 # (n_cons, C)
    abs_grad_all = abs_grad_all.at[cons_gids, :].set(corr_vals)
    viol = abs_grad_all > lmdas[None, :] * alpha * penalty_groups[:, None]
    kkts = ~jnp.any(viol & ~screen_mask[:, None], axis=0)
    return abs_grad_all, kkts, G


class StreamedConstrainedGaussianDriver(ConstrainedGaussianDriver):
    """Constrained gaussian BASIL driver over a host-streamed matrix.

    Reuses ``ConstrainedGaussianDriver.solve_path`` (screening, dual
    bookkeeping, chunk scheduling) with ``_run_chunk`` replaced by the
    optimistic-fit + streamed-KKT + certify protocol of
    :class:`StreamedGaussianDriver`; the chunk's duals ride the scan
    carry and feed the post-hoc dual-corrected KKT."""

    def _select_chunk_step(self, pn_cfg):
        return get_streamed_constrained_chunk_step(pn_cfg)

    def _run_chunk(self, lmdas, record):
        from .gaussian import GaussianNaiveDriver

        s = self.s
        sw = Stopwatch().start()
        cache = self._ensure()
        pk = self.pack
        dtype = s.dtype

        C = int(s.lmda_chunk)
        lmdas = np.asarray(lmdas, float)
        nval = len(lmdas)
        lm_pad = np.full(C, lmdas[-1] if nval else 1.0)
        lm_pad[:nval] = lmdas
        valid = np.zeros(C, bool)
        valid[:nval] = True
        lm_dev = jnp.asarray(lm_pad, dtype)

        beta0_dev = cache.pad_screen_values(s.screen_beta, dtype)
        active0 = cache.pad_group_bools(s.screen_is_active)
        resid0 = s.resid

        carry, emits = self._chunk_step(
            cache.A, cache.Xs, cache.means_s,
            cache.slot_begin, cache.slot_size, cache.eigvals, cache.eigvecs,
            cache.penalty_slots,
            beta0_dev, active0,
            resid0, s.weights,
            pk.has_cons, pk.P, pk.DH, pk.UH, pk.lo_pad, pk.hi_pad, pk.mu,
            jnp.asarray(pk.rho, dtype),
            jnp.asarray(pk.cons_tol, dtype),
            jnp.asarray(pk.cons_max_iters, jnp.int32),
            lm_dev, jnp.asarray(valid),
            jnp.asarray(s.alpha, dtype), jnp.asarray(s.tol, dtype),
            jnp.asarray(configs.dbeta_tol, dtype),
            jnp.asarray(s.newton_tol, dtype),
            jnp.asarray(s.newton_max_iters, jnp.int32),
            jnp.asarray(s.max_iters, jnp.int32),
            jnp.asarray(s.rsq, dtype),
            jnp.asarray(s.y_var, dtype), jnp.asarray(s.adev_tol, dtype),
            jnp.asarray(s.ddev_tol, dtype),
            jnp.asarray(bool(s.early_exit)),
            jnp.asarray(self._prev_dev, dtype),
            jnp.asarray(self._have_prev_dev),
            jnp.asarray(configs.chunk_sweep_budget, jnp.int32),
            jnp.asarray(bool(s.intercept)),
        )
        (betas_e, actives_e, rsqs_e, rsums_e, dones_e, devs_e, earlys_e,
         processed_e, iters_e, mus_e) = emits

        (dones, devs, earlys, processed, rsqs, rsums_h, iters_np) = \
            jax.device_get((dones_e, devs_e, earlys_e, processed_e,
                            rsqs_e, rsums_e, iters_e))
        n_proc = int(processed.sum())
        if n_proc == 0:
            s.benchmark["fit_screen"].append(sw.elapsed())
            return 0, False

        # ---- streamed KKT with dual corrections --------------------------
        sw_k = Stopwatch().start()
        U, rsums_dev = residual_stack(
            resid0, cache.Xs, betas_e, beta0_dev, s.weights
        )
        Gfull = s.X.mul_many(U)
        abs_grad_all, kkts, Gstack = kkt_finalize_constrained(
            Gfull, s.X_means, rsums_dev, lm_dev,
            jnp.asarray(s.alpha, dtype),
            s._penalty_cols, betas_e, cache.cols_padded, s._group_ids,
            self._penalty_groups_dev, self._screen_mask_dev(), mus_e,
            jnp.asarray(pk.cons_gids), pk.cons_A, pk.cons_lo, pk.cons_hi,
            pk.cons_start, pk.cons_size, pk.cons_slot, pk.cons_big,
            jnp.asarray(max(pk.pn_nnls_tol, 1e-9), dtype),
            jnp.asarray(min(pk.pn_nnls_max_iters, 10000), jnp.int32),
            len(s.groups), bool(s.intercept),
        )
        kkts_h = np.asarray(jax.device_get(kkts))
        s.benchmark["kkt"].append(sw_k.elapsed())

        # ---- certify: accepted prefix (see StreamedGaussianDriver) -------
        accept = dones[:n_proc] & kkts_h[:n_proc]
        fails = np.flatnonzero(~accept)
        pin_failed = bool(len(fails)) and not bool(dones[fails[0]])
        if len(fails):
            t = int(fails[0])
            n_acc = t
            early_stopped = False
            if pin_failed:
                t = t - 1
        else:
            t = n_proc - 1
            n_acc = n_proc
            early_stopped = bool(earlys[:n_proc].any())

        # ---- record accepted solutions + their duals ---------------------
        if record and n_acc:
            S_val = cache.S_val
            G_s = len(s.screen_set)
            betas_acc, actives_acc, mus_acc = jax.device_get(
                (betas_e[:n_acc], actives_e[:n_acc], mus_e[:n_acc])
            )
            for i in range(n_acc):
                GaussianNaiveDriver._record(
                    self, lm_pad[i], np.asarray(betas_acc[i][:S_val]),
                    rsqs[i], rsums_h[i], cache,
                )
                duals = {}
                for j, g in enumerate(s.screen_set):
                    c = pk.constraints[g]
                    if c is None:
                        continue
                    mu_g = np.asarray(mus_acc[i][j, : c.duals()])
                    if np.any(mu_g != 0):
                        duals[int(g)] = mu_g.astype(c.dtype)
                if not hasattr(s, "duals"):
                    s.duals = []
                s.duals.append(duals)
                s.n_valid_solutions.append(True)
                s.active_sizes.append(int(np.asarray(actives_acc[i]).sum()))
                s.screen_sizes.append(len(s.screen_set))
                s.benchmark["cd_iters"].append(int(iters_np[i]))
                s.benchmark["cd_updates"].append(int(iters_np[i]) * G_s)

        # ---- advance state to the target iterate -------------------------
        if t >= 0:
            beta_t = betas_e[t]
            beta_h, active_h, agrad_h, grad_col = jax.device_get(
                (beta_t, actives_e[t], abs_grad_all[:, t], Gstack[:, t])
            )
            s.screen_beta = np.asarray(beta_h)[: cache.S_val].copy()
            s.screen_is_active = \
                np.asarray(active_h)[: len(s.screen_set)].copy()
            s.resid = _resid_at(resid0, cache.Xs, beta_t, beta0_dev)
            s.rsq = float(rsqs[t])
            s.resid_sum = float(rsums_h[t])
            s.abs_grad = np.asarray(agrad_h)
            s.grad = jnp.asarray(grad_col)
            s.lmda = float(lm_pad[t])
            pk.store_mu(s, mus_e[t])
        if record and n_acc:
            self._prev_dev = float(devs[n_acc - 1])
            self._have_prev_dev = True
        s.benchmark["fit_screen"].append(sw.elapsed())
        if pin_failed:
            raise MaxCDsError(int(fails[0]))
        if len(fails):
            # pin failures raised above, so fails[0] is a KKT failure
            _union_speculative_violators(
                s, self._penalty_groups_dev, self._screen_mask_dev(),
                abs_grad_all, lm_dev, processed & dones,
                first_fail=int(fails[0]),
            )
        if configs.debug_check_state:
            from ..state import check_state

            check_state(s)
        return n_acc, early_stopped
