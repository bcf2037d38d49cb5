"""Mesh/batch-parallel K-fold CV for the gaussian fast path.

The reference runs CV folds strictly serially (reference cv.py:239); SURVEY
§2.12 names fold batching as the net-new device parallelism axis.  Design:

* All K folds share the SAME design matrix and a UNION screen set, so the
  gathered screen block ``Xs`` is built once.  Fold-specific state — the
  zero-weighted fold weights, centered residuals, per-group Grams and
  eigendecompositions, screen betas — carries a leading fold axis and is
  ``vmap``-ed through the same covariance-form pin solve used by the
  single-fit path (pin.py).  One fused device call advances ALL folds
  through a chunk of lambdas.
* Validation losses are computed ON DEVICE per (fold, lambda) directly
  from the residual invariant (eta = y - resid + resid_sum), so the host
  pulls a (K, C) float block per chunk instead of K beta paths: the
  reference's interpolate-then-predict pipeline (cv.py:284-314)
  disappears.
* Screening uses the max-over-folds group gradient norms: a screen set
  valid for every fold.  The KKT verdict requires all folds to pass, so
  folds advance in lockstep and the BASIL retry logic is unchanged.

The batch axis composes with n-axis mesh sharding: fold state is (K, n)
with n sharded, so the same XLA collectives ride under a vmap.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ..configs import configs
from ..exceptions import MaxCDsError
from ..utils import Stopwatch, large_lmda
from .basil import screen
from .pin import pin_cov_solve, screen_eigh, screen_gram
from .state_core import NaiveStateBase

_PRECISION = jax.lax.Precision.HIGHEST

_STEP_CACHE = {}


def build_cv_chunk_step(X, intercept: bool, num_groups: int):
    """Fused lambda-chunk step over a fold batch.

    ``lax.scan`` over lambdas; inside, a ``vmap`` over folds of the same
    per-lambda body as fused.py (screen gradient, pin solve, residual
    reconstruction, invariance, KKT) plus the on-device CV loss pair.
    """
    mul_fn, _ = X.mul_spec()

    @jax.jit
    def chunk_step(
        X_data,
        # shared screen structure
        Xs, cols_padded, slot_begin, slot_size, penalty_slots,
        group_ids, penalty_cols, penalty_groups, is_screen_mask,
        # per-fold (leading K axis)
        A, means_s, eigvals, eigvecs,
        beta0, active0, resid0, w_folds, X_means,
        # loss inputs
        y_full, w_base, w_train_sums, w_val_sums,
        # path
        lmdas, valid,
        alpha, tol, dbeta_tol, newton_tol, newton_max_iters, max_iters,
    ):
        dtype = beta0.dtype
        K = beta0.shape[0]

        def fold_body(A_k, means_k, ev_k, evec_k, beta_k, act_k, resid_k,
                      w_k, Xm_k, lmda):
            resid_sum0 = jnp.vdot(w_k, resid_k, precision=_PRECISION)
            grad_s = jnp.einsum("ns,n->s", Xs, w_k * resid_k,
                                precision=_PRECISION)
            if intercept:
                grad_s = grad_s - means_k * resid_sum0

            beta_n, _, act_n, _, iters, done = pin_cov_solve(
                A_k, grad_s, beta_k, slot_begin, slot_size, ev_k, evec_k,
                penalty_slots, act_k, lmda, alpha, tol, dbeta_tol,
                newton_tol, newton_max_iters, max_iters,
                jnp.zeros((), dtype),
            )

            dbeta = beta_n - beta_k
            resid_n = resid_k - jnp.matmul(Xs, dbeta, precision=_PRECISION)
            resid_sum = jnp.vdot(w_k, resid_n, precision=_PRECISION)

            grad = mul_fn(X_data, resid_n, w_k)
            if intercept:
                grad = grad - resid_sum * Xm_k

            ok = cols_padded >= 0
            # OOB sentinel: drop padded slots (clamping to 0 races with column 0)
            safe = jnp.where(ok, cols_padded, grad.shape[0])
            beta_cols = jnp.zeros_like(grad).at[safe].set(
                beta_n, mode="drop"
            )
            l2s = (1.0 - alpha) * jnp.minimum(lmda, 1e30)
            gadj = grad - l2s * (penalty_cols * beta_cols)
            sq = jax.ops.segment_sum(gadj * gadj, group_ids,
                                     num_segments=num_groups)
            abs_grad = jnp.sqrt(jnp.maximum(sq, 0.0))
            viol = abs_grad > lmda * alpha * penalty_groups
            kkt = ~jnp.any(viol & ~is_screen_mask)

            # on-device CV loss: eta = y - resid + resid_sum (gaussian
            # residual invariant); loss(eta) = sum w (-y eta + eta^2/2)
            eta = y_full - resid_n + (resid_sum if intercept else 0.0)
            loss_full = jnp.vdot(w_base, -y_full * eta + 0.5 * eta * eta,
                                 precision=_PRECISION)
            loss_train = jnp.vdot(w_k, -y_full * eta + 0.5 * eta * eta,
                                  precision=_PRECISION)
            return (beta_n, act_n, resid_n, abs_grad, done, kkt,
                    loss_full, loss_train)

        vfold = jax.vmap(
            fold_body,
            in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, None),
        )

        def per_lambda(carry, inp):
            beta, active, resid, abs_grad_c, stopped = carry
            lmda, is_valid = inp
            run_it = is_valid & (~stopped)

            def run(args):
                beta, active, resid, abs_grad_c, stopped = args
                (beta_n, act_n, resid_n, abs_grad, done, kkt,
                 loss_full, loss_train) = vfold(
                    A, means_s, eigvals, eigvecs, beta, active, resid,
                    w_folds, X_means, lmda,
                )
                all_done = jnp.all(done)
                accept = all_done & jnp.all(kkt)
                val_loss = jnp.where(
                    w_val_sums > 0,
                    (loss_full - w_train_sums * loss_train) / w_val_sums,
                    0.0,
                )
                carry_n = (beta_n, act_n, resid_n, abs_grad, ~accept)
                emit = (val_loss, accept, all_done, jnp.ones((), bool))
                return carry_n, emit

            def skip(args):
                K_ = args[0].shape[0]
                emit = (jnp.zeros((K_,), dtype), jnp.zeros((), bool),
                        jnp.ones((), bool), jnp.zeros((), bool))
                return args, emit

            return jax.lax.cond(run_it, run, skip, carry)

        init = (beta0, active0, resid0,
                jnp.zeros((K, num_groups), dtype), jnp.zeros((), bool))
        carry, emits = jax.lax.scan(per_lambda, init, (lmdas, valid))
        return carry, emits

    return chunk_step


def get_cv_chunk_step(X, intercept: bool, num_groups: int):
    try:
        key = ("cv", X.structure_key(), bool(intercept), int(num_groups))
    except Exception:
        return build_cv_chunk_step(X, intercept, num_groups)
    hit = _STEP_CACHE.get(key)
    if hit is None:
        hit = _STEP_CACHE[key] = build_cv_chunk_step(X, intercept, num_groups)
    return hit


class BatchedCVGaussianDriver:
    """Lockstep fold-batched gaussian path driver emitting CV losses."""

    def __init__(self, X, y_raw, offsets, base_weights, weights_folds,
                 w_train_sums, w_val_sums, state: NaiveStateBase):
        self.s = state
        self.X = X
        K, n = weights_folds.shape
        self.K = K
        dtype = state.dtype
        self._step = get_cv_chunk_step(X, state.intercept, len(state.groups))
        mul_fn, X_data = X.mul_spec()
        self._X_data = X_data
        self._mul_fn = mul_fn

        # losses and the eta invariant use the RAW response
        # (eta = y_raw - resid + resid_sum); centering uses y - offsets
        self.y_full = jnp.asarray(y_raw, dtype)
        y_off = self.y_full - jnp.asarray(offsets, dtype)
        self.w_base = jnp.asarray(base_weights, dtype)
        self.w_folds = jnp.asarray(weights_folds, dtype)
        self.w_train_sums = jnp.asarray(w_train_sums, dtype)
        self.w_val_sums = jnp.asarray(w_val_sums, dtype)

        ones = jnp.ones((n,), dtype)
        # per-fold X column means and centered residuals
        self.X_means = jax.vmap(lambda w: mul_fn(X_data, ones, w))(
            self.w_folds
        )
        y_means = self.w_folds @ y_off
        if state.intercept:
            yc = y_off[None, :] - y_means[:, None]
        else:
            yc = jnp.broadcast_to(y_off, (K, n))
        self.resid = yc
        self._penalty_groups_dev = jnp.asarray(
            state.penalty.astype(dtype)
        )
        # per-fold host-side screen values
        self.beta_folds = np.zeros((K, 0), dtype)
        self.active_folds = np.zeros((K, 0), bool)
        self._weighted_version = -1
        self._is_screen_dev = None
        self._is_screen_version = -1
        self.losses = []          # list of (K,) per accepted lambda
        self.lmdas = []

    def _screen_mask(self):
        return self.s.screen_mask_dev()

    def _sync_fold_buffers(self, S_val):
        """Grow per-fold beta/active buffers after screen-set extension."""
        K = self.K
        if self.beta_folds.shape[1] < S_val:
            pad = S_val - self.beta_folds.shape[1]
            self.beta_folds = np.concatenate(
                [self.beta_folds, np.zeros((K, pad), self.beta_folds.dtype)],
                axis=1,
            )
        G_s = len(self.s.screen_set)
        if self.active_folds.shape[1] < G_s:
            pad = G_s - self.active_folds.shape[1]
            self.active_folds = np.concatenate(
                [self.active_folds, np.zeros((K, pad), bool)], axis=1
            )

    def _ensure_weighted(self, cache):
        if self._weighted_version != cache.version or cache.A is None:
            self.A, self.means_s = jax.vmap(
                screen_gram, in_axes=(None, 0, None)
            )(cache.Xs, self.w_folds, self.s.intercept)
            self.eigvals, self.eigvecs = jax.vmap(
                screen_eigh, in_axes=(0, None, None, None)
            )(self.A, cache.slot_begin, cache.slot_size, cache.qmax)
            cache.A = True  # marker: weighted quantities live on the driver
            self._weighted_version = cache.version

    def _run_chunk(self, lmdas, record):
        s = self.s
        cache = s.ensure_screen_cache()
        self._sync_fold_buffers(cache.S_val)
        self._ensure_weighted(cache)

        dtype = s.dtype
        C = int(s.lmda_chunk)
        lmdas = np.asarray(lmdas, float)
        nval = len(lmdas)
        lm_pad = np.full(C, lmdas[-1] if nval else 1.0)
        lm_pad[:nval] = lmdas
        valid = np.zeros(C, bool)
        valid[:nval] = True

        K = self.K
        beta0 = np.zeros((K, cache.S_cap), dtype)
        beta0[:, : cache.S_val] = self.beta_folds[:, : cache.S_val]
        active0 = np.zeros((K, cache.G_cap), bool)
        G_s = len(s.screen_set)
        active0[:, :G_s] = self.active_folds[:, :G_s]

        carry, emits = self._step(
            self._X_data,
            cache.Xs, cache.cols_padded, cache.slot_begin, cache.slot_size,
            cache.penalty_slots,
            s._group_ids, s._penalty_cols, self._penalty_groups_dev,
            self._screen_mask(),
            self.A, self.means_s, self.eigvals, self.eigvecs,
            jnp.asarray(beta0), jnp.asarray(active0), self.resid,
            self.w_folds, self.X_means,
            self.y_full, self.w_base, self.w_train_sums, self.w_val_sums,
            jnp.asarray(lm_pad, dtype), jnp.asarray(valid),
            jnp.asarray(s.alpha, dtype), jnp.asarray(s.tol, dtype),
            jnp.asarray(configs.dbeta_tol, dtype),
            jnp.asarray(s.newton_tol, dtype),
            jnp.asarray(s.newton_max_iters, jnp.int32),
            jnp.asarray(s.max_iters, jnp.int32),
        )
        beta_f, active_f, resid_f, abs_grad_f, _ = carry
        val_losses, accepts, dones, processed = emits

        (beta_h, active_h, abs_grad_h, losses_np, accepts_np, dones_np,
         processed_np) = jax.device_get(
            (beta_f, active_f, abs_grad_f, val_losses, accepts, dones,
             processed)
        )
        if np.any(processed_np & ~dones_np):
            raise MaxCDsError()

        n_proc = int(processed_np.sum())
        n_acc = int(accepts_np[:n_proc].sum())

        if record:
            for i in range(n_acc):
                self.losses.append(losses_np[i])
                self.lmdas.append(float(lm_pad[i]))
                s.n_valid_solutions.append(True)
            for i in range(n_acc, n_proc):
                s.n_valid_solutions.append(False)

        if n_proc:
            self.beta_folds = np.asarray(beta_h)[:, : cache.S_val].copy()
            self.active_folds = np.asarray(active_h)[:, :G_s].copy()
            self.resid = resid_f
            # screening signal: a screen set valid for EVERY fold
            s.abs_grad = np.asarray(abs_grad_h).max(axis=0)
            s.screen_is_active = self.active_folds.any(axis=0)
            s.lmda = float(lm_pad[n_proc - 1])
        return n_acc

    def solve(self, path):
        """Run the union-screen BASIL loop over the common path; returns
        (K, L) validation losses."""
        s = self.s
        sw = Stopwatch().start()
        # initial invariance at a huge lambda to seed abs_grad
        self._run_chunk([large_lmda(s.dtype)], record=False)

        idx = 0
        kkt_passed = True
        n_new_active = 0
        current_active = int(s.screen_is_active.sum())
        path = np.asarray(path, float)
        while idx < len(path):
            C = min(int(s.lmda_chunk), len(path) - idx)
            chunk = path[idx:idx + C]
            lmda_prev = path[idx + C - 2] if C > 1 else s.lmda
            screen(s, chunk[-1], kkt_passed, n_new_active,
                   lmda_prev=lmda_prev, lmda_fallback=chunk[0],
                   chunk_size=C)
            n_acc = self._run_chunk(chunk, record=True)
            idx += n_acc
            kkt_passed = n_acc == C
            if n_acc:
                new_active = int(s.screen_is_active.sum())
                n_new_active = new_active - current_active
                current_active = new_active
        s.total_time = sw.elapsed()
        return np.asarray(self.losses).T  # (K, L)


# --------------------------------------------------------------------------- #
# fold-batched GLM (IRLS) CV                                                   #
# --------------------------------------------------------------------------- #


def _with_weights(glm, w):
    """Trace-time view of ``glm`` with its weights swapped for ``w``.

    Every separable GLM (gaussian, binomial logit/probit, poisson) reads
    weights only through ``self.weights`` in elementwise products, so a
    shallow copy with a traced weights array yields weight-parameterized
    jittable ops — the device-side analog of the reference's
    ``glm.reweight`` (reference glm.py).  Cox gets a dedicated device view:
    its index machinery is weight-independent and every weight-derived
    array (tie means/sizes, Efron scale) is recomputed on device by
    ``GlmCox.weight_bundle``, so the fold axis vmaps straight through the
    at-risk suffix sums.
    """
    if getattr(glm, "name", "") == "cox":
        return glm.with_weights(w)
    import copy

    g = copy.copy(glm)
    g.weights = w
    return g


def build_cv_glm_chunk_step(glm, X, intercept: bool, num_groups: int,
                            qmax: int, dtype):
    """Fold-batched IRLS lambda-chunk: lax.scan over lambdas, vmap over
    folds of the fused IRLS fit (glm_fused.py) with per-fold weights,
    union screen set, and on-device validation losses."""
    from ..configs import configs as _cfg

    mul_fn, _ = X.mul_spec()
    hmin = (
        _cfg.hessian_min
        if jnp.dtype(dtype) == jnp.float64
        else _cfg.hessian_min_f32
    )

    @jax.jit
    def chunk_step(
        X_data,
        Xs, cols_padded, slot_begin, slot_size, penalty_slots,
        group_ids, penalty_cols, penalty_groups, is_screen_mask,
        # per-fold (leading K axis)
        beta0, active0, eta0, resid0, b0_init, w_folds,
        # shared
        offsets, w_base, w_train_sums, w_val_sums,
        lmdas, valid,
        alpha, tol_base, irls_tol, irls_max_iters,
        dbeta_tol, newton_tol, newton_max_iters, max_iters,
    ):
        K = beta0.shape[0]

        def fold_irls(beta_k, act_k, eta_k, resid_k, b0_k, w_k,
                      tol_base_k, lmda):
            g = _with_weights(glm, w_k)

            def hessian_floor(h):
                return jnp.maximum(h, 0.0) + hmin * (h <= 0)

            def irls_body(carry):
                beta, active, eta, resid, b0, _, it, _, pin_ok = carry
                grad_n = resid
                hess = hessian_floor(g.hessian(eta, grad_n))
                irls_resid = g.inv_hessian_gradient(eta, grad_n, hess)
                hess_sum = jnp.sum(hess)
                irls_w = hess / hess_sum
                irls_y = irls_resid + eta - offsets
                y_mean = jnp.vdot(irls_w, irls_y, precision=_PRECISION)
                if intercept:
                    irls_resid = irls_resid + (b0 - y_mean)
                resid_sum = jnp.vdot(irls_w, irls_resid,
                                     precision=_PRECISION)
                lmda_adj = lmda / hess_sum
                tol_adj = tol_base_k / hess_sum

                A, means_s = screen_gram(Xs, irls_w, intercept)
                eigvals, eigvecs = screen_eigh(
                    A, slot_begin, slot_size, qmax
                )
                wv = irls_w * irls_resid
                grad_s = jnp.einsum("ns,n->s", Xs, wv, precision=_PRECISION)
                if intercept:
                    grad_s = grad_s - means_s * resid_sum

                beta_n, _, active_n, _, _, done = pin_cov_solve(
                    A, grad_s, beta, slot_begin, slot_size, eigvals,
                    eigvecs, penalty_slots, active, lmda_adj, alpha,
                    tol_adj, dbeta_tol, newton_tol, newton_max_iters,
                    max_iters, jnp.zeros((), dtype),
                )
                dbeta = beta_n - beta
                irls_resid = irls_resid - jnp.matmul(
                    Xs, dbeta, precision=_PRECISION
                )
                resid_sum_n = jnp.vdot(irls_w, irls_resid,
                                       precision=_PRECISION)
                b0_n = jnp.where(intercept, y_mean + resid_sum_n, 0.0)
                eta_n = irls_y + offsets - irls_resid
                if intercept:
                    eta_n = eta_n + (b0_n - y_mean)
                resid_n = g.gradient(eta_n)
                crit = jnp.abs(jnp.vdot(resid_n - resid, eta_n - eta,
                                        precision=_PRECISION))
                it_n = jnp.where(jnp.isfinite(crit), it + 1, irls_max_iters)
                return (beta_n, active_n, eta_n, resid_n, b0_n, crit,
                        it_n, crit <= irls_tol, done)

            def irls_cond(carry):
                _, _, _, _, _, _, it, converged, pin_ok = carry
                return (~converged) & pin_ok & (it < irls_max_iters)

            init = (beta_k, act_k, eta_k, resid_k, b0_k,
                    jnp.asarray(jnp.inf, dtype), jnp.zeros((), jnp.int32),
                    jnp.zeros((), bool), jnp.ones((), bool))
            (beta, active, eta, resid, b0, _, _, converged,
             pin_ok) = jax.lax.while_loop(irls_cond, irls_body, init)

            # invariance + KKT for this fold
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
            sq = jax.ops.segment_sum(gadj * gadj, group_ids,
                                     num_segments=num_groups)
            abs_grad = jnp.sqrt(jnp.maximum(sq, 0.0))
            viol = abs_grad > lmda * alpha * penalty_groups
            kkt = ~jnp.any(viol & ~is_screen_mask)

            g_full = _with_weights(glm, w_base)
            loss_full = g_full.loss(eta)
            loss_train = g.loss(eta)
            return (beta, active, eta, resid, b0, abs_grad,
                    converged & pin_ok, kkt, loss_full, loss_train)

        vfold = jax.vmap(fold_irls, in_axes=(0, 0, 0, 0, 0, 0, 0, None))

        def per_lambda(carry, inp):
            beta, active, eta, resid, b0, abs_grad_c, stopped = carry
            lmda, is_valid = inp
            run_it = is_valid & (~stopped)

            def run(args):
                beta, active, eta, resid, b0, abs_grad_c, stopped = args
                (beta_n, act_n, eta_n, resid_n, b0_n, abs_grad, fit_ok,
                 kkt, loss_full, loss_train) = vfold(
                    beta, active, eta, resid, b0, w_folds, tol_base, lmda
                )
                accept = jnp.all(fit_ok) & jnp.all(kkt)
                val_loss = jnp.where(
                    w_val_sums > 0,
                    (loss_full - w_train_sums * loss_train) / w_val_sums,
                    0.0,
                )

                def commit(_):
                    return (beta_n, act_n, eta_n, resid_n, b0_n, abs_grad,
                            ~accept)

                def keep(_):
                    return (beta, active, eta, resid, b0, abs_grad,
                            jnp.ones((), bool))

                carry_n = jax.lax.cond(jnp.all(fit_ok), commit, keep, None)
                emit = (val_loss, accept, jnp.all(fit_ok),
                        jnp.ones((), bool))
                return carry_n, emit

            def skip(args):
                emit = (jnp.zeros((K,), dtype), jnp.zeros((), bool),
                        jnp.ones((), bool), jnp.zeros((), bool))
                return args, emit

            return jax.lax.cond(run_it, run, skip, carry)

        init = (beta0, active0, eta0, resid0, b0_init,
                jnp.zeros((K, num_groups), dtype), jnp.zeros((), bool))
        carry, emits = jax.lax.scan(per_lambda, init, (lmdas, valid))
        return carry, emits

    return chunk_step


def get_cv_glm_chunk_step(glm, X, intercept, num_groups, qmax, dtype):
    try:
        key = ("cvglm", id(glm), X.structure_key(), bool(intercept),
               int(num_groups), int(qmax), jnp.dtype(dtype).name)
    except Exception:
        return build_cv_glm_chunk_step(glm, X, intercept, num_groups, qmax,
                                       dtype)
    hit = _STEP_CACHE.get(key)
    if hit is None:
        hit = _STEP_CACHE[key] = build_cv_glm_chunk_step(
            glm, X, intercept, num_groups, qmax, dtype
        )
    return hit


class BatchedCVGlmDriver:
    """Lockstep fold-batched IRLS path driver emitting CV losses
    (separable GLMs: binomial logit/probit, poisson)."""

    def __init__(self, X, glm, offsets, base_weights, weights_folds,
                 w_train_sums, w_val_sums, state: NaiveStateBase,
                 irls_tol, irls_max_iters):
        self.s = state
        self.X = X
        self.glm = glm
        K, n = weights_folds.shape
        self.K = K
        dtype = state.dtype
        self._X_data = X.mul_spec()[1]
        self.offsets = jnp.asarray(offsets, dtype)
        self.w_base = jnp.asarray(base_weights, dtype)
        self.w_folds = jnp.asarray(weights_folds, dtype)
        self.w_train_sums = jnp.asarray(w_train_sums, dtype)
        self.w_val_sums = jnp.asarray(w_val_sums, dtype)
        self.irls_tol = float(irls_tol)
        self.irls_max_iters = int(irls_max_iters)
        self._penalty_groups_dev = jnp.asarray(state.penalty.astype(dtype))

        # per-fold cold-start iterates
        eta0 = jnp.broadcast_to(self.offsets, (K, n))
        import jax as _jax

        self.eta = jnp.asarray(eta0)
        self.resid = _jax.vmap(
            lambda w: _with_weights(glm, w).gradient(self.offsets)
        )(self.w_folds)
        self.b0 = jnp.zeros((K,), dtype)
        self.beta_folds = np.zeros((K, 0), dtype)
        self.active_folds = np.zeros((K, 0), bool)
        # per-fold tol scale: loss_null - loss_full of the TRAIN data;
        # approximated by the full-data quantities (tolerance scaling only)
        gl = glm
        self.loss_full_scalar = float(gl.loss_full())
        self.losses = []
        self.lmdas = []

    def _sync_fold_buffers(self, S_val):
        K = self.K
        if self.beta_folds.shape[1] < S_val:
            pad = S_val - self.beta_folds.shape[1]
            self.beta_folds = np.concatenate(
                [self.beta_folds, np.zeros((K, pad), self.beta_folds.dtype)],
                axis=1,
            )
        G_s = len(self.s.screen_set)
        if self.active_folds.shape[1] < G_s:
            pad = G_s - self.active_folds.shape[1]
            self.active_folds = np.concatenate(
                [self.active_folds, np.zeros((K, pad), bool)], axis=1
            )

    def _run_chunk(self, lmdas, record, tol_base):
        s = self.s
        cache = s.ensure_screen_cache()
        self._sync_fold_buffers(cache.S_val)
        step = get_cv_glm_chunk_step(
            self.glm, self.X, s.intercept, len(s.groups), cache.qmax,
            s.dtype,
        )
        dtype = s.dtype
        C = int(s.lmda_chunk)
        lmdas = np.asarray(lmdas, float)
        nval = len(lmdas)
        lm_pad = np.full(C, lmdas[-1] if nval else 1.0)
        lm_pad[:nval] = lmdas
        valid = np.zeros(C, bool)
        valid[:nval] = True

        K = self.K
        beta0 = np.zeros((K, cache.S_cap), dtype)
        beta0[:, : cache.S_val] = self.beta_folds[:, : cache.S_val]
        active0 = np.zeros((K, cache.G_cap), bool)
        G_s = len(s.screen_set)
        active0[:, :G_s] = self.active_folds[:, :G_s]

        carry, emits = step(
            self._X_data,
            cache.Xs, cache.cols_padded, cache.slot_begin, cache.slot_size,
            cache.penalty_slots,
            s._group_ids, s._penalty_cols, self._penalty_groups_dev,
            s.screen_mask_dev(),
            jnp.asarray(beta0), jnp.asarray(active0), self.eta, self.resid,
            self.b0, self.w_folds,
            self.offsets, self.w_base, self.w_train_sums, self.w_val_sums,
            jnp.asarray(lm_pad, dtype), jnp.asarray(valid),
            jnp.asarray(s.alpha, dtype), jnp.asarray(tol_base, dtype),
            jnp.asarray(self.irls_tol, dtype),
            jnp.asarray(self.irls_max_iters, jnp.int32),
            jnp.asarray(configs.dbeta_tol, dtype),
            jnp.asarray(s.newton_tol, dtype),
            jnp.asarray(s.newton_max_iters, jnp.int32),
            jnp.asarray(s.max_iters, jnp.int32),
        )
        (beta_f, active_f, eta_f, resid_f, b0_f, abs_grad_f, _) = carry
        val_losses, accepts, fitoks, processed = emits

        (beta_h, active_h, abs_grad_h, losses_np, accepts_np, fitok_np,
         processed_np) = jax.device_get(
            (beta_f, active_f, abs_grad_f, val_losses, accepts, fitoks,
             processed)
        )
        n_proc = int(processed_np.sum())
        n_acc = int(accepts_np[:n_proc].sum())
        if np.any(processed_np & ~fitok_np):
            raise MaxCDsError()

        if record:
            for i in range(n_acc):
                self.losses.append(losses_np[i])
                self.lmdas.append(float(lm_pad[i]))

        if n_proc:
            self.beta_folds = np.asarray(beta_h)[:, : cache.S_val].copy()
            self.active_folds = np.asarray(active_h)[:, :G_s].copy()
            self.eta = eta_f
            self.resid = resid_f
            self.b0 = b0_f
            s.abs_grad = np.asarray(abs_grad_h).max(axis=0)
            s.screen_is_active = self.active_folds.any(axis=0)
            s.lmda = float(lm_pad[n_proc - 1])
        return n_acc

    def solve(self, path, loss_null_scalar):
        s = self.s
        # null chunk runs with the full-data tolerance scale broadcast to
        # all folds (only gates the trivial intercept-only fit)
        tol0 = s.tol * (loss_null_scalar - self.loss_full_scalar)
        self._run_chunk([large_lmda(s.dtype)], record=False,
                        tol_base=np.full(self.K, tol0))
        # per-fold tol scale from each fold's OWN reweighted null/full
        # losses (ADVICE r2): after the null chunk, eta holds each fold's
        # null model, and both losses are cheap elementwise reductions
        loss_null_k, loss_full_k = jax.device_get(jax.jit(jax.vmap(
            lambda w, eta: (
                _with_weights(self.glm, w).loss(eta),
                _with_weights(self.glm, w).loss_full(),
            )
        ))(self.w_folds, self.eta))
        tol_base = s.tol * (np.asarray(loss_null_k, float)
                            - np.asarray(loss_full_k, float))
        idx = 0
        kkt_passed = True
        n_new_active = 0
        current_active = int(s.screen_is_active.sum())
        path = np.asarray(path, float)
        while idx < len(path):
            C = min(int(s.lmda_chunk), len(path) - idx)
            chunk = path[idx:idx + C]
            lmda_prev = path[idx + C - 2] if C > 1 else s.lmda
            screen(s, chunk[-1], kkt_passed, n_new_active,
                   lmda_prev=lmda_prev, lmda_fallback=chunk[0],
                   chunk_size=C)
            n_acc = self._run_chunk(chunk, record=True, tol_base=tol_base)
            idx += n_acc
            kkt_passed = n_acc == C
            if n_acc:
                new_active = int(s.screen_is_active.sum())
                n_new_active = new_active - current_active
                current_active = new_active
        return np.asarray(self.losses).T  # (K, L)
