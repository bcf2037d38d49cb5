"""K-fold cross-validation.

Reference semantics (adelie/cv.py): folds are validated **by
zero-weighting** — the training fit runs with validation weights set to 0
and renormalized, and the validation loss is recovered as
``(full-data loss - train-weight-sum * train loss) / val-weight-sum``.

Device-first redesign (this file is NOT a port of reference cv.py):

* Every fold is fitted EXACTLY on the common full-data lambda grid, so the
  reference's per-fold path augmentation + interpolation machinery
  (reference cv.py:254-292) is unnecessary: solutions at the grid are
  exact, not interpolated.  (Lambdas above a fold's own lambda_max simply
  yield that fold's null model, which is the exact solution there.)
* On the gaussian fast path, all K folds are fitted SIMULTANEOUSLY by the
  fold-batched driver (solver/cv_batched.py): one fused device call per
  lambda chunk advances every fold (vmap over the fold axis, union screen
  set), and validation losses are computed on device — fold parallelism
  instead of the reference's serial fold loop (reference cv.py:239), as
  SURVEY §2.12 prescribes.
* GLM / constrained / multi-response problems fall back to a serial fold
  loop that still uses exact common-grid fits.
"""

import logging
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from . import matrix as matrix_mod
from .configs import f32_contractions
from .diagnostic import coefficient, predict
from .logger import logger
from .solver import grpnet


@dataclass
class CVGrpnetResult:
    """Result of K-fold CV (reference cv.py:25)."""

    lmdas: np.ndarray
    losses: np.ndarray        # (K, L)
    avg_losses: np.ndarray
    best_idx: int

    def plot_loss(self):
        """Mean CV loss along the path (role of reference cv.py:47).

        Redesigned: mean loss as a line with a +-1 sd band (the K-fold
        spread), and the selected lambda marked explicitly so the plot
        answers "which lambda did CV pick and how confidently".
        """
        from . import _plotstyle as ps

        fig, ax = ps.styled_axes(
            f"{self.losses.shape[0]}-fold CV loss", r"$\lambda$",
            "mean validation loss",
        )
        xs = ps.lambda_axis(ax, self.lmdas)
        mean = np.mean(self.losses, axis=0)
        sd = np.std(self.losses, axis=0, ddof=0)
        ax.fill_between(xs, mean - sd, mean + sd, color=ps.PALETTE[0],
                        alpha=0.15, linewidth=0, zorder=1,
                        label=r"$\pm 1$ sd across folds")
        ax.plot(xs, mean, color=ps.PALETTE[0], linewidth=2.0, zorder=3,
                label="mean loss")
        bi = int(self.best_idx)
        ax.axvline(xs[bi], color=ps.PALETTE[1], linewidth=1.0,
                   linestyle="--", zorder=2)
        ax.scatter([xs[bi]], [mean[bi]], s=36, color=ps.PALETTE[1],
                   zorder=4, label=rf"best $\lambda$ = {xs[bi]:.3g}")
        ps.legend(ax)
        return fig, ax

    def fit(self, X, glm, **grpnet_params):
        """Refit on the full data down to the best lambda (reference
        cv.py:76-127).

        CV-only arguments (``n_folds``, ``seed``, ``fold_batch``) and
        arguments this refit pins itself (``early_exit``, ``lmda_path``)
        are dropped so the same kwargs dict used for ``cv_grpnet`` can be
        forwarded here (the sklearn wrapper does exactly that).
        """
        for k in ("n_folds", "seed", "early_exit", "lmda_path", "fold_batch"):
            grpnet_params.pop(k, None)
        with _quiet_logger():
            state = grpnet(X=X, glm=glm, lmda_path_size=0, progress_bar=False,
                           **_structural(grpnet_params))

        lmda_path_size = grpnet_params.pop("lmda_path_size", 100)
        lmda_star = self.lmdas[self.best_idx]
        full_lmdas = state.lmda_max * np.logspace(
            0, np.log10(lmda_star / state.lmda_max), lmda_path_size
        )
        return grpnet(
            X=X, glm=glm, lmda_path=full_lmdas, early_exit=False,
            **grpnet_params,
        )


class _quiet_logger:
    def __enter__(self):
        self._level = logger.level
        logger.setLevel(logging.ERROR)
        return self

    def __exit__(self, *exc):
        logger.setLevel(self._level)
        return False


def _rows(X):
    if isinstance(X, matrix_mod.MatrixNaiveBase):
        return X.rows()
    return np.asarray(X).shape[0]


def _fold_assignments(n, n_folds, seed):
    """Shuffle observations into K nearly-equal folds; returns a list of
    validation-index arrays."""
    rng = np.random.RandomState(seed) if seed is not None else np.random
    order = rng.choice(n, n, replace=False)
    bounds = np.linspace(0, n, n_folds + 1).astype(int)
    return [order[bounds[k]:bounds[k + 1]] for k in range(n_folds)]


# grpnet kwargs that change the problem STRUCTURE and therefore lmda_max;
# the dry runs computing the common grid must honor them
_STRUCTURAL_KEYS = ("groups", "alpha", "penalty", "offsets", "intercept",
                    "constraints")


def _structural(grpnet_params):
    return {k: grpnet_params[k] for k in _STRUCTURAL_KEYS
            if k in grpnet_params}


def _common_path(X, glm, min_ratio, lmda_path_size, grpnet_params):
    """Full-data lambda_max -> log-spaced common grid (honoring the
    structure-affecting kwargs: alpha halves/doubles lmda_max, groups and
    penalty reweight it).  Returns (lmdas, dry_state)."""
    state = grpnet(X=X, glm=glm, lmda_path_size=0, progress_bar=False,
                   **_structural(grpnet_params))
    lmdas = state.lmda_max * np.logspace(0, np.log10(min_ratio),
                                         lmda_path_size)
    return lmdas, state


_SEPARABLE_GLMS = ("binomial_logit", "binomial_probit", "poisson")


def _can_batch(X, glm, grpnet_params):
    """Fold batching: the gaussian fast path, a separable single-response
    GLM (weights enter only elementwise), or cox (whose weight-derived
    tie/at-risk arrays are recomputed on device per fold,
    GlmCox.weight_bundle) — in all cases the fold axis vmaps through the
    fused IRLS.  Multi/constrained/host-streamed fall back to serial
    (the fold-batched programs embed the matrix payload in a fused
    device program; a streamed matrix streams per fold instead)."""
    if getattr(glm, "is_multi", False):
        return False
    if grpnet_params.get("constraints") is not None:
        return False
    if getattr(X, "is_streaming", False):
        return False
    if glm.name == "gaussian" and getattr(glm, "opt", False):
        return True
    return glm.name in _SEPARABLE_GLMS or glm.name == "cox"


@f32_contractions
def cv_grpnet(
    X,
    glm,
    *,
    n_threads: int = 1,
    early_exit: bool = False,
    min_ratio: float = 1e-1,
    lmda_path_size: int = 100,
    n_folds: int = 5,
    seed: int = None,
    fold_batch: bool = None,
    **grpnet_params,
):
    """K-fold CV group elastic net (reference cv.py:130).

    ``fold_batch``: run all folds in one fold-batched device program
    (gaussian fast path only).  Default: auto (batched when eligible).
    """
    n = _rows(X)
    grpnet_params = dict(grpnet_params)
    grpnet_params.pop("progress_bar", None)
    grpnet_params.pop("ddev_tol", None)

    val_sets = _fold_assignments(n, n_folds, seed)
    base_weights = np.asarray(glm.weights)

    with _quiet_logger():
        full_lmdas, dry_state = _common_path(X, glm, min_ratio,
                                             lmda_path_size, grpnet_params)

        use_batch = _can_batch(X, glm, grpnet_params) if fold_batch is None \
            else bool(fold_batch)
        if use_batch and not _can_batch(X, glm, grpnet_params):
            raise ValueError(
                "fold_batch=True requires the gaussian fast path or a "
                "separable GLM (binomial/poisson) without constraints or "
                "multi-response."
            )
        if use_batch and glm.name == "gaussian":
            cv_losses = _cv_batched(
                X, glm, base_weights, val_sets, full_lmdas,
                grpnet_params,
            )
        elif use_batch:
            cv_losses = _cv_batched_glm(
                X, glm, base_weights, val_sets, full_lmdas,
                grpnet_params, dry_state,
            )
        else:
            cv_losses = _cv_serial(
                X, glm, base_weights, val_sets, full_lmdas,
                early_exit, n_threads, grpnet_params,
            )

    avg_losses = np.mean(cv_losses, axis=0)
    best_idx = int(np.argmin(avg_losses))
    return CVGrpnetResult(
        lmdas=full_lmdas, losses=cv_losses, avg_losses=avg_losses,
        best_idx=best_idx,
    )


def _fold_weights(base_weights, val_idx):
    """Zero-weighted, renormalized training weights for one fold."""
    w = base_weights.copy()
    w[val_idx] = 0
    w_sum = float(w.sum())
    return w / w_sum, w_sum, float(base_weights[val_idx].sum())


def _cv_batched(X, glm, base_weights, val_sets, full_lmdas, grpnet_params):
    """All folds in one fold-batched device program (gaussian only)."""
    from .solver import _as_matrix
    from .solver.cv_batched import BatchedCVGaussianDriver
    from .solver.state_core import NaiveStateBase

    X = _as_matrix(X)
    dtype = np.dtype(X.dtype)
    n, p = X.rows(), X.cols()
    K = len(val_sets)

    w_folds = np.empty((K, n))
    w_train_sums = np.empty(K)
    w_val_sums = np.empty(K)
    for k, vidx in enumerate(val_sets):
        w_folds[k], w_train_sums[k], w_val_sums[k] = _fold_weights(
            base_weights, vidx
        )

    groups = grpnet_params.get("groups")
    if groups is None:
        groups = np.arange(p, dtype=int)
    groups = np.asarray(groups, int)
    group_sizes = np.diff(np.concatenate([groups, [p]])).astype(int)
    G = len(groups)
    penalty = grpnet_params.get("penalty")
    if penalty is None:
        penalty = np.sqrt(group_sizes).astype(float)
    alpha = float(grpnet_params.get("alpha", 1.0))
    intercept = bool(grpnet_params.get("intercept", True))

    state = NaiveStateBase(
        X=X, groups=groups, group_sizes=group_sizes, alpha=alpha,
        penalty=np.asarray(penalty, float), intercept=intercept,
        dtype=dtype, n=n, p=p,
        tol=float(grpnet_params.get("tol", 1e-7)),
        max_iters=int(grpnet_params.get("max_iters", int(1e5))),
        newton_tol=float(grpnet_params.get("newton_tol", 1e-12)),
        newton_max_iters=int(grpnet_params.get("newton_max_iters", 1000)),
        screen_rule=grpnet_params.get("screen_rule", "pivot"),
        pivot_subset_ratio=float(grpnet_params.get("pivot_subset_ratio", 0.1)),
        pivot_subset_min=int(grpnet_params.get("pivot_subset_min", 1)),
        pivot_slack_ratio=float(grpnet_params.get("pivot_slack_ratio", 1.25)),
        max_screen_size=grpnet_params.get("max_screen_size"),
        max_active_size=grpnet_params.get("max_active_size"),
        screen_set=np.zeros(0, int), screen_begins=np.zeros(0, int),
        screen_beta=np.zeros(0, dtype), screen_is_active=np.zeros(0, bool),
    )
    # seed like the single-fit path: screen-all fast path for small
    # problems (zero BASIL retries, stable compile shapes), else the
    # unpenalized groups
    from .configs import configs as _cfg

    if p + int(group_sizes.max()) <= _cfg.screen_all_max:
        seed_groups = np.arange(G)
    else:
        seed_groups = np.arange(G)[(state.penalty <= 0) | (alpha <= 0)]
    state.extend_screen_set(seed_groups)
    state.screen_is_active = (state.penalty[state.screen_set] <= 0) | (alpha <= 0)

    offsets = grpnet_params.get("offsets")
    offsets = np.zeros(n, dtype) if offsets is None else np.asarray(offsets)

    driver = BatchedCVGaussianDriver(
        X, np.asarray(glm.y), offsets, base_weights, w_folds,
        w_train_sums, w_val_sums, state,
    )
    return driver.solve(full_lmdas)  # (K, L)


def _cv_batched_glm(X, glm, base_weights, val_sets, full_lmdas,
                    grpnet_params, dry_state):
    """All folds of a separable GLM in one fold-batched IRLS program."""
    from .configs import configs as _cfg
    from .solver import _as_matrix
    from .solver.cv_batched import BatchedCVGlmDriver
    from .solver.state_core import NaiveStateBase

    X = _as_matrix(X)
    dtype = np.dtype(X.dtype)
    n, p = X.rows(), X.cols()
    K = len(val_sets)

    w_folds = np.empty((K, n))
    w_train_sums = np.empty(K)
    w_val_sums = np.empty(K)
    for k, vidx in enumerate(val_sets):
        w_folds[k], w_train_sums[k], w_val_sums[k] = _fold_weights(
            base_weights, vidx
        )

    groups = grpnet_params.get("groups")
    if groups is None:
        groups = np.arange(p, dtype=int)
    groups = np.asarray(groups, int)
    group_sizes = np.diff(np.concatenate([groups, [p]])).astype(int)
    G = len(groups)
    penalty = grpnet_params.get("penalty")
    if penalty is None:
        penalty = np.sqrt(group_sizes).astype(float)
    alpha = float(grpnet_params.get("alpha", 1.0))
    intercept = bool(grpnet_params.get("intercept", True))

    state = NaiveStateBase(
        X=X, groups=groups, group_sizes=group_sizes, alpha=alpha,
        penalty=np.asarray(penalty, float), intercept=intercept,
        dtype=dtype, n=n, p=p,
        tol=float(grpnet_params.get("tol", 1e-7)),
        max_iters=int(grpnet_params.get("max_iters", int(1e5))),
        newton_tol=float(grpnet_params.get("newton_tol", 1e-12)),
        newton_max_iters=int(grpnet_params.get("newton_max_iters", 1000)),
        screen_rule=grpnet_params.get("screen_rule", "pivot"),
        pivot_subset_ratio=float(grpnet_params.get("pivot_subset_ratio", 0.1)),
        pivot_subset_min=int(grpnet_params.get("pivot_subset_min", 1)),
        pivot_slack_ratio=float(grpnet_params.get("pivot_slack_ratio", 1.25)),
        max_screen_size=grpnet_params.get("max_screen_size"),
        max_active_size=grpnet_params.get("max_active_size"),
        screen_set=np.zeros(0, int), screen_begins=np.zeros(0, int),
        screen_beta=np.zeros(0, dtype), screen_is_active=np.zeros(0, bool),
    )
    if p + int(group_sizes.max()) <= _cfg.screen_all_max:
        seed_groups = np.arange(G)
    else:
        seed_groups = np.arange(G)[(state.penalty <= 0) | (alpha <= 0)]
    state.extend_screen_set(seed_groups)
    state.screen_is_active = (state.penalty[state.screen_set] <= 0) | (alpha <= 0)

    offsets = grpnet_params.get("offsets")
    offsets = np.zeros(n, dtype) if offsets is None else np.asarray(offsets)

    driver = BatchedCVGlmDriver(
        X, glm, offsets, base_weights, w_folds, w_train_sums, w_val_sums,
        state,
        irls_tol=float(grpnet_params.get("irls_tol", 1e-7)),
        irls_max_iters=int(grpnet_params.get("irls_max_iters", int(1e4))),
    )
    return driver.solve(full_lmdas, float(dry_state.loss_null))


def _cv_serial(X, glm, base_weights, val_sets, full_lmdas, early_exit,
               n_threads, grpnet_params):
    """Serial fold loop with exact common-grid fits (GLM-general path)."""
    import scipy.sparse

    K = len(val_sets)
    cv_losses = np.empty((K, full_lmdas.shape[0]))
    for k, vidx in enumerate(val_sets):
        w_norm, w_train_sum, w_val_sum = _fold_weights(base_weights, vidx)
        glm_k = glm.reweight(w_norm)
        state = grpnet(
            X=X, glm=glm_k, ddev_tol=0, n_threads=n_threads,
            early_exit=early_exit, lmda_path=full_lmdas,
            progress_bar=False, **grpnet_params,
        )
        # exact fits at the grid; interpolate only the (early-exited) tail.
        # The fit ran with lmda_path=full_lmdas, so recorded solutions align
        # POSITIONALLY with a prefix of the grid — match by index (absolute
        # decimal rounding would collapse sub-1e-14 lambdas, ADVICE r2)
        fit_lmdas = np.asarray(state.lmdas, float)
        n_fit = len(fit_lmdas)
        aligned = n_fit <= len(full_lmdas) and np.allclose(
            fit_lmdas, full_lmdas[:n_fit], rtol=1e-9, atol=0.0
        )
        betas, intercepts = [], []
        for j, lmda in enumerate(full_lmdas):
            if aligned and j < n_fit:
                betas.append(state.betas[j])
                intercepts.append(state.intercepts[j])
            else:
                b, b0 = coefficient(
                    lmda=lmda, betas=state.betas,
                    intercepts=state.intercepts, lmdas=state.lmdas,
                )
                betas.append(b)
                intercepts.append(b0)
        betas = scipy.sparse.vstack(betas)
        intercepts = np.asarray(intercepts)

        offs = getattr(state, "offsets", None)
        offs = offs if offs is not None and np.any(np.asarray(offs)) else None
        etas = predict(X=X, betas=betas, intercepts=intercepts, offsets=offs)
        loss_full = np.array([float(glm.loss(jnp.asarray(e))) for e in etas])
        loss_train = w_train_sum * np.array(
            [float(glm_k.loss(jnp.asarray(e))) for e in etas]
        )
        cv_losses[k] = (
            (loss_full - loss_train) / w_val_sum if w_val_sum > 0 else 0.0
        )
    return cv_losses
