"""Column subset selection via covariance method (reference solver.py:1274-
1430, solver_css_cov.hpp).

Greedy: start from the empty set, repeatedly add the column maximizing the
score, maintaining the residual covariance by rank-1 downdates.
Swapping: cycle positions, re-scoring every candidate against the residual
covariance w.r.t. the subset minus that position (re-derived here by a
fresh Cholesky solve — an O(k p^2) matmul instead of the reference's
incremental rank-1 Cholesky surgery, solver_css_cov.hpp:260-448).

Scores (reference compute_*_scores, solver_css_cov.hpp:18-137) are computed
for ALL candidates at once as vectorized array expressions — the device analog
of the reference's OpenMP-parallel per-candidate loops.
"""

from dataclasses import dataclass, field

import numpy as np

from ..exceptions import SolverError
from ..utils import Stopwatch

_EPS = 1e-10


@dataclass
class StateCSSCov:
    """Result state (reference state/state_css_cov.hpp)."""

    S: np.ndarray = None
    subset_size: int = 0
    subset: np.ndarray = None
    method: str = "swapping"
    loss: str = "least_squares"
    max_iters: int = 1000
    n_threads: int = 1
    benchmark_init: float = 0.0
    total_time: float = 0.0


def _scores_least_squares(S_resid, in_subset):
    """out[j] = ||S_resid[:, j]||^2 / S_jj (0 if selected or S_jj <= 0)."""
    diag = np.diag(S_resid)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(
            in_subset | (diag <= 0), 0.0,
            np.einsum("ij,ij->j", S_resid, S_resid) / np.where(diag <= 0, 1.0, diag),
        )
    return out, False


def _scores_subset_factor(S_resid, in_subset, j_to_swap=-1):
    """out[j] = -log S_jj - sum_{i not in T, i != j} log(S_ii - S_ij^2/S_jj)."""
    p = S_resid.shape[0]
    diag = np.diag(S_resid).copy()
    out = np.full(p, -np.inf)
    cand = ~in_subset
    free = ~in_subset  # the i-indices entering the sum
    early_exit = False
    for j in np.nonzero(cand)[0]:
        S_jj = diag[j]
        if S_jj <= 0:
            out[j] = np.inf
            early_exit = True
            continue
        r = diag - S_resid[:, j] ** 2 / S_jj
        mask = free.copy()
        mask[j] = False
        r_sel = r[mask]
        if np.any(r_sel <= _EPS):
            out[j] = np.inf
            early_exit = True
            continue
        out[j] = -np.log(S_jj) - np.log(r_sel).sum()
    if j_to_swap >= 0 and out[j_to_swap] == np.inf:
        return out, True
    return out, early_exit


def _scores_min_det(S_resid, in_subset):
    diag = np.diag(S_resid)
    out = -np.maximum(diag, 0.0)
    early_exit = bool(np.any((~in_subset) & (out >= -_EPS)))
    if early_exit:
        out = np.where((~in_subset) & (out >= -_EPS), 0.0, out)
    return out, early_exit


def _score_fn(loss):
    return {
        "least_squares": lambda Sr, mask, j=-1: _scores_least_squares(Sr, mask),
        "subset_factor": _scores_subset_factor,
        "min_det": lambda Sr, mask, j=-1: _scores_min_det(Sr, mask),
    }[loss]


def _downdate(S_resid, i):
    """Rank-1 residualization on column i (reference update_cov_resid_fwd)."""
    S_ii = S_resid[i, i]
    if S_ii <= 0:
        return S_resid
    col = S_resid[:, i].copy()
    return S_resid - np.outer(col, col) / S_ii


def _resid_given(S, subset):
    """Residual covariance S - S[:,T] S[T,T]^{-1} S[T,:] via Cholesky."""
    if len(subset) == 0:
        return S.copy(), True
    ST = S[np.ix_(subset, subset)]
    try:
        L = np.linalg.cholesky(ST)
    except np.linalg.LinAlgError:
        return None, False
    if np.any(np.diag(L) <= _EPS):
        return None, False
    B = np.linalg.solve(L, S[subset, :])  # (k, p)
    return S - B.T @ B, True


def _solve_greedy(S, subset_size, score, max_iters):
    p = S.shape[0]
    S_resid = S.copy().astype(np.float64)
    in_subset = np.zeros(p, bool)
    subset = []
    for _ in range(int(subset_size)):
        scores, _ = score(S_resid, in_subset)
        scores = np.where(in_subset, -np.inf, scores)
        i_star = int(np.argmax(scores))
        subset.append(i_star)
        in_subset[i_star] = True
        S_resid = _downdate(S_resid, i_star)
    return np.asarray(subset, int)


def _solve_swapping(S, subset, score, max_iters):
    p = S.shape[0]
    k = len(subset)
    if k <= 0 or k >= p:
        return subset
    subset = list(subset)
    in_subset = np.zeros(p, bool)
    in_subset[subset] = True

    # verify initial subset is independent (reference :254-280)
    _, ok = _resid_given(S, np.asarray(subset, int))
    if not ok:
        raise SolverError(
            "Initial subset are not linearly independent columns."
        )

    n_consec_keep = 0
    for _ in range(int(max_iters)):
        for jj in range(k):
            j = subset[jj]
            U = np.asarray(subset[:jj] + subset[jj + 1:], int)
            S_resid_U, ok = _resid_given(S, U)
            if not ok or S_resid_U[j, j] <= 0:
                # numerically unstable — terminate (reference :371-373)
                return np.asarray(subset, int)
            in_subset[j] = False
            scores, early_exit = score(S_resid_U, in_subset, j)
            masked = np.where(in_subset, -np.inf, scores)
            j_star = int(np.argmax(masked))
            if scores[j] < scores[j_star]:
                subset[jj] = j_star
                n_consec_keep = 0
            else:
                n_consec_keep += 1
            in_subset[subset[jj]] = True
            if n_consec_keep >= k or early_exit:
                return np.asarray(subset, int)
        else:
            continue
    raise SolverError("Maximum swapping cycles reached!")


def css_cov(
    S,
    subset_size: int = None,
    *,
    subset=None,
    method: str = "swapping",
    loss: str = "least_squares",
    max_iters: int = int(1e3),
    n_threads: int = 1,
):
    """Solve CSS via covariance method (reference solver.py:1274)."""
    sw = Stopwatch().start()
    S = np.asarray(S, np.float64)
    from ..utils import types

    loss = types.css_loss(loss, param="loss")
    method = types.css_method(method, param="method")
    score = _score_fn(loss)

    if method == "greedy":
        if not isinstance(subset_size, (int, np.integer)):
            raise ValueError("subset_size must be an integer for the greedy method.")
        if not (0 <= int(subset_size) <= S.shape[0]):
            raise ValueError(
                f"subset_size must be in [0, {S.shape[0]}] (p = number of "
                f"features); got {subset_size}."
            )
        result = _solve_greedy(S, subset_size, score, max_iters)
    elif method == "swapping":
        if subset is None:
            subset = _solve_greedy(S, subset_size, score, max_iters)
        subset = np.asarray(subset, int)
        result = _solve_swapping(S, list(subset), score, max_iters)
    else:
        raise ValueError(f"Unknown method: {method}")

    state = StateCSSCov(
        S=S, subset_size=len(result), subset=np.asarray(result, int),
        method=method, loss=loss, max_iters=max_iters, n_threads=n_threads,
    )
    state.total_time = sw.elapsed()
    return state
