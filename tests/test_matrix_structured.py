"""Structured matrix classes vs dense numpy ground truth
(reference tests/test_matrix.py pattern for sparse/one_hot/interaction/
convex_relu/constraint matrices)."""

import numpy as np
import pytest
import scipy.sparse as sp

from adelie_tpu import matrix as mx
from test_matrix import run_suite


def _one_hot_dense(Z, levels):
    cols = []
    for g in range(Z.shape[1]):
        if levels[g] <= 0:
            cols.append(Z[:, g:g + 1])
        else:
            I = np.zeros((Z.shape[0], levels[g]))
            I[np.arange(Z.shape[0]), Z[:, g].astype(int)] = 1.0
            cols.append(I)
    return np.concatenate(cols, axis=1)


def _interaction_dense(Z, pairs, levels):
    def ind(v, L):
        I = np.zeros((len(v), L))
        I[np.arange(len(v)), v.astype(int)] = 1.0
        return I

    def star(A, B):
        cols = []
        for b in range(B.shape[1]):
            for a in range(A.shape[1]):
                cols.append(A[:, a] * B[:, b])
        return np.stack(cols, axis=1)

    blocks = []
    for (i, j) in pairs:
        Li, Lj = levels[i], levels[j]
        Zi, Zj = Z[:, i], Z[:, j]
        if Li <= 0 and Lj <= 0:
            blocks.append(np.stack([Zi, Zj, Zi * Zj], axis=1))
        elif Li <= 0 < Lj:
            A = np.stack([np.ones_like(Zi), Zi], axis=1)
            blocks.append(star(A, ind(Zj, Lj)))
        elif Lj <= 0 < Li:
            B = np.stack([np.ones_like(Zj), Zj], axis=1)
            blocks.append(star(ind(Zi, Li), B))
        else:
            blocks.append(star(ind(Zi, Li), ind(Zj, Lj)))
    return np.concatenate(blocks, axis=1)


@pytest.mark.parametrize("n,p,density", [(25, 10, 0.3), (40, 15, 0.1)])
def test_sparse_naive(n, p, density):
    rng = np.random.default_rng(0)
    Z = rng.standard_normal((n, p)) * (rng.uniform(size=(n, p)) < density)
    m = mx.sparse(sp.csc_matrix(Z))
    run_suite(m, Z)


def test_sparse_cov():
    rng = np.random.default_rng(1)
    Z = rng.standard_normal((30, 8)) * (rng.uniform(size=(30, 8)) < 0.4)
    A = Z.T @ Z
    m = mx.sparse(sp.csc_matrix(A), method="cov")
    rows = np.array([0, 3, 5])
    cols = np.array([1, 2, 7])
    np.testing.assert_allclose(
        np.asarray(m.block(rows, cols)), A[np.ix_(rows, cols)], atol=1e-10
    )
    vals = rng.standard_normal(3)
    np.testing.assert_allclose(
        np.asarray(m.mul(cols, vals)), A[:, cols] @ vals, atol=1e-10
    )


def test_one_hot():
    rng = np.random.default_rng(2)
    n, d = 30, 5
    levels = np.array([0, 3, 0, 4, 2])
    Z = rng.standard_normal((n, d))
    for g in range(d):
        if levels[g] > 0:
            Z[:, g] = rng.integers(0, levels[g], n)
    dense = _one_hot_dense(Z, levels)
    m = mx.one_hot(Z, levels)

    rng2 = np.random.default_rng(3)
    v = rng2.standard_normal(n)
    w = np.abs(rng2.standard_normal(n)) + 0.01
    w /= w.sum()
    np.testing.assert_allclose(np.asarray(m.mul(v, w)), dense.T @ (w * v), atol=1e-9)
    idx = rng2.choice(dense.shape[1], 6, replace=False).astype(np.int32)
    np.testing.assert_allclose(np.asarray(m.gather(idx)), dense[:, idx], atol=1e-12)
    beta = rng2.standard_normal(dense.shape[1])
    np.testing.assert_allclose(np.asarray(m.tmul(beta)), dense @ beta, atol=1e-9)
    np.testing.assert_allclose(np.asarray(m.sq_mul(w)), (dense**2).T @ w, atol=1e-9)
    # discrete blocks: mean 0 / var 1 (reference one_hot.ipp:560-591)
    mean = np.asarray(m.mean(w))
    var = np.asarray(m.var(mean, w))
    expect_mean = dense.T @ w
    j = 0
    for g in range(d):
        width = max(levels[g], 1)
        if levels[g] > 0:
            assert np.all(mean[j:j + width] == 0)
            assert np.all(var[j:j + width] == 1)
        else:
            np.testing.assert_allclose(mean[j], expect_mean[j], atol=1e-9)
        j += width


@pytest.mark.parametrize("case", ["cont-cont", "cont-disc", "disc-cont", "disc-disc", "mixed"])
def test_interaction(case):
    rng = np.random.default_rng(4)
    n, d = 25, 4
    levels = {
        "cont-cont": np.array([0, 0, 0, 0]),
        "cont-disc": np.array([0, 3, 0, 2]),
        "disc-cont": np.array([3, 0, 2, 0]),
        "disc-disc": np.array([2, 3, 2, 2]),
        "mixed": np.array([0, 3, 0, 2]),
    }[case]
    Z = rng.standard_normal((n, d))
    for g in range(d):
        if levels[g] > 0:
            Z[:, g] = rng.integers(0, levels[g], n)
    intr_map = {0: [1, 2], 2: [3], 1: None} if case == "mixed" else {0: None, 1: [2, 3]}
    m = mx.interaction(Z, intr_map, levels)
    dense = _interaction_dense(Z, m.pairs, levels)
    assert m.cols() == dense.shape[1]

    rng2 = np.random.default_rng(5)
    v = rng2.standard_normal(n)
    w = np.abs(rng2.standard_normal(n)) + 0.01
    w /= w.sum()
    np.testing.assert_allclose(np.asarray(m.mul(v, w)), dense.T @ (w * v), atol=1e-9)
    idx = rng2.choice(dense.shape[1], min(8, dense.shape[1]), replace=False).astype(np.int32)
    np.testing.assert_allclose(np.asarray(m.gather(idx)), dense[:, idx], atol=1e-12)
    beta = rng2.standard_normal(dense.shape[1])
    np.testing.assert_allclose(np.asarray(m.tmul(beta)), dense @ beta, atol=1e-9)
    np.testing.assert_allclose(np.asarray(m.sq_mul(w)), (dense**2).T @ w, atol=1e-9)
    with pytest.raises(NotImplementedError):
        m.mean(w)


@pytest.mark.parametrize("gated", [True, False])
def test_convex_relu(gated):
    rng = np.random.default_rng(6)
    n, d, mgates = 20, 4, 3
    Z = rng.standard_normal((n, d))
    mask = rng.uniform(size=(n, mgates)) < 0.5
    Y = np.concatenate([mask[:, [k]] * Z for k in range(mgates)], axis=1)
    dense = Y if gated else np.concatenate([Y, -Y], axis=1)
    m = mx.convex_relu(Z, mask, gated=gated)
    run_suite(m, dense)


def test_constraint_dense_sparse():
    rng = np.random.default_rng(7)
    m_, d = 6, 4
    A = rng.standard_normal((m_, d)) * (rng.uniform(size=(m_, d)) < 0.6)
    for M in [mx.dense(A, method="constraint"),
              mx.sparse(sp.csr_matrix(A), method="constraint")]:
        assert (M.rows(), M.cols()) == (m_, d)
        Q = rng.standard_normal((d, d))
        np.testing.assert_allclose(np.asarray(M.rmmul(2, Q)), A[2] @ Q, atol=1e-10)
        v = rng.standard_normal(d)
        np.testing.assert_allclose(float(M.rvmul(1, v)), A[1] @ v, atol=1e-10)
        np.testing.assert_allclose(np.asarray(M.rvtmul(3, 2.5)), 2.5 * A[3], atol=1e-10)
        u = rng.standard_normal(m_)
        np.testing.assert_allclose(np.asarray(M.mul(u)), A.T @ u, atol=1e-10)
        np.testing.assert_allclose(np.asarray(M.tmul(v)), A @ v, atol=1e-10)
        np.testing.assert_allclose(np.asarray(M.cov(Q)), A @ Q @ A.T, atol=1e-10)
        idx = np.array([0, 2, 4])
        vals = rng.standard_normal(3)
        np.testing.assert_allclose(
            np.asarray(M.sp_mul(idx, vals)), A[idx].T @ vals, atol=1e-10
        )


def test_grpnet_on_structured():
    """End-to-end: grpnet on one_hot and sparse matrices matches dense."""
    import adelie_tpu as ad

    rng = np.random.default_rng(8)
    n, d = 80, 4
    levels = np.array([0, 3, 0, 2])
    Z = rng.standard_normal((n, d))
    for g in range(d):
        if levels[g] > 0:
            Z[:, g] = rng.integers(0, levels[g], n)
    dense = _one_hot_dense(Z, levels)
    y = dense @ rng.standard_normal(dense.shape[1]) + 0.1 * rng.standard_normal(n)
    glm = ad.glm.gaussian(y)

    st1 = ad.grpnet(mx.one_hot(Z, levels), glm, lmda_path_size=10,
                    min_ratio=0.1, progress_bar=False, early_exit=False)
    st2 = ad.grpnet(dense, glm, lmda_path_size=10, min_ratio=0.1,
                    progress_bar=False, early_exit=False)
    B1 = np.asarray(st1.betas.todense())
    B2 = np.asarray(st2.betas.todense())
    assert np.allclose(B1, B2, atol=1e-7), np.abs(B1 - B2).max()

    Zs = Z * (rng.uniform(size=Z.shape) < 0.5)
    ys = Zs @ rng.standard_normal(d) + 0.1 * rng.standard_normal(n)
    st3 = ad.grpnet(mx.sparse(sp.csc_matrix(Zs)), ad.glm.gaussian(ys),
                    lmda_path_size=10, min_ratio=0.1, progress_bar=False)
    st4 = ad.grpnet(Zs, ad.glm.gaussian(ys), lmda_path_size=10,
                    min_ratio=0.1, progress_bar=False)
    B3 = np.asarray(st3.betas.todense())
    B4 = np.asarray(st4.betas.todense())
    L = min(len(B3), len(B4))
    assert np.allclose(B3[:L], B4[:L], atol=1e-7)


def test_grpnet_wrapper_matrices():
    """standardize / concatenate / block_diag / subset through grpnet match
    the equivalent dense fits."""
    import adelie_tpu as ad

    rng = np.random.default_rng(10)
    n, p = 90, 8
    X = rng.standard_normal((n, p)) * 2 + 1
    y = X[:, 0] - X[:, 3] + 0.1 * rng.standard_normal(n)
    glm = ad.glm.gaussian(y)
    kw = dict(lmda_path_size=6, min_ratio=0.2, progress_bar=False,
              early_exit=False)

    # standardize == dense on the standardized matrix
    c = X.mean(0)
    s = np.sqrt(((X - c) ** 2).mean(0))
    st1 = ad.grpnet(mx.standardize(X), glm, **kw)
    st2 = ad.grpnet((X - c) / s, glm, **kw)
    np.testing.assert_allclose(
        np.asarray(st1.betas.todense()), np.asarray(st2.betas.todense()),
        atol=1e-8,
    )

    # concatenate == dense hstack
    A, B = X[:, :3], X[:, 3:]
    st3 = ad.grpnet(mx.concatenate([mx.dense(A), mx.dense(B)], axis=1),
                    glm, **kw)
    st4 = ad.grpnet(X, glm, **kw)
    np.testing.assert_allclose(
        np.asarray(st3.betas.todense()), np.asarray(st4.betas.todense()),
        atol=1e-8,
    )

    # column subset == dense on those columns
    idx = np.array([0, 2, 3, 7])
    st5 = ad.grpnet(mx.subset(X, idx, axis=1), glm, **kw)
    st6 = ad.grpnet(X[:, idx], glm, **kw)
    np.testing.assert_allclose(
        np.asarray(st5.betas.todense()), np.asarray(st6.betas.todense()),
        atol=1e-8,
    )

    # block_diag == dense block-diagonal (stacked problems)
    y2 = np.concatenate([y, y[::-1]])
    glm2 = ad.glm.gaussian(y2)
    Z = np.zeros((2 * n, 2 * p))
    Z[:n, :p] = X
    Z[n:, p:] = X
    st7 = ad.grpnet(mx.block_diag([mx.dense(X), mx.dense(X)]), glm2, **kw)
    st8 = ad.grpnet(Z, glm2, **kw)
    np.testing.assert_allclose(
        np.asarray(st7.betas.todense()), np.asarray(st8.betas.todense()),
        atol=1e-8,
    )


def test_gaussian_cov_structured_matrices():
    """gaussian_cov over block-diag and lazy covariance wrappers must match
    the dense covariance solve (end-to-end; the per-lambda solve_core
    path for non-dense A)."""
    import adelie_tpu as ad

    rng = np.random.default_rng(21)
    n, p = 100, 8
    X = rng.standard_normal((n, p))
    X[:, 4:] += 0.1  # make blocks non-trivial
    Xc = X - X.mean(0)
    y = X[:, 0] - X[:, 5] + 0.1 * rng.standard_normal(n)
    yc = y - y.mean()
    v = Xc.T @ yc / n

    S_full = Xc.T @ Xc / n
    # block-diagonal ground truth: zero the cross blocks
    S_bd = S_full.copy()
    S_bd[:4, 4:] = 0.0
    S_bd[4:, :4] = 0.0

    kw = dict(lmda_path_size=6, min_ratio=0.2, progress_bar=False)
    st_dense = ad.gaussian_cov(S_bd, v, **kw)
    assert st_dense.error == "", st_dense.error

    A_bd = mx.block_diag(
        [mx.dense(S_full[:4, :4], method="cov"),
         mx.dense(S_full[4:, 4:], method="cov")], method="cov",
    )
    st_bd = ad.gaussian_cov(A_bd, v, lmda_path=np.asarray(st_dense.lmdas),
                            progress_bar=False)
    assert st_bd.error == "", st_bd.error
    np.testing.assert_allclose(
        np.asarray(st_dense.betas.todense()),
        np.asarray(st_bd.betas.todense()), atol=1e-8,
    )

    # lazy covariance == dense covariance of the same X
    st_dense_full = ad.gaussian_cov(S_full, v, **kw)
    A_lazy = mx.lazy_cov(Xc / np.sqrt(n))
    st_lazy = ad.gaussian_cov(A_lazy, v,
                              lmda_path=np.asarray(st_dense_full.lmdas),
                              progress_bar=False)
    assert st_lazy.error == "", st_lazy.error
    np.testing.assert_allclose(
        np.asarray(st_dense_full.betas.todense()),
        np.asarray(st_lazy.betas.todense()), atol=1e-8,
    )


def test_gaussian_cov_rejects_naive_matrix():
    import adelie_tpu as ad

    rng = np.random.default_rng(22)
    S = np.eye(4)
    with pytest.raises(TypeError, match="method='cov'"):
        ad.gaussian_cov(mx.block_diag([S]), np.ones(4))


@pytest.mark.parametrize("layout", ["dense", "padded"])
def test_sparse_layouts_match_dense(layout):
    rng = np.random.default_rng(21)
    n, p = 35, 12
    Z = rng.standard_normal((n, p)) * (rng.uniform(size=(n, p)) < 0.25)
    Z[:, 4] = 0.0  # empty column
    Z[7, :] = 0.0  # empty row
    m = mx.sparse(sp.csc_matrix(Z), layout=layout)
    assert m.layout == layout
    run_suite(m, Z)


def test_sparse_auto_layout_selection():
    rng = np.random.default_rng(22)
    # dense-ish (>= 0.2% density, small footprint) -> densify (the
    # crossover, matrix/_sparse.py _DENSE_DENSITY_MIN)
    n, p = 60, 10
    Zd = rng.standard_normal((n, p)) * (rng.uniform(size=(n, p)) < 0.2)
    assert mx.sparse(sp.csc_matrix(Zd)).layout == "dense"
    # uniform sparsity BELOW the densify crossover -> padded (banded with
    # exactly 2 nnz per row / 4 per column: pad blowup exactly 1, density
    # 1e-3 < _DENSE_DENSITY_MIN)
    n, p = 4000, 2000
    rows = np.repeat(np.arange(n), 2)
    cols = np.concatenate([np.arange(n) % p, (np.arange(n) + 7) % p])
    Zu = sp.csc_matrix(
        (rng.standard_normal(2 * n), (rows, cols)), shape=(n, p))
    assert mx.sparse(Zu).layout == "padded"
    # extreme skew at low density: one dense column among near-empty
    # ones — the padded planes would be LARGER than the dense array, so
    # auto densifies (bcoo, the old skew fallback, was removed in r5:
    # measured half the padded bandwidth, VERDICT r4 #7)
    n, p = 6000, 1000
    Zs = np.zeros((n, p))
    Zs[:, 0] = rng.standard_normal(n)
    Zs[0, 1] = 1.0
    assert mx.sparse(sp.csc_matrix(Zs)).layout == "dense"
    with pytest.raises(ValueError, match="layout"):
        mx.sparse(sp.csc_matrix(Zd), layout="padddded")
    with pytest.raises(ValueError, match="bcoo.*removed"):
        mx.sparse(sp.csc_matrix(Zd), layout="bcoo")


@pytest.mark.parametrize("gated", [True, False])
def test_convex_relu_sparse_z(gated):
    """Sparse Z is NOT densified (reference sparse convex-ReLU kernels,
    matrix_naive_convex_relu.ipp sparse instantiations)."""
    rng = np.random.default_rng(23)
    n, d, mgates = 30, 5, 4
    Z = rng.standard_normal((n, d)) * (rng.uniform(size=(n, d)) < 0.3)
    mask = rng.uniform(size=(n, mgates)) < 0.5
    Y = np.concatenate([mask[:, [k]] * Z for k in range(mgates)], axis=1)
    dense = Y if gated else np.concatenate([Y, -Y], axis=1)
    m = mx.convex_relu(sp.csc_matrix(Z), mask, gated=gated)
    assert m._is_sparse
    run_suite(m, dense)


def test_grpnet_on_sparse_convex_relu():
    import adelie_tpu as ad

    rng = np.random.default_rng(24)
    n, d, mgates = 60, 4, 3
    Z = rng.standard_normal((n, d)) * (rng.uniform(size=(n, d)) < 0.4)
    mask = rng.uniform(size=(n, mgates)) < 0.5
    Y = np.concatenate([mask[:, [k]] * Z for k in range(mgates)], axis=1)
    y = Y @ rng.standard_normal(Y.shape[1]) + 0.1 * rng.standard_normal(n)
    glm = ad.glm.gaussian(y)
    st_sp = ad.grpnet(mx.convex_relu(sp.csc_matrix(Z), mask, gated=True),
                      glm, lmda_path_size=8, min_ratio=0.1,
                      progress_bar=False)
    st_de = ad.grpnet(mx.convex_relu(Z, mask, gated=True), glm,
                      lmda_path_size=8, min_ratio=0.1, progress_bar=False)
    B1 = np.asarray(st_sp.betas.todense())
    B2 = np.asarray(st_de.betas.todense())
    L = min(len(B1), len(B2))
    assert np.allclose(B1[:L], B2[:L], atol=1e-7), np.abs(B1[:L] - B2[:L]).max()
