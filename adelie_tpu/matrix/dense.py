"""Dense matrix classes.

Reference: ``MatrixNaiveDense`` (matrix_naive_dense.{hpp,ipp}) and
``MatrixCovDense`` (matrix_cov_dense.{hpp,ipp}).  Here the whole matrix is a
device-resident ``jax.Array`` (optionally sharded over rows via
``adelie_tpu.parallel``), and every op is a single fused XLA computation:
the reference's blocked-OpenMP kernels (matrix/utils.hpp) collapse into
matmuls.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .base import MatrixCovBase, MatrixNaiveBase

_PRECISION = jax.lax.Precision.HIGHEST


@jax.jit
def _mul(X, v, w):
    return jnp.einsum("n,np->p", v * w, X, precision=_PRECISION)


@jax.jit
def _tmul(X, beta):
    return jnp.matmul(X, beta, precision=_PRECISION)


@jax.jit
def _sq_mul(X, w):
    return jnp.einsum("np,n->p", X * X, w, precision=_PRECISION)


class MatrixNaiveDense(MatrixNaiveBase):
    def __init__(self, mat, *, dtype=None, device_put=True):
        mat = np.asarray(mat)
        if dtype is None:
            dtype = mat.dtype if mat.dtype in (np.float32, np.float64) else np.float32
        self.dtype = np.dtype(dtype)
        self._rows, self._cols = mat.shape
        self._mat = jnp.asarray(mat, dtype=self.dtype)

    @property
    def mat(self):
        return self._mat

    def mul(self, v, w):
        f, data = self.mul_spec()
        return f(data, jnp.asarray(v), jnp.asarray(w))

    def mul_many(self, U):
        return jnp.einsum(
            "cn,np->pc", jnp.asarray(U, self.dtype), self._mat,
            precision=_PRECISION,
        )

    def mul_spec(self):
        from ..configs import configs

        if configs.compensated_reductions and getattr(self, "_mesh", None) is None:
            from ..utils import compensated

            chunk = int(configs.compensated_chunk)

            def f(data, v, w):
                return compensated.mul_tn(data["mat"], v * w, chunk=chunk)
        else:
            def f(data, v, w):
                return jnp.einsum(
                    "n,np->p", v * w, data["mat"], precision=_PRECISION
                )

        return f, {"mat": self._mat}

    def gather(self, indices):
        return jnp.take(self._mat, jnp.asarray(np.asarray(indices, np.int32)), axis=1)

    def tmul(self, beta):
        return _tmul(self._mat, jnp.asarray(beta, self.dtype))

    def sq_mul(self, w):
        return _sq_mul(self._mat, jnp.asarray(w))


class MatrixCovDense(MatrixCovBase):
    def __init__(self, mat, *, dtype=None):
        mat = np.asarray(mat)
        if dtype is None:
            dtype = mat.dtype if mat.dtype in (np.float32, np.float64) else np.float32
        self.dtype = np.dtype(dtype)
        assert mat.shape[0] == mat.shape[1]
        self._cols = mat.shape[0]
        self._mat = jnp.asarray(mat, dtype=self.dtype)

    def block(self, rows, cols):
        r = jnp.asarray(np.asarray(rows, np.int32))
        c = jnp.asarray(np.asarray(cols, np.int32))
        return self._mat[jnp.ix_(r, c)]

    def mul(self, indices, values):
        idx = jnp.asarray(np.asarray(indices, np.int32))
        vals = jnp.asarray(values, self.dtype)
        return jnp.take(self._mat, idx, axis=1) @ vals


class MatrixCovLazy(MatrixCovBase):
    """Lazy covariance: computes blocks of ``X^T W X`` on demand with caching.

    Reference: ``MatrixCovLazyCov`` (matrix_cov_lazy_cov.hpp:31-33).  Caches
    per-column slices ``A[:, j]`` so repeated screen-set growth only pays for
    new columns; each new batch of columns is one (n x p)^T (n x k) matmul.
    """

    def __init__(self, X, weights=None, *, dtype=None):
        X = np.asarray(X)
        if dtype is None:
            dtype = X.dtype if X.dtype in (np.float32, np.float64) else np.float32
        self.dtype = np.dtype(dtype)
        self._n, self._cols = X.shape
        self._X = jnp.asarray(X, self.dtype)
        w = np.full(self._n, 1.0) if weights is None else np.asarray(weights)
        self._w = jnp.asarray(w, self.dtype)
        self._cache = {}  # col -> np.ndarray (p,)

    def _ensure(self, cols):
        new = [int(c) for c in np.asarray(cols).ravel() if int(c) not in self._cache]
        if new:
            idx = jnp.asarray(np.asarray(new, np.int32))
            blk = jnp.take(self._X, idx, axis=1) * self._w[:, None]
            out = jnp.einsum("np,nk->pk", self._X, blk, precision=_PRECISION)
            out = np.asarray(out)
            for i, c in enumerate(new):
                self._cache[c] = out[:, i]

    def block(self, rows, cols):
        self._ensure(cols)
        full = np.stack([self._cache[int(c)] for c in np.asarray(cols).ravel()], axis=1)
        return jnp.asarray(full[np.asarray(rows, np.int32)], self.dtype)

    def mul(self, indices, values):
        self._ensure(indices)
        full = np.stack([self._cache[int(c)] for c in np.asarray(indices).ravel()], axis=1)
        return jnp.asarray(full, self.dtype) @ jnp.asarray(values, self.dtype)
