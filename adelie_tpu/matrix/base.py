"""Matrix protocol for adelie_tpu.

Device re-design of the reference's ``MatrixNaiveBase`` virtual interface
(reference: adelie/src/include/adelie_core/matrix/matrix_naive_base.hpp:57-143).

Design differences from the reference (deliberate, see SURVEY.md section 7):

* The reference's solver calls ``cmul``/``ctmul``/``bmul``/``btmul`` (each an
  O(n) pass) inside the coordinate-descent loop.  The device solver instead
  *materializes the screened column block once* via :meth:`gather` and runs CD
  in covariance form, so the per-class hot ops are only:

  - :meth:`mul`     — full weighted gradient  ``X^T (w * v)``  (one matmul)
  - :meth:`gather`  — densify a set of columns into an ``(n, k)`` HBM block
  - :meth:`sq_mul`  — weighted squared column norms
  - :meth:`tmul`    — forward product ``X @ beta`` for predictions

* All methods are functional (return arrays) rather than writing into output
  buffers; everything returned is a ``jax.Array`` usable inside ``jit``.

The remaining reference interface methods (``cmul``, ``ctmul``, ``bmul``,
``btmul``, ``cov``, ``sp_tmul``, ``mean``, ``var``) are provided generically on
top of the hot ops for API parity and testing.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_PRECISION = jax.lax.Precision.HIGHEST


def _as2d(idx):
    return np.asarray(idx, dtype=np.int32)


class MatrixNaiveBase:
    """Abstract base; see module docstring.

    Subclasses must set ``_rows``, ``_cols``, ``dtype`` and implement
    ``mul``, ``gather``, ``tmul``.  Default ``sq_mul``/``mean``/``var`` are
    derived from ``gather`` in column chunks (override for efficiency).
    """

    _rows: int
    _cols: int
    dtype: np.dtype
    _mesh = None  # jax.sharding.Mesh when the observation axis is sharded

    @property
    def shape(self):
        return (self._rows, self._cols)

    @property
    def ndim(self):
        return 2

    def rows(self) -> int:
        return self._rows

    def cols(self) -> int:
        return self._cols

    # ------------------------------------------------------------------ #
    # hot ops — subclasses implement                                      #
    # ------------------------------------------------------------------ #

    def mul(self, v, w):
        """``X^T (w * v)`` -> (p,).  Reference: matrix_naive_base.hpp ``mul``."""
        f, data = self.mul_spec()
        return f(data, jnp.asarray(v), jnp.asarray(w))

    def mul_spec(self):
        """Return ``(pure_fn, data_pytree)`` with ``pure_fn(data, v, w) ==
        X^T (w*v)``.

        The pure function must NOT close over device arrays — the matrix
        payload travels through ``data`` so jitted solver steps take it as an
        argument (closed-over arrays become XLA constants, which both bloat
        the HLO and defeat compile caching across datasets).  Wrappers
        compose their children's specs.
        """
        raise NotImplementedError

    def mul_many(self, U):
        """``X^T U_c`` for every row of ``U`` ((C, n), each row already
        weight-multiplied) -> (p, C).  The streamed drivers batch a whole
        lambda chunk's gradients through this.  Default: one ``mul`` per
        row; payload-holding subclasses override with a single fused pass
        (dense: one matmul; streamed SNP: one sweep over the packed
        bytes)."""
        U = jnp.asarray(U, self.dtype)
        ones = jnp.ones((self.rows(),), U.dtype)
        return jnp.stack(
            [self.mul(U[c], ones) for c in range(U.shape[0])], axis=1
        )

    def structure_key(self):
        """Hashable key identifying the *structure* (not data) baked into
        ``mul_spec``'s pure function — used to share compiled solver steps
        across matrix instances with identical structure."""
        key = (type(self).__name__, self._rows, self._cols,
               str(getattr(self, "dtype", "")))
        child = getattr(self, "_child", None)
        if child is not None:
            key = key + (child.structure_key(),)
        children = getattr(self, "_children", None)
        if children is not None:
            key = key + tuple(c.structure_key() for c in children)
        return key

    def gather(self, indices):
        """Densify columns ``indices`` -> (n, k) jax array."""
        raise NotImplementedError

    def tmul(self, beta):
        """``X @ beta`` for dense ``beta`` (p,) or (p, L) -> (n,) / (n, L)."""
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # derived ops with generic fallbacks                                  #
    # ------------------------------------------------------------------ #

    _CHUNK = 4096

    def _chunked_cols(self):
        p = self._cols
        for s in range(0, p, self._CHUNK):
            idx = np.arange(s, min(s + self._CHUNK, p), dtype=np.int32)
            yield s, self.gather(idx)

    def sq_mul(self, w):
        """Weighted squared column norms ``diag(X^T W X)`` -> (p,)."""
        w = jnp.asarray(w)
        outs = [jnp.einsum("nk,n->k", blk * blk, w, precision=_PRECISION)
                for _, blk in self._chunked_cols()]
        return jnp.concatenate(outs)

    def mean(self, w):
        """Weighted column means ``X^T w`` (weights assumed to sum to 1)."""
        w = jnp.asarray(w)
        return self.mul(jnp.ones_like(w), w)

    def var(self, centers, w):
        """Weighted column variances about ``centers``.

        Reference semantics (matrix.py var): sum_i w_i (X_ij - c_j)^2.
        """
        w = jnp.asarray(w)
        c = jnp.asarray(centers)
        return self.sq_mul(w) - 2 * c * self.mul(jnp.ones_like(w), w) + (c * c) * jnp.sum(w)

    # --- reference-parity block/column ops (built on gather/mul/tmul) --- #

    def cmul(self, j, v, w):
        """``X[:, j]^T (w * v)`` (reference ``cmul``)."""
        col = self.gather(_as2d([j]))[:, 0]
        return jnp.vdot(col, jnp.asarray(v) * jnp.asarray(w), precision=_PRECISION)

    def ctmul(self, j, v):
        """``v * X[:, j]`` -> (n,) (reference ``ctmul`` without accumulation)."""
        col = self.gather(_as2d([j]))[:, 0]
        return v * col

    def bmul(self, j, q, v, w):
        """``X[:, j:j+q]^T (w * v)`` -> (q,) (reference ``bmul``)."""
        blk = self.gather(np.arange(j, j + q, dtype=np.int32))
        return jnp.einsum("nq,n->q", blk, jnp.asarray(v) * jnp.asarray(w),
                          precision=_PRECISION)

    def btmul(self, j, q, v):
        """``X[:, j:j+q] @ v`` -> (n,) (reference ``btmul``)."""
        blk = self.gather(np.arange(j, j + q, dtype=np.int32))
        return blk @ jnp.asarray(v)

    def cov(self, j, q, sqrt_weights):
        """Weighted Gram of columns [j, j+q) (reference ``cov``)."""
        blk = self.gather(np.arange(j, j + q, dtype=np.int32))
        sw = jnp.asarray(sqrt_weights)[:, None]
        blk = blk * sw
        return jnp.einsum("nq,nr->qr", blk, blk, precision=_PRECISION)

    def sp_tmul(self, betas):
        """``betas @ X^T`` for a scipy.sparse CSR ``betas`` (L, p) -> (L, n).

        Reference ``sp_tmul`` — used for path predictions.  Gathers the union
        of nonzero columns once, then one matmul.
        """
        import scipy.sparse as sp

        betas = sp.csr_matrix(betas)
        cols = np.unique(betas.indices)
        if cols.size == 0:
            return jnp.zeros((betas.shape[0], self._rows), self.dtype)
        blk = self.gather(cols.astype(np.int32))  # (n, k)
        sub = jnp.asarray(betas[:, cols].toarray(), dtype=self.dtype)  # (L, k)
        return jnp.einsum("lk,nk->ln", sub, blk, precision=_PRECISION)

    # --- numpy-style sugar (reference matrix.py:40-196) --- #

    def __matmul__(self, other):
        return np.asarray(self.tmul(jnp.asarray(other, self.dtype)))

    @property
    def T(self):
        """Lazy transpose view supporting ``X.T @ v`` (reference
        matrix.py:40-77 ``PyMatrixNaiveTranspose``)."""
        return MatrixNaiveTranspose(self)

    def __getitem__(self, key):
        rows, cols = self._parse_key(key)
        blk = np.asarray(self.gather(cols))
        return blk[rows]

    def _parse_key(self, key):
        if not isinstance(key, tuple):
            key = (key, slice(None))
        rkey, ckey = key
        if isinstance(ckey, slice):
            cols = np.arange(*ckey.indices(self._cols), dtype=np.int32)
        elif np.isscalar(ckey):
            cols = np.array([ckey], dtype=np.int32)
        else:
            cols = np.asarray(ckey, dtype=np.int32)
        return rkey, cols

    def to_dense(self):
        return np.asarray(self.gather(np.arange(self._cols, dtype=np.int32)))


class MatrixCovBase:
    """Covariance-matrix protocol (reference matrix_cov_base.hpp:41-63).

    Used by the covariance-method solver: provides access to slices of a
    p x p PSD matrix ``A`` without necessarily materializing it.
    """

    _cols: int
    dtype: np.dtype

    def cols(self) -> int:
        return self._cols

    @property
    def shape(self):
        return (self._cols, self._cols)

    def block(self, rows, cols):
        """Materialize ``A[np.ix_(rows, cols)]`` -> (len(rows), len(cols))."""
        raise NotImplementedError

    def mul(self, indices, values):
        """``A[:, indices] @ values`` -> (p,) (reference ``mul``)."""
        raise NotImplementedError

    def to_dense(self):
        idx = np.arange(self._cols, dtype=np.int32)
        return np.asarray(self.block(idx, idx))

    def bmul(self, subset, indices, values):
        """``A[subset][:, indices] @ values`` (reference ``bmul``)."""
        full = self.mul(indices, values)
        return jnp.asarray(full)[jnp.asarray(np.asarray(subset, np.int32))]


class MatrixConstraintBase:
    """Constraint-matrix protocol (reference matrix_constraint_base.hpp:28-76).

    Represents the ``A`` in linear constraints ``lower <= A beta <= upper``.
    Functional API: ``rmmul``/``rvmul``/``rvtmul``/``mul``/``tmul``/``cov``.
    """

    _rows: int
    _cols: int
    dtype: np.dtype

    def rows(self) -> int:
        return self._rows

    def cols(self) -> int:
        return self._cols

    def dense(self):
        """Materialize A -> (m, d) jax array."""
        raise NotImplementedError

    def rmmul(self, j, Q):
        """``A[j] @ Q`` -> (d,)."""
        return jnp.matmul(self.dense()[j], jnp.asarray(Q),
                          precision=_PRECISION)

    def rvmul(self, j, v):
        """``A[j] . v`` -> scalar."""
        return jnp.vdot(self.dense()[j], jnp.asarray(v))

    def rvtmul(self, j, v):
        """``v * A[j]`` -> (d,)."""
        return v * self.dense()[j]

    def mul(self, v):
        """``A^T v`` -> (d,)."""
        return self.dense().T @ jnp.asarray(v)

    def tmul(self, v):
        """``A v`` -> (m,)."""
        return self.dense() @ jnp.asarray(v)

    def cov(self, Q):
        """``A Q A^T`` -> (m, m)."""
        A = self.dense()
        return A @ jnp.asarray(Q) @ A.T

    def sp_mul(self, indices, values):
        """``A[indices]^T values`` -> (d,)."""
        A = self.dense()
        idx = jnp.asarray(np.asarray(indices, np.int32))
        vals = jnp.asarray(values)
        return A[idx].T @ vals


class MatrixNaiveTranspose:
    """Lazy ``X.T`` view over a :class:`MatrixNaiveBase` (reference
    matrix.py:40-77).  Supports ``X.T @ v`` for 1-D or 2-D ``v`` by
    reducing to unweighted ``mul`` calls (``X^T v == mul(v, ones)``);
    nothing is densified."""

    def __init__(self, mat):
        self._mat = mat
        self.ndim = 2

    @property
    def shape(self):
        n, p = self._mat.shape
        return (p, n)

    @property
    def T(self):
        return self._mat

    def __matmul__(self, v):
        v = np.asarray(v)
        if v.ndim < 1 or v.ndim > 2:
            raise ValueError("Right argument must be 1 or 2-dimensional.")
        n = self._mat.rows()
        ones = jnp.ones((n,), self._mat.dtype)
        if v.ndim == 1:
            return np.asarray(self._mat.mul(jnp.asarray(v, self._mat.dtype), ones))
        cols = [np.asarray(self._mat.mul(jnp.asarray(v[:, i], self._mat.dtype), ones))
                for i in range(v.shape[1])]
        return np.stack(cols, axis=1)
