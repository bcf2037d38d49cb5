"""Sparse matrices (reference matrix_naive_sparse.{hpp,ipp},
matrix_cov_sparse.{hpp,ipp}; factory matrix.py:1301; sparse kernels
matrix/utils.hpp:362-1015).

Design: unstructured sparse products are bounded by the device's
dynamic-gather rate, which sits far below the dense stream rate, so
beating dense at density d needs ~d * 2 * (dense rate) of useful sparse
bandwidth.  The design is therefore:

* ``dense`` above the measured crossover (~0.2% density, with margin)
  whenever the dense array fits ``_DENSE_BYTES_MAX`` — the fast path;
* ``padded`` CSC/CSR planes below it (static-shape (p, L) value/index
  planes; one vectorized gather + lane reduction, no scatters) — below
  the crossover this wins on BOTH footprint and time, and it is the
  correctness path for matrices too big to densify;
* the BCOO lowering that used to be the skew fallback was removed: it
  ran at half the padded path's bandwidth with no remaining niche —
  extreme-skew matrices take the padded planes (memory-hungry on skew,
  but correct) or densify when the dense array is the smaller object.

The host keeps scipy CSC for structural ops (screen-block
densification), which is how screened fits consume sparse inputs — the
full-matrix products above only run in the BASIL gradient/KKT passes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from .base import MatrixCovBase, MatrixNaiveBase

_PRECISION = jax.lax.Precision.HIGHEST

# Above this density (and below the device-memory cap) "auto" DENSIFIES:
# the speed crossover sits where the dense stream's 4 B per entry costs
# as much as the gathers' 8 B per nonzero at the gather rate.  The value
# comes from earlier hardware and is not measured on this card yet;
# below it the padded planes win on footprint.
_DENSE_DENSITY_MIN = 2e-3
_DENSE_BYTES_MAX = 2 << 30


def _padded_planes(mat_csc, dtype):
    """Build (vals, idx) padded planes for a scipy CSC/CSR matrix along its
    compressed axis.  Returns None when the matrix has no entries."""
    counts = np.diff(mat_csc.indptr)
    L = int(counts.max()) if counts.size else 0
    if L == 0:
        return None
    m = len(counts)
    vals = np.zeros((m, L), dtype)
    idx = np.zeros((m, L), np.int32)
    # vectorized fill: position of each nnz within its column
    order = np.arange(mat_csc.nnz) - np.repeat(mat_csc.indptr[:-1], counts)
    rows = np.repeat(np.arange(m), counts)
    vals[rows, order] = mat_csc.data
    idx[rows, order] = mat_csc.indices
    return vals, idx


class MatrixNaiveSparse(MatrixNaiveBase):
    """Sparse (n, p) feature matrix.

    ``layout``: ``"auto"`` (default) DENSIFIES above ~0.2% density when
    the dense array fits ~2 GB (measured crossover, see
    ``_DENSE_DENSITY_MIN``); below it builds padded planes, except when
    nnz skew makes the padded planes LARGER than the (cap-respecting)
    dense array — then dense wins on both axes.  ``"dense"`` /
    ``"padded"`` force.
    """

    def __init__(self, mat, *, dtype=None, layout: str = "auto"):
        mat = sp.csc_matrix(mat)
        if dtype is None:
            dtype = mat.dtype if mat.dtype in (np.float32, np.float64) else np.float64
        if layout == "bcoo":
            raise ValueError(
                "layout='bcoo' was removed (r5): it measured half the "
                "padded path's bandwidth with no remaining niche; use "
                "'auto', 'padded' or 'dense'."
            )
        if layout not in ("auto", "padded", "dense"):
            raise ValueError(
                f"layout must be one of ['auto', 'dense', 'padded'],"
                f" got {layout!r}"
            )
        self.dtype = np.dtype(dtype)
        self._rows, self._cols = mat.shape
        self._csc = mat.astype(self.dtype)

        csr = self._csc.tocsr()
        Lc = int(np.diff(self._csc.indptr).max()) if self._cols else 0
        Lr = int(np.diff(csr.indptr).max()) if self._rows else 0
        if layout == "auto":
            density = self._csc.nnz / max(self._rows * self._cols, 1)
            dense_bytes = self._rows * self._cols * self.dtype.itemsize
            padded_bytes = (self._cols * Lc + self._rows * Lr) * \
                (self.dtype.itemsize + 4)
            if dense_bytes <= _DENSE_BYTES_MAX and (
                    density >= _DENSE_DENSITY_MIN
                    or padded_bytes >= dense_bytes):
                layout = "dense"
            else:
                if padded_bytes > max(_DENSE_BYTES_MAX, 2 * dense_bytes):
                    # nnz skew blows the padded planes past BOTH the
                    # device budget and the (too-big-to-build) dense
                    # array — since the compact BCOO fallback was
                    # removed (measured loser, r5), refuse loudly
                    # instead of silently allocating an OOM-sized plane
                    raise ValueError(
                        f"sparse auto-layout: padded planes would be "
                        f"{padded_bytes / 1e9:.1f} GB (max column nnz "
                        f"{Lc}, max row nnz {Lr}) and the dense array "
                        f"{dense_bytes / 1e9:.1f} GB. Split the matrix "
                        f"(matrix.concatenate of column blocks), densify "
                        f"the skewed columns separately, or pass "
                        f"layout='padded' explicitly to override."
                    )
                layout = "padded"
        self.layout = layout

        if layout == "dense":
            self._dense = jnp.asarray(
                np.asarray(self._csc.todense()), self.dtype)
        elif layout == "padded":
            pc = _padded_planes(self._csc, self.dtype)
            pr = _padded_planes(csr, self.dtype)
            zc = (np.zeros((self._cols, 1), self.dtype),
                  np.zeros((self._cols, 1), np.int32))
            zr = (np.zeros((self._rows, 1), self.dtype),
                  np.zeros((self._rows, 1), np.int32))
            cvals, cidx = pc if pc is not None else zc
            rvals, ridx = pr if pr is not None else zr
            self._cvals = jnp.asarray(cvals)
            self._cidx = jnp.asarray(cidx)
            self._rvals = jnp.asarray(rvals)
            self._ridx = jnp.asarray(ridx)
        else:
            raise AssertionError(layout)

    def structure_key(self):
        key = (type(self).__name__, self._rows, self._cols, self.layout,
               str(self.dtype))
        if self.layout == "padded":
            key += (self._cvals.shape[1], self._rvals.shape[1])
        return key

    def mul(self, v, w):
        f, data = self.mul_spec()
        return f(data, jnp.asarray(v), jnp.asarray(w))

    def mul_spec(self):
        if self.layout == "dense":
            def f(data, v, w):
                return jnp.einsum("n,np->p", v * w, data["mat"],
                                  precision=_PRECISION)

            return f, {"mat": self._dense}
        assert self.layout == "padded"

        def f(data, v, w):
            u = v * w
            g = jnp.take(u, data["cidx"], axis=0)  # (p, L) gather
            return jnp.sum(data["cvals"] * g, axis=1)

        return f, {"cvals": self._cvals, "cidx": self._cidx}

    def gather(self, indices):
        idx = np.asarray(indices, np.int64)
        blk = np.asarray(self._csc[:, idx].todense())
        return jnp.asarray(blk, self.dtype)

    def tmul(self, beta):
        beta = jnp.asarray(beta, self.dtype)
        if self.layout == "dense":
            return jnp.matmul(self._dense, beta, precision=_PRECISION)
        assert self.layout == "padded"
        g = jnp.take(beta, self._ridx, axis=0)  # (n, Lr)
        return jnp.sum(self._rvals * g, axis=1)

    def sq_mul(self, w):
        w = jnp.asarray(w)
        if self.layout == "dense":
            return jnp.einsum("n,np->p", w, self._dense * self._dense,
                              precision=_PRECISION)
        if self.layout == "padded":
            g = jnp.take(w, self._cidx, axis=0)
            return jnp.sum(self._cvals**2 * g, axis=1)
        sq = self._csc.copy()
        sq.data = sq.data**2
        return jnp.asarray(sq.T @ np.asarray(w), self.dtype)


class MatrixCovSparse(MatrixCovBase):
    """Sparse PSD matrix (reference matrix_cov_sparse)."""

    def __init__(self, mat, *, dtype=None):
        mat = sp.csc_matrix(mat)
        if dtype is None:
            dtype = mat.dtype if mat.dtype in (np.float32, np.float64) else np.float64
        self.dtype = np.dtype(dtype)
        assert mat.shape[0] == mat.shape[1]
        self._cols = mat.shape[0]
        self._csc = mat.astype(self.dtype)

    def block(self, rows, cols):
        sub = self._csc[:, np.asarray(cols, np.int64)].tocsr()
        sub = sub[np.asarray(rows, np.int64), :]
        return jnp.asarray(np.asarray(sub.todense()), self.dtype)

    def mul(self, indices, values):
        idx = np.asarray(indices, np.int64)
        out = self._csc[:, idx] @ np.asarray(values, self.dtype)
        return jnp.asarray(np.asarray(out).ravel(), self.dtype)
