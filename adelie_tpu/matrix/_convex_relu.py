"""Convex (gated) ReLU feature matrices (reference
matrix_naive_convex_relu.{hpp,ipp}, ..._gated_relu.{hpp,ipp}; factory +
math matrix.py:390-470; sparse instantiations via the dense/sparse template
parameter pairs in src/py_matrix.cpp).

Gated:  Y = [D_1 Z, ..., D_m Z]          (n, m*d)
Full:   X = [Y, -Y]                       (n, 2*m*d)

where D_k = diag(mask[:, k]).  All ops factor through the mask:
e.g. ``Y^T u`` column block k is ``Z^T (mask_k * u)``, computed for ALL k
at once — dense Z rides one einsum (``'nd,nm,n->md'``); sparse Z keeps
its sparsity via the padded CSC/CSR planes of matrix/_sparse.py, so the
same product is one vectorized gather of the masked (n, m) right-hand side
plus a lane reduction (no densification, no scatters — the device analog of
the reference's sparse convex-ReLU kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np

from .base import MatrixNaiveBase

_PRECISION = jax.lax.Precision.HIGHEST


class MatrixNaiveConvexGatedRelu(MatrixNaiveBase):
    def __init__(self, mat, mask, *, dtype=None):
        import scipy.sparse as sp

        self._is_sparse = sp.issparse(mat)
        mask = np.asarray(mask).astype(bool)
        if self._is_sparse:
            mat = sp.csc_matrix(mat)
            if dtype is None:
                dtype = mat.dtype if mat.dtype in (np.float32, np.float64) \
                    else np.float64
            self.dtype = np.dtype(dtype)
            n, d = mat.shape
            from ._sparse import MatrixNaiveSparse

            self._Zsp = MatrixNaiveSparse(mat, dtype=self.dtype,
                                          layout="padded")
            self._Zhost = self._Zsp._csc
        else:
            mat = np.asarray(mat)
            if dtype is None:
                dtype = mat.dtype if mat.dtype in (np.float32, np.float64) \
                    else np.float64
            self.dtype = np.dtype(dtype)
            n, d = mat.shape
            self._Z = jnp.asarray(mat, self.dtype)
        assert mask.shape[0] == n
        m = mask.shape[1]
        self._rows = n
        self._d = d
        self._m = m
        self._cols = m * d
        self._mask = jnp.asarray(mask, self.dtype)

    def structure_key(self):
        key = (type(self).__name__, self._rows, self._cols,
               self._is_sparse, str(self.dtype))
        if self._is_sparse:
            key += self._Zsp.structure_key()
        return key

    # -- data payloads ---------------------------------------------------- #

    def _spec_data(self):
        if self._is_sparse:
            return {
                "cvals": self._Zsp._cvals, "cidx": self._Zsp._cidx,
                "rvals": self._Zsp._rvals, "ridx": self._Zsp._ridx,
                "mask": self._mask,
            }
        return {"Z": self._Z, "mask": self._mask}

    @staticmethod
    def _mul_md(data, u, square=False):
        """(m*d,) block vector ``[Z^T (mask_k * u)]_k`` (optionally Z**2)."""
        mask = data["mask"]
        if "Z" in data:
            Z = data["Z"] ** 2 if square else data["Z"]
            out = jnp.einsum("nd,nm,n->md", Z, mask, u,
                             precision=_PRECISION)
            return out.reshape(-1)
        # sparse: gather masked RHS rows per nnz lane
        U = mask * u[:, None]                       # (n, m)
        G = jnp.take(U, data["cidx"], axis=0)       # (d, L, m)
        vals = data["cvals"] ** 2 if square else data["cvals"]
        out = jnp.einsum("dl,dlm->md", vals, G, precision=_PRECISION)
        return out.reshape(-1)

    @staticmethod
    def _tmul_n(data, B):
        """(n,) product ``sum_k mask_k * (Z @ B_k)`` for B (m, d)."""
        mask = data["mask"]
        if "Z" in data:
            ZB = jnp.einsum("nd,md->nm", data["Z"], B, precision=_PRECISION)
            return jnp.einsum("nm,nm->n", ZB, mask, precision=_PRECISION)
        Bt = B.T                                    # (d, m)
        G = jnp.take(Bt, data["ridx"], axis=0)      # (n, Lr, m)
        ZB = jnp.einsum("nl,nlm->nm", data["rvals"], G,
                        precision=_PRECISION)
        return jnp.einsum("nm,nm->n", ZB, mask, precision=_PRECISION)

    # -- protocol ops ----------------------------------------------------- #

    def mul(self, v, w):
        f, data = self.mul_spec()
        return f(data, jnp.asarray(v), jnp.asarray(w))

    def mul_spec(self):
        def f(data, v, w):
            return MatrixNaiveConvexGatedRelu._mul_md(data, v * w)

        return f, self._spec_data()

    def gather(self, indices):
        idx = np.asarray(indices, np.int64)
        k = (idx // self._d).astype(np.int32)
        j = (idx % self._d).astype(np.int32)
        if self._is_sparse:
            Zc = jnp.asarray(
                np.asarray(self._Zhost[:, j].todense()), self.dtype
            )
        else:
            Zc = jnp.take(self._Z, jnp.asarray(j), axis=1)
        Mc = jnp.take(self._mask, jnp.asarray(k), axis=1)
        return Zc * Mc

    def tmul(self, beta):
        beta = jnp.asarray(beta, self.dtype)
        B = beta.reshape(self._m, self._d)
        return self._tmul_n(self._spec_data(), B)

    def sq_mul(self, w):
        return self._mul_md(self._spec_data(), jnp.asarray(w), square=True)


class MatrixNaiveConvexRelu(MatrixNaiveConvexGatedRelu):
    """X = [Y, -Y] (reference matrix_naive_convex_relu)."""

    def __init__(self, mat, mask, *, dtype=None):
        super().__init__(mat, mask, dtype=dtype)
        self._half = self._cols
        self._cols = 2 * self._half

    def mul_spec(self):
        def f(data, v, w):
            half = MatrixNaiveConvexGatedRelu._mul_md(data, v * w)
            return jnp.concatenate([half, -half])

        return f, self._spec_data()

    def gather(self, indices):
        idx = np.asarray(indices, np.int64)
        sign = np.where(idx < self._half, 1.0, -1.0).astype(self.dtype)
        base = super().gather(idx % self._half)
        return base * jnp.asarray(sign)[None, :]

    def tmul(self, beta):
        beta = jnp.asarray(beta, self.dtype)
        eff = beta[: self._half] - beta[self._half:]
        return super().tmul(eff)

    def sq_mul(self, w):
        half = super().sq_mul(w)
        return jnp.concatenate([half, half])
