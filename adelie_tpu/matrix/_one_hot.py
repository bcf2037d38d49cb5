"""Implicit one-hot expansion (reference matrix_naive_one_hot.{hpp,ipp};
factory matrix.py:1073, semantics documented there).

Device design: never materializes the expansion.  Column metadata
(feature index, level, continuous flag) is precomputed on host; the hot
ops are

* ``mul``    — continuous part is one matmul; ALL discrete features at
  once are one scatter-add ``out[outer[g] + Z_int[:, g]] += u_i``,
* ``tmul``   — one gather ``beta[outer[g] + Z_int[:, g]]`` + row-sum,
* ``gather`` — vectorized ``where(cont, Z[:, f], Z[:, f] == level)``.

``mean``/``var`` return 0/1 on one-hot columns so ``standardize`` leaves
indicator columns untouched (reference matrix_naive_one_hot.ipp:560-591).
"""

import jax
import jax.numpy as jnp
import numpy as np

from .base import MatrixNaiveBase

_PRECISION = jax.lax.Precision.HIGHEST


class MatrixNaiveOneHotDense(MatrixNaiveBase):
    def __init__(self, mat, levels=None, *, dtype=None):
        mat = np.asarray(mat)
        if dtype is None:
            dtype = mat.dtype if mat.dtype in (np.float32, np.float64) else np.float64
        self.dtype = np.dtype(dtype)
        n, d = mat.shape
        if levels is None:
            levels = np.zeros(d, dtype=int)
        levels = np.asarray(levels, int)
        assert levels.size == d

        widths = np.where(levels <= 0, 1, levels)
        outer = np.concatenate([[0], np.cumsum(widths)]).astype(np.int64)
        p = int(outer[-1])

        # per-column metadata
        col_feat = np.empty(p, np.int32)
        col_level = np.zeros(p, np.int32)
        col_cont = np.zeros(p, bool)
        for g in range(d):
            j = outer[g]
            if levels[g] <= 0:
                col_feat[j] = g
                col_cont[j] = True
            else:
                col_feat[j:j + levels[g]] = g
                col_level[j:j + levels[g]] = np.arange(levels[g])

        self._rows, self._cols = n, p
        self._d = d
        self._levels = levels
        self._outer = outer
        self._col_feat = col_feat
        self._col_level = col_level
        self._col_cont = col_cont

        self._Z = jnp.asarray(mat, self.dtype)
        disc = np.nonzero(levels > 0)[0]
        cont = np.nonzero(levels <= 0)[0]
        self._disc_feats = disc
        self._cont_feats = cont
        self._Z_cont = jnp.asarray(mat[:, cont], self.dtype)
        # scatter targets for ALL discrete features: outer[g] + Z_int[i, g]
        if len(disc):
            Z_disc_int = mat[:, disc].astype(np.int64)
            self._disc_idx = jnp.asarray(
                outer[disc][None, :] + Z_disc_int, jnp.int32
            )  # (n, n_disc)
        else:
            self._disc_idx = jnp.zeros((n, 0), jnp.int32)
        self._cont_cols = jnp.asarray(outer[cont], jnp.int32)

    def mul(self, v, w):
        f, data = self.mul_spec()
        return f(data, jnp.asarray(v), jnp.asarray(w))

    def mul_spec(self):
        p = self._cols

        def f(data, v, w):
            u = v * w
            out = jnp.zeros((p,), u.dtype)
            if data["Z_cont"].shape[1]:
                cont = jnp.einsum("nc,n->c", data["Z_cont"], u,
                                  precision=_PRECISION)
                out = out.at[data["cont_cols"]].set(cont)
            if data["disc_idx"].shape[1]:
                out = out.at[data["disc_idx"]].add(
                    jnp.broadcast_to(u[:, None], data["disc_idx"].shape)
                )
            return out

        return f, {"Z_cont": self._Z_cont, "cont_cols": self._cont_cols,
                   "disc_idx": self._disc_idx}

    def gather(self, indices):
        idx = np.asarray(indices, np.int64)
        feats = jnp.asarray(self._col_feat[idx])
        lvls = jnp.asarray(self._col_level[idx].astype(self.dtype.type))
        cont = jnp.asarray(self._col_cont[idx])
        Zc = jnp.take(self._Z, feats, axis=1)  # (n, k)
        return jnp.where(cont[None, :], Zc, (Zc == lvls[None, :]).astype(self.dtype))

    def tmul(self, beta):
        beta = jnp.asarray(beta, self.dtype)
        single = beta.ndim == 1
        if single:
            beta = beta[:, None]
        out = jnp.zeros((self._rows, beta.shape[1]), self.dtype)
        if self._Z_cont.shape[1]:
            out = out + jnp.matmul(
                self._Z_cont, beta[self._cont_cols], precision=_PRECISION
            )
        if self._disc_idx.shape[1]:
            out = out + jnp.sum(beta[self._disc_idx], axis=1)
        return out[:, 0] if single else out

    def sq_mul(self, w):
        w = jnp.asarray(w)
        out = jnp.zeros((self._cols,), w.dtype)
        if self._Z_cont.shape[1]:
            cont = jnp.einsum("nc,n->c", self._Z_cont**2, w, precision=_PRECISION)
            out = out.at[self._cont_cols].set(cont)
        if self._disc_idx.shape[1]:
            out = out.at[self._disc_idx].add(
                jnp.broadcast_to(w[:, None], self._disc_idx.shape)
            )
        return out

    def mean(self, w):
        out = np.asarray(super().mean(w)).copy()
        for g in self._disc_feats:
            j = self._outer[g]
            out[j:j + self._levels[g]] = 0.0
        return jnp.asarray(out, self.dtype)

    def var(self, centers, w):
        out = np.asarray(super().var(centers, w)).copy()
        for g in self._disc_feats:
            j = self._outer[g]
            out[j:j + self._levels[g]] = 1.0
        return jnp.asarray(out, self.dtype)
