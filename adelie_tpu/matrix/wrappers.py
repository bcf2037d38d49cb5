"""Composition wrappers: standardize / subset / concatenate / block-diag /
kronecker-eye.

References: ``MatrixNaiveStandardize`` (matrix_naive_standardize.{hpp,ipp}),
``MatrixNaiveCSubset``/``RSubset`` (matrix_naive_subset.{hpp,ipp}),
``MatrixNaiveCConcatenate``/``RConcatenate`` (matrix_naive_concatenate.{hpp,ipp}),
``MatrixNaiveBlockDiag`` (matrix_naive_block_diag.{hpp,ipp}),
``MatrixNaiveKroneckerEye`` (matrix_naive_kronecker_eye.{hpp,ipp}),
``MatrixCovBlockDiag`` (matrix_cov_block_diag.{hpp,ipp}).

Each wrapper composes the child's functional hot ops (``mul``/``gather``/
``tmul``/``sq_mul``) algebraically, so the composition itself costs nothing
on device — XLA fuses the element-wise adjustments into the child's matmuls.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .base import MatrixCovBase, MatrixNaiveBase

_PRECISION = jax.lax.Precision.HIGHEST


class MatrixNaiveStandardize(MatrixNaiveBase):
    """Implicit ``(X - 1 c^T) / s`` view (reference matrix_naive_standardize)."""

    def __init__(self, mat: MatrixNaiveBase, centers, scales):
        self._child = mat
        self.dtype = mat.dtype
        self._rows, self._cols = mat.rows(), mat.cols()
        self._centers = jnp.asarray(np.asarray(centers), self.dtype)
        self._scales = jnp.asarray(np.asarray(scales), self.dtype)

    def mul(self, v, w):
        v = jnp.asarray(v)
        w = jnp.asarray(w)
        raw = self._child.mul(v, w)
        vw_sum = jnp.sum(v * w)
        return (raw - self._centers * vw_sum) / self._scales

    def mul_spec(self):
        cf, cdata = self._child.mul_spec()

        def f(data, v, w):
            raw = cf(data["child"], v, w)
            vw_sum = jnp.sum(v * w)
            return (raw - data["centers"] * vw_sum) / data["scales"]

        return f, {"child": cdata, "centers": self._centers,
                   "scales": self._scales}

    def gather(self, indices):
        idx = np.asarray(indices, np.int32)
        blk = self._child.gather(idx)
        jidx = jnp.asarray(idx)
        return (blk - self._centers[jidx][None, :]) / self._scales[jidx][None, :]

    def tmul(self, beta):
        beta = jnp.asarray(beta, self.dtype)
        scaled = (beta.T / self._scales).T
        out = self._child.tmul(scaled)
        shift = jnp.tensordot(self._centers, scaled, axes=([0], [0]))
        return out - shift

    def sq_mul(self, w):
        w = jnp.asarray(w)
        ones = jnp.ones((self._rows,), self.dtype)
        raw = self._child.sq_mul(w)
        m1 = self._child.mul(ones, w)
        wsum = jnp.sum(w)
        return (raw - 2 * self._centers * m1 + self._centers**2 * wsum) / self._scales**2


class MatrixNaiveCSubset(MatrixNaiveBase):
    """Column subset view (reference matrix_naive_subset C-variant)."""

    def __init__(self, mat: MatrixNaiveBase, subset):
        self._child = mat
        self.dtype = mat.dtype
        self._subset = np.asarray(subset, np.int32)
        self._rows, self._cols = mat.rows(), len(self._subset)

    def mul(self, v, w):
        full = self._child.mul(v, w)
        return full[jnp.asarray(self._subset)]

    def mul_spec(self):
        cf, cdata = self._child.mul_spec()
        sub = jnp.asarray(self._subset)

        def f(data, v, w):
            return cf(data["child"], v, w)[data["subset"]]

        return f, {"child": cdata, "subset": sub}

    def gather(self, indices):
        return self._child.gather(self._subset[np.asarray(indices, np.int32)])

    def tmul(self, beta):
        beta = jnp.asarray(beta, self.dtype)
        shape = (self._child.cols(),) + beta.shape[1:]
        full = jnp.zeros(shape, self.dtype).at[jnp.asarray(self._subset)].add(beta)
        return self._child.tmul(full)

    def sq_mul(self, w):
        return self._child.sq_mul(w)[jnp.asarray(self._subset)]


class MatrixNaiveRSubset(MatrixNaiveBase):
    """Row subset view (reference matrix_naive_subset R-variant)."""

    def __init__(self, mat: MatrixNaiveBase, subset):
        self._child = mat
        self.dtype = mat.dtype
        self._subset = np.asarray(subset, np.int32)
        self._rows, self._cols = len(self._subset), mat.cols()

    def _expand(self, v):
        v = jnp.asarray(v)
        shape = (self._child.rows(),) + v.shape[1:]
        return jnp.zeros(shape, v.dtype).at[jnp.asarray(self._subset)].add(v)

    def mul(self, v, w):
        # accumulate v*w into child rows (duplicate subset rows must add)
        vw = jnp.asarray(v) * jnp.asarray(w)
        return self._child.mul(self._expand(vw), jnp.ones((self._child.rows(),), vw.dtype))

    def mul_spec(self):
        cf, cdata = self._child.mul_spec()
        nch = self._child.rows()
        sub = jnp.asarray(self._subset)

        def f(data, v, w):
            vw = jnp.zeros((nch,), v.dtype).at[data["subset"]].add(v * w)
            return cf(data["child"], vw, jnp.ones((nch,), v.dtype))

        return f, {"child": cdata, "subset": sub}

    def gather(self, indices):
        return self._child.gather(indices)[jnp.asarray(self._subset)]

    def tmul(self, beta):
        return self._child.tmul(beta)[jnp.asarray(self._subset)]

    def sq_mul(self, w):
        return self._child.sq_mul(self._expand(w))


class MatrixNaiveCConcatenate(MatrixNaiveBase):
    """Column-wise concatenation (reference matrix_naive_concatenate C-variant)."""

    def __init__(self, mats):
        assert len(mats) > 0
        self._children = list(mats)
        self.dtype = mats[0].dtype
        self._rows = mats[0].rows()
        for m in mats:
            assert m.rows() == self._rows
        self._offsets = np.concatenate(
            [[0], np.cumsum([m.cols() for m in mats])]
        ).astype(np.int64)
        self._cols = int(self._offsets[-1])

    @property
    def is_streaming(self):
        return any(getattr(m, "is_streaming", False) for m in self._children)

    def mul(self, v, w):
        return jnp.concatenate([m.mul(v, w) for m in self._children])

    def mul_many(self, U):
        return jnp.concatenate(
            [m.mul_many(U) for m in self._children], axis=0
        )

    def mul_spec(self):
        specs = [m.mul_spec() for m in self._children]
        fns = [s[0] for s in specs]

        def f(data, v, w):
            return jnp.concatenate(
                [fn(d, v, w) for fn, d in zip(fns, data["children"])]
            )

        return f, {"children": [s[1] for s in specs]}

    def gather(self, indices):
        idx = np.asarray(indices, np.int64)
        child_of = np.searchsorted(self._offsets, idx, side="right") - 1
        cols = []
        for pos, (c, j) in enumerate(zip(child_of, idx)):
            cols.append((pos, c, j - self._offsets[c]))
        # group by child to batch gathers
        out_parts = [None] * len(idx)
        for c in np.unique(child_of):
            sel = [t for t in cols if t[1] == c]
            local = np.asarray([t[2] for t in sel], np.int32)
            blk = self._children[c].gather(local)
            for k, t in enumerate(sel):
                out_parts[t[0]] = blk[:, k]
        return jnp.stack(out_parts, axis=1)

    def tmul(self, beta):
        beta = jnp.asarray(beta, self.dtype)
        out = None
        for c, m in enumerate(self._children):
            sub = beta[self._offsets[c]:self._offsets[c + 1]]
            term = m.tmul(sub)
            out = term if out is None else out + term
        return out

    def sq_mul(self, w):
        return jnp.concatenate([m.sq_mul(w) for m in self._children])


class MatrixNaiveRConcatenate(MatrixNaiveBase):
    """Row-wise concatenation (reference matrix_naive_concatenate R-variant)."""

    def __init__(self, mats):
        assert len(mats) > 0
        self._children = list(mats)
        self.dtype = mats[0].dtype
        self._cols = mats[0].cols()
        for m in mats:
            assert m.cols() == self._cols
        self._row_offsets = np.concatenate(
            [[0], np.cumsum([m.rows() for m in mats])]
        ).astype(np.int64)
        self._rows = int(self._row_offsets[-1])

    def _split(self, v):
        v = jnp.asarray(v)
        return [
            v[self._row_offsets[c]:self._row_offsets[c + 1]]
            for c in range(len(self._children))
        ]

    def mul(self, v, w):
        vs, ws = self._split(v), self._split(w)
        out = None
        for m, vv, ww in zip(self._children, vs, ws):
            term = m.mul(vv, ww)
            out = term if out is None else out + term
        return out

    def mul_spec(self):
        specs = [m.mul_spec() for m in self._children]
        fns = [s[0] for s in specs]
        offs = [int(o) for o in self._row_offsets]

        def f(data, v, w):
            out = None
            for c, (fn, d) in enumerate(zip(fns, data["children"])):
                term = fn(d, v[offs[c]:offs[c + 1]], w[offs[c]:offs[c + 1]])
                out = term if out is None else out + term
            return out

        return f, {"children": [s[1] for s in specs]}

    def gather(self, indices):
        return jnp.concatenate([m.gather(indices) for m in self._children], axis=0)

    def tmul(self, beta):
        return jnp.concatenate([m.tmul(beta) for m in self._children], axis=0)

    def sq_mul(self, w):
        ws = self._split(w)
        out = None
        for m, ww in zip(self._children, ws):
            term = m.sq_mul(ww)
            out = term if out is None else out + term
        return out


class MatrixNaiveBlockDiag(MatrixNaiveBase):
    """Block-diagonal composition (reference matrix_naive_block_diag)."""

    def __init__(self, mats):
        assert len(mats) > 0
        self._children = list(mats)
        self.dtype = mats[0].dtype
        self._row_offsets = np.concatenate(
            [[0], np.cumsum([m.rows() for m in mats])]
        ).astype(np.int64)
        self._col_offsets = np.concatenate(
            [[0], np.cumsum([m.cols() for m in mats])]
        ).astype(np.int64)
        self._rows = int(self._row_offsets[-1])
        self._cols = int(self._col_offsets[-1])

    def mul(self, v, w):
        v = jnp.asarray(v)
        w = jnp.asarray(w)
        outs = []
        for c, m in enumerate(self._children):
            r0, r1 = self._row_offsets[c], self._row_offsets[c + 1]
            outs.append(m.mul(v[r0:r1], w[r0:r1]))
        return jnp.concatenate(outs)

    def mul_spec(self):
        specs = [m.mul_spec() for m in self._children]
        fns = [s[0] for s in specs]
        offs = [int(o) for o in self._row_offsets]

        def f(data, v, w):
            return jnp.concatenate([
                fn(d, v[offs[c]:offs[c + 1]], w[offs[c]:offs[c + 1]])
                for c, (fn, d) in enumerate(zip(fns, data["children"]))
            ])

        return f, {"children": [s[1] for s in specs]}

    def gather(self, indices):
        idx = np.asarray(indices, np.int64)
        child_of = np.searchsorted(self._col_offsets, idx, side="right") - 1
        out = jnp.zeros((self._rows, len(idx)), self.dtype)
        for c in np.unique(child_of):
            pos = np.nonzero(child_of == c)[0]
            local = (idx[pos] - self._col_offsets[c]).astype(np.int32)
            blk = self._children[c].gather(local)
            r0, r1 = self._row_offsets[c], self._row_offsets[c + 1]
            out = out.at[r0:r1, jnp.asarray(pos)].set(blk)
        return out

    def tmul(self, beta):
        beta = jnp.asarray(beta, self.dtype)
        outs = []
        for c, m in enumerate(self._children):
            c0, c1 = self._col_offsets[c], self._col_offsets[c + 1]
            outs.append(m.tmul(beta[c0:c1]))
        return jnp.concatenate(outs, axis=0)

    def sq_mul(self, w):
        w = jnp.asarray(w)
        outs = []
        for c, m in enumerate(self._children):
            r0, r1 = self._row_offsets[c], self._row_offsets[c + 1]
            outs.append(m.sq_mul(w[r0:r1]))
        return jnp.concatenate(outs)


class MatrixNaiveKroneckerEye(MatrixNaiveBase):
    """``X (x) I_K`` view — the multi-response workhorse
    (reference matrix_naive_kronecker_eye.{hpp,ipp}).

    Shape is ``(n K, p K)``; column ``q K + k`` equals ``X[:, q]`` scattered
    into rows ``i K + k``.  All ops reshape the ``(nK,)`` operands to
    ``(n, K)`` and ride a single matmul with the base matrix.
    """

    def __init__(self, mat: MatrixNaiveBase, K: int):
        self._child = mat
        self.dtype = mat.dtype
        self._K = int(K)
        self._rows = mat.rows() * self._K
        self._cols = mat.cols() * self._K

    @property
    def K(self):
        return self._K

    @property
    def is_streaming(self):
        return bool(getattr(self._child, "is_streaming", False))

    def mul(self, v, w):
        if self.is_streaming:
            return self.mul_many(((jnp.asarray(v) * jnp.asarray(w)))
                                 [None, :])[:, 0]
        f, data = self.mul_spec()
        return f(data, jnp.asarray(v), jnp.asarray(w))

    def mul_many(self, U):
        """One child ``mul_many`` over C*K residual streams: row (c, k)
        holds class k of residual c, so a streamed child amortizes its
        single pass over the packed bytes across classes AND lambdas."""
        K, n, p = self._K, self._child.rows(), self._child.cols()
        U = jnp.asarray(U, self.dtype)
        C = U.shape[0]
        V = U.reshape(C, n, K).transpose(0, 2, 1).reshape(C * K, n)
        base = self._child.mul_many(V)            # (p, C*K)
        return base.reshape(p, C, K).transpose(0, 2, 1).reshape(p * K, C)

    def mul_spec(self):
        cf, cdata = self._child.mul_spec()
        K = self._K
        n = self._child.rows()

        def f(data, v, w):
            vw = (v * w).reshape(n, K)
            ones = jnp.ones((n,), vw.dtype)
            cols = [cf(data["child"], vw[:, k], ones) for k in range(K)]
            return jnp.stack(cols, axis=1).reshape(-1)

        return f, {"child": cdata}

    def gather(self, indices):
        idx = np.asarray(indices, np.int64)
        q = (idx // self._K).astype(np.int32)
        k = (idx % self._K).astype(np.int32)
        base = self._child.gather(q)  # (n, m)
        n, m = base.shape
        K = self._K
        # expand rows: out[i*K + kk, j] = base[i, j] * (kk == k[j])
        onehot = jnp.asarray(np.eye(K, dtype=self._child.dtype.type)[:, k])  # (K, m)
        out = base[:, None, :] * onehot[None, :, :]  # (n, K, m)
        return out.reshape(n * K, m)

    def tmul(self, beta):
        K = self._K
        p = self._child.cols()
        beta = jnp.asarray(beta, self.dtype).reshape(p, K)
        out = self._child.tmul(beta)  # (n, K)
        return out.reshape(-1)

    def sq_mul(self, w):
        K = self._K
        n = self._child.rows()
        w2 = jnp.asarray(w).reshape(n, K)
        cols = [self._child.sq_mul(w2[:, k]) for k in range(K)]
        return jnp.stack(cols, axis=1).reshape(-1)


class MatrixCovBlockDiag(MatrixCovBase):
    """Block-diagonal PSD composition (reference matrix_cov_block_diag)."""

    def __init__(self, mats):
        self._children = list(mats)
        self.dtype = mats[0].dtype
        self._offsets = np.concatenate(
            [[0], np.cumsum([m.cols() for m in mats])]
        ).astype(np.int64)
        self._cols = int(self._offsets[-1])

    def _child_of(self, j):
        return int(np.searchsorted(self._offsets, j, side="right") - 1)

    def block(self, rows, cols):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        out = np.zeros((len(rows), len(cols)), self.dtype)
        rc = np.searchsorted(self._offsets, rows, side="right") - 1
        cc = np.searchsorted(self._offsets, cols, side="right") - 1
        for c in np.unique(np.concatenate([rc, cc])):
            rpos = np.nonzero(rc == c)[0]
            cpos = np.nonzero(cc == c)[0]
            if len(rpos) == 0 or len(cpos) == 0:
                continue
            blk = np.asarray(
                self._children[c].block(
                    rows[rpos] - self._offsets[c], cols[cpos] - self._offsets[c]
                )
            )
            out[np.ix_(rpos, cpos)] = blk
        return jnp.asarray(out)

    def mul(self, indices, values):
        indices = np.asarray(indices, np.int64)
        values = np.asarray(values)
        out = np.zeros((self._cols,), self.dtype)
        cc = np.searchsorted(self._offsets, indices, side="right") - 1
        for c in np.unique(cc):
            pos = np.nonzero(cc == c)[0]
            local = indices[pos] - self._offsets[c]
            sub = np.asarray(self._children[c].mul(local, values[pos]))
            out[self._offsets[c]:self._offsets[c + 1]] = sub
        return jnp.asarray(out)
