"""Matrix factories mirroring ``adelie.matrix`` (reference adelie/matrix.py).

Users may also implement custom matrices by subclassing
:class:`MatrixNaiveBase` and providing the functional hot ops
(``mul``/``gather``/``tmul``) as jittable callables — the device-native analog of
the reference's pybind trampoline extension path (py_matrix.cpp:627-830).
"""

import numpy as np

from ..utils import types
from .base import (
    MatrixConstraintBase,
    MatrixCovBase,
    MatrixNaiveBase,
    MatrixNaiveTranspose,
)

from .dense import MatrixCovDense, MatrixCovLazy, MatrixNaiveDense
from .wrappers import (
    MatrixCovBlockDiag,
    MatrixNaiveBlockDiag,
    MatrixNaiveCConcatenate,
    MatrixNaiveCSubset,
    MatrixNaiveKroneckerEye,
    MatrixNaiveRConcatenate,
    MatrixNaiveRSubset,
    MatrixNaiveStandardize,
)

# Reference-name aliases (reference matrix.py:79,199,260,40): the reference
# calls its user-extensible Python bases PyMatrix*Base; here the protocol
# bases themselves are the extension point, so the names coincide.
PyMatrixNaiveBase = MatrixNaiveBase
PyMatrixCovBase = MatrixCovBase
PyMatrixConstraintBase = MatrixConstraintBase
PyMatrixNaiveTranspose = MatrixNaiveTranspose

__all__ = [
    "MatrixNaiveBase",
    "MatrixCovBase",
    "MatrixConstraintBase",
    "dense",
    "block_diag",
    "concatenate",
    "eager_cov",
    "kronecker_eye",
    "lazy_cov",
    "standardize",
    "subset",
    "sparse",
    "one_hot",
    "interaction",
    "snp_unphased",
    "snp_phased_ancestry",
    "convex_relu",
    "convex_gated_relu",
]


def _wrap_naive(mat, dtype=None):
    if isinstance(mat, MatrixNaiveBase):
        return mat
    return MatrixNaiveDense(mat, dtype=dtype)


def dense(mat, *, method: str = "naive", n_threads: int = 1, dtype=None,
          copy: bool = False,
          mesh=None):
    """Dense matrix (reference matrix.py:549).  ``n_threads`` and ``copy``
    are accepted for API parity; parallelism is XLA's concern here, and
    host data is always copied to the device on wrap.

    ``mesh``: a ``jax.sharding.Mesh`` (or None to use
    ``adelie_tpu.parallel.use_mesh``'s active mesh) — the observation axis
    is sharded across it and every solver step runs SPMD with XLA-inserted
    collectives (validated to produce identical solutions in
    tests/test_mesh.py)."""
    method = types.matrix_method(method)
    if method == "naive":
        m = MatrixNaiveDense(mat, dtype=dtype)
        from ..parallel import active_mesh, shard_rows

        mesh = mesh or active_mesh()
        if mesh is not None:
            m._mat = shard_rows(m._mat, mesh)
            m._mesh = mesh
        return m
    if method == "cov":
        return MatrixCovDense(mat, dtype=dtype)
    if method == "constraint":
        from ._constraint_mat import MatrixConstraintDense

        return MatrixConstraintDense(mat, dtype=dtype)
    raise ValueError(f"Unknown method: {method}")


def block_diag(mats, *, method: str = "naive", n_threads: int = 1):
    """Block-diagonal composition (reference matrix.py:198)."""
    mats = [
        m if isinstance(m, (MatrixNaiveBase, MatrixCovBase)) else dense(m, method=method)
        for m in mats
    ]
    method = types.matrix_method(method)
    if method == "naive":
        return MatrixNaiveBlockDiag(mats)
    if method == "cov":
        return MatrixCovBlockDiag(mats)
    raise ValueError("method 'constraint' is not supported for block_diag")


def concatenate(mats, *, axis: int = 1, n_threads: int = 1):
    """Column-/row-wise concatenation (reference matrix.py:292)."""
    mats = [_wrap_naive(m) for m in mats]
    if axis == 1:
        return MatrixNaiveCConcatenate(mats)
    if axis == 0:
        return MatrixNaiveRConcatenate(mats)
    raise ValueError("axis must be 0 or 1")


def eager_cov(mat, *, n_threads: int = 1):
    """Eagerly computed Gram matrix A = X^T X (reference matrix.py:683)."""
    import jax.numpy as jnp
    import jax

    X = np.asarray(mat)
    A = np.asarray(
        jnp.einsum(
            "np,nq->pq", jnp.asarray(X), jnp.asarray(X),
            precision=jax.lax.Precision.HIGHEST,
        )
    )
    return MatrixCovDense(A)


def kronecker_eye(mat, K: int, *, copy: bool = False, n_threads: int = 1):
    """``X (x) I_K`` (reference matrix.py:917)."""
    return MatrixNaiveKroneckerEye(_wrap_naive(mat), K)


def lazy_cov(mat, *, copy: bool = False, n_threads: int = 1, dtype=None):
    """Lazily computed Gram matrix (reference matrix.py:1000)."""
    return MatrixCovLazy(mat, dtype=dtype)


def standardize(mat, centers=None, scales=None, ddof: int = 0, *, n_threads: int = 1):
    """Standardized view (reference matrix.py:1414).

    Centers/scales deduced with equal weights 1/n when not given; scales use
    ``1/(n - ddof)`` normalization.
    """
    import jax.numpy as jnp

    mat = _wrap_naive(mat)
    n = mat.rows()
    w = jnp.full((n,), 1.0 / n, dtype=jnp.dtype(mat.dtype))
    if centers is None:
        centers = np.asarray(mat.mean(w))
    centers = np.asarray(centers)
    if scales is None:
        var = np.asarray(mat.var(jnp.asarray(centers, w.dtype), w))
        scales = np.sqrt(n / (n - ddof) * var)
    return MatrixNaiveStandardize(mat, centers, scales)


def subset(mat, indices, *, axis: int = 1, n_threads: int = 1):
    """Row/column subset view (reference matrix.py:1539)."""
    mat = _wrap_naive(mat)
    if axis == 1:
        return MatrixNaiveCSubset(mat, indices)
    if axis == 0:
        return MatrixNaiveRSubset(mat, indices)
    raise ValueError("axis must be 0 or 1")


def sparse(mat, *, method: str = "naive", n_threads: int = 1, dtype=None,
           copy: bool = False,
           layout: str = "auto"):
    """Sparse matrix (reference matrix.py:1301).

    ``layout`` (naive only): "auto" | "dense" | "padded" — see
    matrix/_sparse.py.  Padded CSC/CSR planes turn both products into one
    vectorized gather + lane reduction (no scatters); auto DENSIFIES
    above a ~0.2% density crossover when the dense array fits ~2 GB
    (dense matvecs stream far faster than dynamic gathers); below
    it builds padded planes, unless nnz skew makes them larger than the
    (cap-respecting) dense array — then dense wins on both axes.  The
    BCOO fallback was removed in r5 (half the padded bandwidth, no
    remaining niche; layout='bcoo' raises).
    """
    from ._sparse import MatrixCovSparse, MatrixNaiveSparse

    method = types.matrix_method(method)
    if method == "naive":
        return MatrixNaiveSparse(mat, dtype=dtype, layout=layout)
    if method == "cov":
        return MatrixCovSparse(mat, dtype=dtype)
    if method == "constraint":
        from ._constraint_mat import MatrixConstraintSparse

        return MatrixConstraintSparse(mat, dtype=dtype)
    raise ValueError(f"Unknown method: {method}")


def one_hot(mat, levels=None, *, copy: bool = False, n_threads: int = 1):
    """Implicit one-hot expansion of discrete columns (reference matrix.py:1073)."""
    from ._one_hot import MatrixNaiveOneHotDense

    return MatrixNaiveOneHotDense(mat, levels)


def interaction(mat, intr_map, levels=None, *, copy: bool = False,
                n_threads: int = 1):
    """Implicit pairwise-interaction expansion (reference matrix.py:721)."""
    from ._interaction import MatrixNaiveInteractionDense

    return MatrixNaiveInteractionDense(mat, intr_map, levels)


def snp_unphased(io, *, n_threads: int = 1, dtype=None, mesh=None,
                 streaming="auto", tile_snps: int = 65536):
    """Packed SNP unphased matrix (reference matrix.py:1245).

    ``mesh``: a ``jax.sharding.Mesh`` (or None to use the
    ``adelie_tpu.parallel.use_mesh`` active mesh) — the packed byte
    (observation) axis shards across it; gradients run as per-device
    decode-matvecs + an all-reduce (see matrix/_snp.py).

    ``streaming``: ``True`` keeps the packed bytes in HOST memory and
    streams SNP tiles through the device per full-matrix product — the
    path for panels larger than the device memory (the reference streams
    from mmap for the same reason, io_snp_base.hpp:25-87).
    ``"auto"`` picks streaming when the packed bytes exceed the mesh size
    times the per-device ``configs.snp_hbm_budget``.  ``tile_snps``: SNP rows
    per streamed tile."""
    from ..configs import snp_hbm_budget
    from ._snp import MatrixNaiveSNPUnphased
    from ._snp_stream import MatrixNaiveSNPUnphasedStreamed

    if streaming == "auto":
        io._ensure() if hasattr(io, "_ensure") else None
        import numpy as _np

        from ..parallel import active_mesh

        m = mesh if mesh is not None else active_mesh()
        D = int(_np.prod(m.devices.shape)) if m is not None else 1
        packed_bytes = int(io.snps()) * ((int(io.rows()) + 3) // 4)
        budget = snp_hbm_budget()
        streaming = budget is not None and packed_bytes > D * budget
    if streaming:
        return MatrixNaiveSNPUnphasedStreamed(
            io, dtype=dtype, tile_snps=tile_snps, mesh=mesh
        )
    return MatrixNaiveSNPUnphased(io, dtype=dtype, mesh=mesh)


def snp_phased_ancestry(io, *, n_threads: int = 1, dtype=None, mesh=None):
    """Phased calldata x local-ancestry matrix (reference matrix.py:1189).
    ``mesh`` as in :func:`snp_unphased`."""
    from ._snp import MatrixNaiveSNPPhasedAncestry

    return MatrixNaiveSNPPhasedAncestry(io, dtype=dtype, mesh=mesh)


def convex_relu(mat, mask, *, gated: bool = False, n_threads: int = 1):
    """Implicit ``[relu(XD), -relu(XD)]`` expansion (reference matrix.py:390)."""
    from ._convex_relu import MatrixNaiveConvexGatedRelu, MatrixNaiveConvexRelu

    cls = MatrixNaiveConvexGatedRelu if gated else MatrixNaiveConvexRelu
    return cls(mat, mask)


def convex_gated_relu(mat, mask, *, n_threads: int = 1):
    return convex_relu(mat, mask, gated=True)
