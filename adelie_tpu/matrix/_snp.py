"""Packed SNP matrices (reference matrix_naive_snp_unphased.{hpp,ipp},
matrix_naive_snp_phased_ancestry.{hpp,ipp}).

Device design: the genotype matrix lives on device **2-bit packed**
(4 entries/byte, (p, ceil(n/4)) uint8 — 16x less device-memory traffic
than f32).  Ops unpack on the fly with shift/mask ops; NA entries (code 3,
unphased only) substitute the column's impute value (reference
matrix_naive_snp_unphased.ipp decode).  The full-p gradient ``X^T (w r)``
runs as the fused decode-matvec kernel where the kernel table
(``adelie_tpu/kernels.py``) has one, and as a chunked XLA decode +
contraction elsewhere.

**Mesh sharding** (the replacement of the reference's row-blocked OpenMP
kernels over X, matrix/utils.hpp:131-330, on its flagship GWAS workload):
with ``mesh=`` the packed byte axis — i.e. the observation axis, 4
samples/byte — is sharded over the mesh.  The gradient becomes per-device
decode-matvecs over the local byte shard + an all-reduce (explicit
``psum`` under ``shard_map`` on the kernel path; GSPMD-inserted on the
XLA path).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .base import MatrixNaiveBase

_PRECISION = jax.lax.Precision.HIGHEST


def unpack_2bit_np(packed, n):
    """(cols, nb) uint8 -> (cols, n) int np array of 2-bit codes."""
    cols, nb = packed.shape
    out = np.zeros((cols, nb * 4), np.uint8)
    for k in range(4):
        out[:, k::4] = (packed >> (2 * k)) & 3
    return out[:, :n]


def _unpack_cols(packed_rows, n, dtype):
    """jnp: (k, nb) uint8 -> (n, k) codes (float)."""
    k, nb = packed_rows.shape
    shifts = jnp.asarray([0, 2, 4, 6], jnp.uint8)
    # (k, nb, 4)
    vals = (packed_rows[:, :, None] >> shifts[None, None, :]) & 3
    vals = vals.reshape(k, nb * 4)[:, :n]
    return vals.T.astype(dtype)


class MatrixNaiveSNPUnphased(MatrixNaiveBase):
    """SNP unphased matrix backed by a .snpdat IO handler
    (reference matrix.py:1245)."""

    _CHUNK = 2048

    def __init__(self, io, *, dtype=None, mesh=None):
        io._ensure() if hasattr(io, "_ensure") else None
        self.dtype = np.dtype(dtype or np.float64)
        self._io = io
        self._rows = io.rows()
        self._cols = io.snps()
        self._init_packed(np.asarray(io.packed), mesh)  # (p, nb)
        self._impute = self._rep(jnp.asarray(io.impute, self.dtype))

    def _init_packed(self, packed, mesh):
        """Place the packed bytes on device, byte(=observation)-axis sharded
        over ``mesh``.  Rows are padded to a multiple of 4 bytes per device
        (the decode kernel reads 32-bit words); padding bytes decode to
        code 0 and are sliced/zeroed out by every op."""
        from ..parallel import active_mesh

        mesh = mesh if mesh is not None else active_mesh()
        self._mesh = mesh
        D = 1 if mesh is None else int(np.prod(mesh.devices.shape))
        pad = (-packed.shape[1]) % (4 * D)
        if pad:
            packed = np.pad(packed, ((0, 0), (0, pad)))
        if mesh is None:
            self._packed = jnp.asarray(packed)
            return
        self._packed = jax.device_put(
            packed, NamedSharding(mesh, P(None, mesh.axis_names[0]))
        )

    def _rep(self, x):
        if self._mesh is None:
            return x
        return jax.device_put(x, NamedSharding(self._mesh, P()))

    def structure_key(self):
        key = (type(self).__name__, self._rows, self._cols,
               self._packed.shape, str(self.dtype))
        if self._mesh is not None:
            key = key + (tuple(d.id for d in self._mesh.devices.flat),
                         self._mesh.axis_names)
        return key

    def _decode(self, idx):
        """(n, k) dense block for integer column indices (np array)."""
        idx = jnp.asarray(np.asarray(idx, np.int32))
        rows = jnp.take(self._packed, idx, axis=0)
        codes = _unpack_cols(rows, self._rows, self.dtype)
        imp = jnp.take(self._impute, idx)
        return jnp.where(codes == 3.0, imp[None, :], codes)

    def gather(self, indices):
        return self._decode(indices)

    def mul(self, v, w):
        f, data = self.mul_spec()
        return f(data, jnp.asarray(v), jnp.asarray(w))

    def mul_spec(self):
        return _snp_mul_spec(self, na=True)

    def tmul(self, beta):
        beta = jnp.asarray(beta, self.dtype)
        out = None
        for s in range(0, self._cols, self._CHUNK):
            e = min(s + self._CHUNK, self._cols)
            blk = self._decode(np.arange(s, e))
            term = blk @ beta[s:e]
            out = term if out is None else out + term
        return out

    def sq_mul(self, w):
        w = jnp.asarray(w)
        outs = []
        for s in range(0, self._cols, self._CHUNK):
            e = min(s + self._CHUNK, self._cols)
            blk = self._decode(np.arange(s, e))
            outs.append(jnp.einsum("nk,n->k", blk * blk, w, precision=_PRECISION))
        return jnp.concatenate(outs)


class MatrixNaiveSNPPhasedAncestry(MatrixNaiveSNPUnphased):
    """Phased calldata x local ancestry matrix (reference matrix.py:1189).

    Columns are (snp, ancestry) pairs with values 0/1/2 — no NA, so the
    decode skips imputation.
    """

    def __init__(self, io, *, dtype=None, mesh=None):
        io._ensure() if hasattr(io, "_ensure") else None
        self.dtype = np.dtype(dtype or np.float64)
        self._io = io
        self._rows = io.rows()
        self._cols = io.cols()
        self._init_packed(np.asarray(io.packed), mesh)
        self._impute = self._rep(jnp.zeros((self._cols,), self.dtype))

    def _decode(self, idx):
        idx = jnp.asarray(np.asarray(idx, np.int32))
        rows = jnp.take(self._packed, idx, axis=0)
        return _unpack_cols(rows, self._rows, self.dtype)

    def mul_spec(self):
        # phased codes are 0..2 (never NA): the select-free decode
        return _snp_mul_spec(self, na=False)


def _impute_arg(data):
    return (data["impute"],) if "impute" in data else ()


def _snp_mul_spec(mat, na):
    """``mul_spec`` of the packed SNP matrices: the fused decode-matvec
    kernel where ``kernels.choose`` picks one, else a ``lax.map`` over
    CH-column chunks (decoded block, then contraction)."""
    from ..kernels import choose

    n = mat._rows
    p = mat._cols
    CH = mat._CHUNK
    dtype = mat.dtype
    data = {"packed": mat._packed}
    if na:
        data["impute"] = mat._impute
    kernel = choose(dtype)

    if kernel:
        from ._snp_triton import snp_mul

        interpret = kernel == "interpret"

        def local(packed, u, impute=None):
            return snp_mul(packed, u, impute, interpret=interpret)

        if mat._mesh is not None:
            # per-device partials over the local byte shard + psum.  Bytes
            # are contiguously sharded, so device d's u block
            # [4*d*nb_loc, 4*(d+1)*nb_loc) lines up with its byte block.
            mesh = mat._mesh
            axis = mesh.axis_names[0]
            n_full = 4 * mat._packed.shape[1]
            sharded = jax.shard_map(
                lambda *a: jax.lax.psum(local(*a), axis), mesh=mesh,
                in_specs=(P(None, axis), P(axis)) + ((P(),) if na else ()),
                out_specs=P(), check_vma=False,
            )

            def f(data, v, w):
                u = jnp.zeros((n_full,), dtype).at[:n].set(
                    (v * w).astype(dtype))
                return sharded(data["packed"], u, *_impute_arg(data))

            return f, data

        def f(data, v, w):
            return local(data["packed"], (v * w).astype(dtype),
                         *_impute_arg(data))

        return f, data

    n_chunks = (p + CH - 1) // CH
    p_pad = n_chunks * CH

    def f(data, v, w):
        u = (v * w).astype(dtype)
        packed = data["packed"]
        impute = data["impute"] if na else jnp.zeros((p,), dtype)
        if p_pad != p:
            packed = jnp.pad(packed, ((0, p_pad - p), (0, 0)))
            impute = jnp.pad(impute, (0, p_pad - p))
        packed = packed.reshape(n_chunks, CH, -1)
        impute = impute.reshape(n_chunks, CH)

        def one(args):
            rows, imp = args
            blk = _unpack_cols(rows, n, dtype)
            if na:
                blk = jnp.where(blk == 3.0, imp[None, :], blk)
            return jnp.einsum("nk,n->k", blk, u, precision=_PRECISION)

        # lax.map: ONE traced chunk body regardless of p (a python loop
        # unrolls p/CH matmuls into the HLO, which blows up compile time
        # inside the lambda-chunk scan)
        out = jax.lax.map(one, (packed, impute))
        return out.reshape(-1)[:p]

    return f, data
