"""Host-streaming packed SNP matrix — the out-of-HBM GWAS path.

The in-HBM matrix (``_snp.py``) materializes the whole 2-bit packed array
on device; a panel larger than the device memory cannot.  The reference
answers this with mmap streaming on the host (``io_snp_base.hpp:25-87``,
``matrix_naive_snp_unphased.ipp``); the device answer is **p-tile streaming**: the packed bytes stay in host
RAM (or mmap), and full-matrix products sweep SNP tiles through the
device — ``jax.device_put`` of tile k+1 is dispatched before the compute
on tile k, so the H2D copy overlaps the decode-matmul (double buffering).

The expensive full-p products of the BASIL loop are the per-lambda KKT
gradients.  Streaming once per lambda would pay the full H2D sweep per
lambda; instead the solver batches a whole lambda chunk's residuals and
calls :meth:`mul_many` — ONE pass over the packed bytes computes
``X^T (w * r_c)`` for every lambda c, amortizing the 2-bit decode C
ways.  See ``solver/streamed.py`` for the optimistic-KKT chunk
driver built on this.

Screened column blocks (tens to a few thousand columns) are gathered by a
host ``take`` of packed rows and decoded on device — they stay
HBM-resident exactly like the in-HBM path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .base import MatrixNaiveBase
from ._snp import _unpack_cols

_PRECISION = jax.lax.Precision.HIGHEST


def _mul_many_xla(packed_tile, U, impute_tile, *, n, CH=2048):
    """Tile product: (T, nb) packed x (C, n) -> (T, C).

    Decodes CH-column sub-blocks with a single traced ``lax.map`` body so
    the dense decoded intermediate never exceeds (n, CH)."""
    T = packed_tile.shape[0]
    dtype = U.dtype
    n_chunks = (T + CH - 1) // CH
    T_pad = n_chunks * CH
    if T_pad != T:
        packed_tile = jnp.pad(packed_tile, ((0, T_pad - T), (0, 0)))
        impute_tile = jnp.pad(impute_tile, (0, T_pad - T))
    packed_r = packed_tile.reshape(n_chunks, CH, -1)
    impute_r = impute_tile.reshape(n_chunks, CH)

    def one(args):
        rows, imp = args
        codes = _unpack_cols(rows, n, dtype)            # (n, CH)
        blk = jnp.where(codes == 3.0, imp[None, :], codes)
        return jnp.einsum("nk,cn->kc", blk, U, precision=_PRECISION)

    out = jax.lax.map(one, (packed_r, impute_r))        # (n_chunks, CH, C)
    return out.reshape(T_pad, -1)[:T]


def _sq_mul_xla(packed_tile, w, impute_tile, *, n, CH=2048):
    """Weighted squared column norms of one tile: sum_i w_i x_ji^2."""
    T = packed_tile.shape[0]
    dtype = w.dtype
    n_chunks = (T + CH - 1) // CH
    T_pad = n_chunks * CH
    if T_pad != T:
        packed_tile = jnp.pad(packed_tile, ((0, T_pad - T), (0, 0)))
        impute_tile = jnp.pad(impute_tile, (0, T_pad - T))
    packed_r = packed_tile.reshape(n_chunks, CH, -1)
    impute_r = impute_tile.reshape(n_chunks, CH)

    def one(args):
        rows, imp = args
        codes = _unpack_cols(rows, n, dtype)
        blk = jnp.where(codes == 3.0, imp[None, :], codes)
        return jnp.einsum("nk,n->k", blk * blk, w, precision=_PRECISION)

    out = jax.lax.map(one, (packed_r, impute_r))
    return out.reshape(-1)[:T]


def _tmul_xla(packed_tile, beta_tile, impute_tile, *, n, CH=2048):
    """Forward product of one tile: sum_j x_:j beta_j -> (n,)."""
    T = packed_tile.shape[0]
    dtype = beta_tile.dtype
    n_chunks = (T + CH - 1) // CH
    T_pad = n_chunks * CH
    if T_pad != T:
        packed_tile = jnp.pad(packed_tile, ((0, T_pad - T), (0, 0)))
        impute_tile = jnp.pad(impute_tile, (0, T_pad - T))
        beta_tile = jnp.pad(beta_tile, (0, T_pad - T))
    packed_r = packed_tile.reshape(n_chunks, CH, -1)
    impute_r = impute_tile.reshape(n_chunks, CH)
    beta_r = beta_tile.reshape(n_chunks, CH)

    def body(acc, args):
        rows, imp, b = args
        codes = _unpack_cols(rows, n, dtype)
        blk = jnp.where(codes == 3.0, imp[None, :], codes)
        return acc + jnp.matmul(blk, b, precision=_PRECISION), None

    out, _ = jax.lax.scan(body, jnp.zeros((n,), dtype),
                          (packed_r, impute_r, beta_r))
    return out


class MatrixNaiveSNPUnphasedStreamed(MatrixNaiveBase):
    """SNP unphased matrix streamed from host RAM in SNP tiles.

    ``tile_snps`` SNP rows per tile (padded last tile); per-tile device
    programs have a single static shape, so one compile covers the sweep.
    """

    is_streaming = True

    def __init__(self, io, *, dtype=None, tile_snps=65536, mesh=None):
        io._ensure() if hasattr(io, "_ensure") else None
        self.dtype = np.dtype(dtype or np.float32)
        self._io = io
        self._rows = int(io.rows())
        self._cols = int(io.snps())
        packed = np.asarray(io.packed)            # (p, nb) host view
        if packed.dtype != np.uint8:
            packed = packed.astype(np.uint8)
        self._packed_host = packed
        self._impute_host = np.asarray(io.impute, self.dtype)
        self._nb = packed.shape[1]
        self._tile = int(min(tile_snps, max(256, self._cols)))
        self._ntiles = (self._cols + self._tile - 1) // self._tile
        from ..parallel import active_mesh

        self._mesh = mesh if mesh is not None else active_mesh()
        # padded last tile (host copy made once)
        last = packed[(self._ntiles - 1) * self._tile:]
        if last.shape[0] != self._tile:
            pad = np.zeros((self._tile, self._nb), np.uint8)
            pad[: last.shape[0]] = last
            self._last_tile = pad
            imp_pad = np.zeros(self._tile, self.dtype)
            imp_pad[: last.shape[0]] = \
                self._impute_host[(self._ntiles - 1) * self._tile:]
            self._last_impute = imp_pad
        else:
            self._last_tile = None
            self._last_impute = None
        # per-tile impute slices live on device once (tiny)
        self._impute_dev = [
            jnp.asarray(self._impute_tile_np(k)) for k in range(self._ntiles)
        ]
        self._jit_cache = {}
        # full passes over the packed bytes (mul_many/sq_mul sweeps) —
        # the bench compares this against its estimated pass count so the
        # streamed budget model self-corrects across rounds
        self.sweeps = 0

    # ------------------------------------------------------------------ #
    # tile plumbing                                                       #
    # ------------------------------------------------------------------ #

    def _tile_np(self, k):
        if k == self._ntiles - 1 and self._last_tile is not None:
            return self._last_tile
        return self._packed_host[k * self._tile:(k + 1) * self._tile]

    def _impute_tile_np(self, k):
        if k == self._ntiles - 1 and self._last_impute is not None:
            return self._last_impute
        return self._impute_host[k * self._tile:(k + 1) * self._tile]

    def _put_tile(self, k):
        """Async H2D of tile k (sharded over the mesh byte axis if set)."""
        t = self._tile_np(k)
        if self._mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            return jax.device_put(
                t, NamedSharding(self._mesh, P(None, self._mesh.axis_names[0]))
            )
        return jax.device_put(t)

    def _tiles(self):
        """Yield (k, device_tile) in order, double-buffered: tile k+1's
        copy is dispatched before tile k's compute."""
        cur = self._put_tile(0)
        for k in range(self._ntiles):
            nxt = self._put_tile(k + 1) if k + 1 < self._ntiles else None
            yield k, cur
            cur = nxt

    # ------------------------------------------------------------------ #
    # protocol                                                            #
    # ------------------------------------------------------------------ #

    def structure_key(self):
        key = (type(self).__name__, self._rows, self._cols, self._tile,
               str(self.dtype))
        if self._mesh is not None:
            key = key + (tuple(d.id for d in self._mesh.devices.flat),
                         self._mesh.axis_names)
        return key

    def mul_spec(self):
        raise NotImplementedError(
            "streamed SNP matrices cannot be embedded in a fused device "
            "program (the packed bytes live on host); the gaussian driver "
            "uses the streamed-KKT path instead (solver/streamed.py)."
        )

    def gather(self, indices):
        """Decode an arbitrary column subset: host take -> device decode."""
        idx = np.asarray(indices, np.int64)
        rows = jnp.asarray(self._packed_host[idx])        # host gather
        codes = _unpack_cols(rows, self._rows, self.dtype)
        imp = jnp.asarray(self._impute_host[idx])
        return jnp.where(codes == 3.0, imp[None, :], codes)

    def mul(self, v, w):
        v = jnp.asarray(v, self.dtype)
        w = jnp.asarray(w, self.dtype)
        U = (v * w)[None, :]
        return self.mul_many(U)[:, 0]

    def mul_many(self, U):
        """X^T U_c for every row c of ``U`` ((C, n), already weight-
        multiplied) in ONE double-buffered pass over the packed bytes.
        Returns (p, C) on device.

        C is padded to a power-of-2 bucket (>= 4): each distinct C is a
        separate device program, and the decode-bound product runs extra
        residual columns nearly free — so the setup sweeps (C=1..2) and
        the chunk KKT sweeps share at most two compiled programs instead
        of one per call shape."""
        U = jnp.asarray(U, self.dtype)
        C = U.shape[0]
        C_pad = max(4, 1 << (C - 1).bit_length())
        if C_pad != C:
            U = jnp.concatenate(
                [U, jnp.zeros((C_pad - C, U.shape[1]), U.dtype)]
            )
        n = self._rows
        key = ("mul_many",)
        fj = self._jit_cache.get(key)
        if fj is None:
            fj = jax.jit(functools.partial(_mul_many_xla, n=n))
            self._jit_cache[key] = fj

        outs = []
        for k, cur in self._tiles():
            outs.append(fj(cur, U, self._impute_dev[k]))
        out = jnp.concatenate(outs, axis=0)
        self.sweeps += 1
        return out[: self._cols, :C]

    def sq_mul(self, w):
        w = jnp.asarray(w, self.dtype)
        n = self._rows
        key = ("sq_mul",)
        fj = self._jit_cache.get(key)
        if fj is None:
            fj = jax.jit(functools.partial(_sq_mul_xla, n=n))
            self._jit_cache[key] = fj
        outs = []
        for k, cur in self._tiles():
            outs.append(fj(cur, w, self._impute_dev[k]))
        self.sweeps += 1
        return jnp.concatenate(outs)[: self._cols]

    def tmul(self, beta):
        beta = np.asarray(beta)
        n = self._rows
        key = ("tmul",)
        fj = self._jit_cache.get(key)
        if fj is None:
            fj = jax.jit(functools.partial(_tmul_xla, n=n))
            self._jit_cache[key] = fj
        # sparse fast path: most path betas touch few tiles
        nz_tiles = np.unique(np.nonzero(beta)[0] // self._tile)
        out = jnp.zeros((n,), self.dtype)
        for k in nz_tiles:
            b = np.zeros(self._tile, self.dtype)
            s = k * self._tile
            e = min(s + self._tile, self._cols)
            b[: e - s] = beta[s:e]
            buf = self._put_tile(int(k))
            out = out + fj(buf, jnp.asarray(b), self._impute_dev[int(k)])
        return out
