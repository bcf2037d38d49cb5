"""Fused 2-bit decode x matvec for packed SNP matrices, as a Pallas kernel
for the GPU (Triton route).

``out[j] = sum_i decode(packed[j], i) * u[i]``.  The XLA formulation
decodes each (n, chunk) block to f32 and contracts it against u; here
each program owns ``TP`` SNP rows and walks their packed bytes as 32-bit
words, ``TW`` words at a time: shift/mask into the sixteen 2-bit planes of
a word (plane m holds samples 16w + m) and multiply-add against the
matching slices of sixteen u planes, accumulating in f32 registers and
reducing once per row at the end.  Only the packed bytes and u cross
device memory.

Rows are read as uint32 words (a free bitcast of the byte rows when the
byte count is a multiple of 4; the SNP matrices pad their rows to one at
construction).  Besides fewer, wider loads this keeps element offsets
below 2^31 for panels up to 8 GB: Triton sign-extends 32-bit offsets,
which byte offsets past 2 GB would overflow.

NA (code 3, unphased matrices) decodes to the SNP's impute value; the
NA-free variant (phased ancestry: codes 0..2) skips that select.  Edge
rows and words are masked in the kernel and u is zero-padded to the word
tile.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# (rows, words, warps) sweeps on the H100 all landed within ~10% (PERF.md)
TP = 32      # SNP rows per program
TW = 64      # 32-bit words (16 samples each) per inner step
NUM_WARPS = 4


def _kernel(*refs, p, nw, na):
    if na:
        words_ref, u_ref, imp_ref, out_ref = refs
    else:
        words_ref, u_ref, out_ref = refs
    i = pl.program_id(0)
    row_ok = i * TP + jax.lax.broadcasted_iota(jnp.int32, (TP,), 0) < p
    lanes = jax.lax.broadcasted_iota(jnp.int32, (TW,), 0)
    if na:
        imp = plgpu.load(imp_ref.at[pl.ds(i * TP, TP)], mask=row_ok,
                         other=0.0)[:, None]

    def body(j, acc):
        w0 = j * TW
        mask = row_ok[:, None] & (w0 + lanes < nw)[None, :]
        word = plgpu.load(words_ref.at[pl.ds(i * TP, TP), pl.ds(w0, TW)],
                          mask=mask, other=0)
        for m in range(16):
            c = (word >> (2 * m)) & 3 if m < 15 else word >> 30
            cf = c.astype(jnp.float32)
            if na:
                cf = jnp.where(c == 3, imp, cf)
            acc = acc + cf * u_ref[m, pl.ds(w0, TW)][None, :]
        return acc

    acc = jax.lax.fori_loop(0, pl.cdiv(nw, TW), body,
                            jnp.zeros((TP, TW), jnp.float32))
    plgpu.store(out_ref.at[pl.ds(i * TP, TP)], jnp.sum(acc, axis=1),
                mask=row_ok)


def _u_planes(u, nw):
    """Zero-pad u to whole word tiles and split it into the sixteen
    2-bit-plane streams: row m holds samples 16w + m."""
    nw_pad = pl.cdiv(nw, TW) * TW
    u_pad = jnp.zeros((16 * nw_pad,), jnp.float32).at[: u.shape[0]].set(u)
    return u_pad.reshape(nw_pad, 16).T


@functools.partial(jax.jit, static_argnames=("interpret",))
def snp_mul(packed, u, impute=None, interpret: bool = False):
    """``decode(packed) @ u`` for a (p, nb) uint8 packed matrix and an (n,)
    f32 vector (already weight-multiplied).  ``impute`` ((p,) f32) selects
    the NA-decoding kernel; ``None`` the NA-free one.  ``nb`` not a
    multiple of 4 costs a padded copy of ``packed``."""
    p, nb = packed.shape
    if nb % 4:
        packed = jnp.pad(packed, ((0, 0), (0, -nb % 4)))
    nw = packed.shape[1] // 4
    words = jax.lax.bitcast_convert_type(packed.reshape(p, nw, 4),
                                         jnp.uint32)
    na = impute is not None
    args = (words, _u_planes(u.astype(jnp.float32), nw))
    if na:
        args = args + (impute.astype(jnp.float32),)
    return pl.pallas_call(
        functools.partial(_kernel, p=p, nw=nw, na=na),
        grid=(pl.cdiv(p, TP),),
        out_shape=jax.ShapeDtypeStruct((p,), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=3),
        interpret=interpret,
        name="snp_mul" if na else "snp_mul_no_na",
    )(*args)
