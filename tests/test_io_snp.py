"""SNP IO round-trips + SNP matrix classes vs dense (reference
tests/test_io.py:15,72 and test_matrix.py SNP sections)."""

import numpy as np
import pytest

import adelie_tpu as ad
from adelie_tpu import matrix as mx


def _unphased_data(n, p, seed=0, missing=0.15):
    rng = np.random.default_rng(seed)
    probs = np.array([0.55, 0.25, 0.05, 0.15])
    probs[3] = missing
    probs[0] = 1 - probs[1:].sum()
    vals = np.array([0, 1, 2, -9], dtype=np.int8)
    return vals[rng.choice(4, size=(n, p), p=probs)]


@pytest.mark.parametrize("n,p", [(20, 6), (300, 25), (257, 3)])
def test_unphased_roundtrip(n, p, tmp_path):
    X = _unphased_data(n, p, seed=n + p)
    f = str(tmp_path / "test.snpdat")
    handler = ad.io.snp_unphased(f)
    total, bench = handler.write(X, impute_method="mean")
    assert total > 0

    rd = ad.io.snp_unphased(f).read()
    assert rd.rows() == n and rd.snps() == p
    dense = rd.to_dense()
    np.testing.assert_array_equal(dense, X)

    # impute means over non-missing
    for j in range(p):
        col = X[:, j]
        nm = col >= 0
        expect = col[nm].mean() if nm.any() else 0.0
        assert np.isclose(rd.impute[j], expect), j
        assert rd.nnm[j] == nm.sum()
        assert rd.nnz[j] == np.sum(col != 0)


def test_unphased_write_invalid(tmp_path):
    X = np.full((5, 2), 3, np.int8)
    handler = ad.io.snp_unphased(str(tmp_path / "bad.snpdat"))
    with pytest.raises(ValueError):
        handler.write(X)


@pytest.mark.parametrize("n,s,A", [(30, 5, 3), (260, 4, 2)])
def test_phased_roundtrip(n, s, A, tmp_path):
    rng = np.random.default_rng(s * A)
    call = rng.binomial(1, 0.3, size=(n, 2 * s)).astype(np.int8)
    anc = rng.integers(0, A, size=(n, 2 * s)).astype(np.int8)
    f = str(tmp_path / "test.snpdat")
    handler = ad.io.snp_phased_ancestry(f)
    total, bench = handler.write(call, anc, A)
    assert total > 0

    rd = ad.io.snp_phased_ancestry(f).read()
    assert rd.rows() == n and rd.snps() == s and rd.ancestries() == A
    dense = rd.to_dense()
    expect = np.zeros((n, s * A), np.int8)
    for j in range(s):
        for hap in range(2):
            sel = call[:, 2 * j + hap] == 1
            expect[sel, j * A + anc[sel, 2 * j + hap]] += 1
    np.testing.assert_array_equal(dense, expect)


def test_snp_unphased_matrix(tmp_path):
    from test_matrix import run_suite

    n, p = 40, 12
    X = _unphased_data(n, p, seed=7)
    f = str(tmp_path / "m.snpdat")
    ad.io.snp_unphased(f).write(X)
    io = ad.io.snp_unphased(f).read()
    m = mx.snp_unphased(io)

    impute = io.impute
    dense = np.where(X == -9, impute[None, :], X).astype(np.float64)
    run_suite(m, dense)


def test_snp_phased_matrix(tmp_path):
    from test_matrix import run_suite

    n, s, A = 35, 4, 3
    rng = np.random.default_rng(9)
    call = rng.binomial(1, 0.4, size=(n, 2 * s)).astype(np.int8)
    anc = rng.integers(0, A, size=(n, 2 * s)).astype(np.int8)
    f = str(tmp_path / "ph.snpdat")
    ad.io.snp_phased_ancestry(f).write(call, anc, A)
    io = ad.io.snp_phased_ancestry(f).read()
    m = mx.snp_phased_ancestry(io)

    dense = np.zeros((n, s * A))
    for j in range(s):
        for hap in range(2):
            sel = call[:, 2 * j + hap] == 1
            dense[sel, j * A + anc[sel, 2 * j + hap]] += 1
    run_suite(m, dense)


def test_grpnet_snp(tmp_path):
    """End-to-end GWAS-style lasso on the packed SNP matrix vs dense."""
    data = ad.data.snp_unphased(150, 30, seed=3)
    f = str(tmp_path / "g.snpdat")
    ad.io.snp_unphased(f).write(data["X"])
    io = ad.io.snp_unphased(f).read()
    m = mx.snp_unphased(io)
    glm = data["glm"]

    st1 = ad.grpnet(m, glm, lmda_path_size=12, min_ratio=0.05,
                    progress_bar=False)
    dense = np.where(data["X"] == -9, io.impute[None, :], data["X"]).astype(float)
    st2 = ad.grpnet(dense, glm, lmda_path_size=12, min_ratio=0.05,
                    progress_bar=False)
    B1 = np.asarray(st1.betas.todense())
    B2 = np.asarray(st2.betas.todense())
    L = min(len(B1), len(B2))
    assert L >= 5
    assert np.allclose(B1[:L], B2[:L], atol=1e-7), np.abs(B1[:L] - B2[:L]).max()


def test_snp_bed_roundtrip(tmp_path):
    """PLINK .bed write/read + device matrix equivalence."""
    rng = np.random.default_rng(11)
    n, p = 37, 9
    vals = np.array([0, 1, 2, -9], np.int8)
    X = vals[rng.choice(4, size=(n, p), p=[0.5, 0.25, 0.15, 0.1])]
    f = str(tmp_path / "test.bed")
    bed = ad.io.snp_bed(f)
    bed.write(X)

    rd = ad.io.snp_bed(f, n_samples=n).read()
    assert rd.snps() == p
    np.testing.assert_array_equal(rd.to_dense(), X)

    # device matrix over the bed handler (same protocol as snp_unphased)
    m = mx.snp_unphased(rd)
    dense = np.where(X == -9, rd.impute[None, :], X).astype(np.float64)
    v = rng.standard_normal(n)
    w = np.full(n, 1.0 / n)
    np.testing.assert_allclose(np.asarray(m.mul(v, w)), dense.T @ (w * v),
                               atol=1e-9)
    idx = np.arange(p, dtype=np.int32)
    np.testing.assert_allclose(np.asarray(m.gather(idx)), dense, atol=1e-12)


def test_snp_bed_bad_magic(tmp_path):
    f = str(tmp_path / "bad.bed")
    with open(f, "wb") as fh:
        fh.write(b"nope")
    with pytest.raises(RuntimeError):
        ad.io.snp_bed(f, n_samples=4).read()


def _packed_case(rng, p, n):
    from adelie_tpu.matrix._snp import unpack_2bit_np

    nb = (n + 3) // 4
    packed = rng.integers(0, 256, size=(p, nb), dtype=np.int64).astype(np.uint8)
    rem = n % 4
    if rem:
        packed[:, -1] &= (1 << (2 * rem)) - 1
    impute = rng.uniform(0, 2, p).astype(np.float32)
    codes = unpack_2bit_np(packed, n).astype(np.float32)
    return packed, impute, codes


@pytest.mark.parametrize("na", [True, False])
def test_snp_mul_pallas_parity(na):
    """Fused decode-matvec kernel (Triton route, interpret mode) vs numpy
    dense, with p and n off the tile multiples; NA and NA-free variants."""
    import jax.numpy as jnp
    from adelie_tpu.matrix._snp_triton import snp_mul

    rng = np.random.default_rng(0)
    for (p, n) in [(10, 9), (300, 257), (513, 1000), (17, 2049)]:
        packed, impute, codes = _packed_case(rng, p, n)
        u = rng.standard_normal(n).astype(np.float32)
        if na:
            expect = np.where(codes == 3, impute[:, None], codes) @ u
        else:
            expect = codes @ u
        got = np.asarray(snp_mul(
            jnp.asarray(packed), jnp.asarray(u),
            jnp.asarray(impute) if na else None, interpret=True,
        ))
        np.testing.assert_allclose(got, expect, rtol=2e-5, atol=1e-4)


def test_mul_many_xla_parity():
    """Multi-residual decode-matmul of the streamed path vs numpy dense.

    This is the streamed-KKT workhorse: one pass over the packed bytes
    computes X^T u_c for every residual stream c of a lambda chunk."""
    import jax.numpy as jnp
    from adelie_tpu.matrix._snp_stream import _mul_many_xla

    rng = np.random.default_rng(1)
    for (p, n, C) in [(10, 9, 3), (300, 257, 8), (513, 1000, 1)]:
        packed, impute, codes = _packed_case(rng, p, n)
        U = rng.standard_normal((C, n)).astype(np.float32)
        expect = np.where(codes == 3, impute[:, None], codes) @ U.T
        got = np.asarray(_mul_many_xla(
            jnp.asarray(packed), jnp.asarray(U), jnp.asarray(impute), n=n,
            CH=128,
        ))
        np.testing.assert_allclose(got, expect, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("phased,mesh", [(False, False), (True, False),
                                         (False, True)])
def test_snp_mul_spec_kernel_dispatch(phased, mesh, tmp_path):
    """The SNP matrices' gradient takes the kernel under
    configs.kernels="interpret" (per device + psum on a mesh) and agrees
    with the XLA decode path."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from adelie_tpu.configs import set_configs

    n, p = 203, 37
    f = str(tmp_path / "k.snpdat")
    if phased:
        d = ad.data.snp_phased_ancestry(n, p, 2, seed=4)
        ad.io.snp_phased_ancestry(f).write(d["X"], d["ancestries"], 2)
        io = ad.io.snp_phased_ancestry(f).read()
        make = ad.matrix.snp_phased_ancestry
    else:
        ad.io.snp_unphased(f).write(_unphased_data(n, p, seed=4))
        io = ad.io.snp_unphased(f).read()
        make = ad.matrix.snp_unphased
    kw = {"mesh": Mesh(np.asarray(jax.devices()[:4]), ("n",))} if mesh else {}
    rng = np.random.default_rng(2)
    v = jnp.asarray(rng.standard_normal(n), jnp.float32)
    w = jnp.asarray(rng.uniform(0.5, 1.5, n) / n, jnp.float32)
    outs = {}
    try:
        for mode in ("xla", "interpret"):
            set_configs("kernels", mode)
            m = make(io, dtype=np.float32, **kw)
            fn, data = m.mul_spec()
            outs[mode] = np.asarray(jax.jit(fn)(data, v, w))
    finally:
        set_configs("kernels", None)
    assert outs["xla"].shape == (m.cols(),)
    np.testing.assert_allclose(outs["interpret"], outs["xla"], rtol=2e-5,
                               atol=1e-5)


def test_snp_kernel_lowers_to_triton():
    """Both SNP kernel variants lower for CUDA through the Triton route at
    the GWAS width (p = 200k SNPs x n = 50k samples)."""
    import jax
    import jax.numpy as jnp
    from jax import export

    from adelie_tpu.matrix._snp_triton import snp_mul

    dis = [export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")]
    for imp in (jax.ShapeDtypeStruct((200_000,), jnp.float32), None):
        exp = export.export(
            jax.jit(lambda a, b, c: snp_mul(a, b, c)), platforms=("cuda",),
            disabled_checks=dis,
        )(jax.ShapeDtypeStruct((200_000, 12_500), jnp.uint8),
          jax.ShapeDtypeStruct((50_000,), jnp.float32), imp)
        assert "xla.gpu.triton" in exp.mlir_module()


def test_corrupt_file_errors():
    """Garbage bytes must raise a clean RuntimeError, not an allocation
    blowup from garbage header dims."""
    import pytest

    fn = "/tmp/garbage_io.snpdat"
    with open(fn, "wb") as f:
        f.write(b"not a real snpdat file at all")
    with pytest.raises(RuntimeError, match="corrupt|cannot read"):
        ad.io.snp_unphased(fn).read()
    with pytest.raises(RuntimeError, match="corrupt|cannot read"):
        ad.io.snp_phased_ancestry(fn).read()


def test_css_subset_size_validation():
    import pytest

    S = np.eye(4)
    with pytest.raises(ValueError, match="subset_size"):
        ad.css_cov(S, 10, method="greedy", loss="least_squares")


def test_read_mode_mmap_roundtrip(tmp_path):
    """read_mode="mmap" decodes identically to buffered file IO (reference
    io_snp_base.hpp:25-87 read_mode_type)."""
    import adelie_tpu as ad
    from adelie_tpu import matrix as mx

    data = ad.data.snp_unphased(120, 25, seed=13)
    f = str(tmp_path / "mm.snpdat")
    ad.io.snp_unphased(f).write(data["X"])

    io_file = ad.io.snp_unphased(f, read_mode="file").read()
    io_mmap = ad.io.snp_unphased(f, read_mode="mmap").read()
    np.testing.assert_array_equal(io_file.packed, io_mmap.packed)
    np.testing.assert_array_equal(io_file.impute, io_mmap.impute)
    np.testing.assert_array_equal(io_file.to_dense(), io_mmap.to_dense())

    # phased too
    pd = ad.data.snp_phased_ancestry(80, 10, 3, seed=13)
    fp = str(tmp_path / "mm_phased.snpdat")
    ad.io.snp_phased_ancestry(fp).write(pd["X"], pd["ancestries"], 3)
    p1 = ad.io.snp_phased_ancestry(fp, read_mode="file").read()
    p2 = ad.io.snp_phased_ancestry(fp, read_mode="mmap").read()
    np.testing.assert_array_equal(p1.packed, p2.packed)

    with pytest.raises(ValueError):
        ad.io.snp_unphased(f, read_mode="bogus")
