"""Seeded problem generators shared by ``chip_smoke.py`` and ``bench.py``.

Each returns host numpy data at the given size; the default sizes are the
ones the smoke test and the benchmark run on the card.
"""

import numpy as np


def dense_lasso(n=40_000, p=2_000, n_true=60, seed=0):
    """The dense gaussian lasso headline: centered f32 X (n, p) and y with
    ``n_true`` nonzero coefficients (fit with ``intercept=False``)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32)
    beta = np.zeros(p)
    nz = rng.choice(p, min(n_true, p), replace=False)
    beta[nz] = rng.standard_normal(len(nz))
    y = (X @ beta + 0.5 * rng.standard_normal(n)).astype(np.float32)
    X -= X.mean(axis=0)
    y -= y.mean()
    return X, y


class PackedIO:
    """Minimal in-memory IO handler for ``ad.matrix.snp_unphased``."""

    def __init__(self, packed, n, impute=None):
        self.packed = packed
        self._n = int(n)
        self.impute = (np.zeros(packed.shape[0]) if impute is None
                       else impute)

    def _ensure(self):
        pass

    def rows(self):
        return self._n

    def snps(self):
        return int(self.packed.shape[0])


def gwas(n=50_000, p=200_000, n_causal=40, seed=7):
    """In-memory GWAS panel: 2-bit packed genotypes (p, ceil(n/4)) uint8
    with ~86% / 10% / 4% codes 0 / 1 / 2 and no NA, and a gaussian
    phenotype driven by ``n_causal`` SNPs.  Returns (io, y, causal)."""
    from adelie_tpu.matrix._snp import unpack_2bit_np

    nb = (n + 3) // 4
    rng = np.random.default_rng(seed)
    # bytes sampled by quantile-mapping a uniform byte stream through a
    # 256-entry LUT of the 4-lane product distribution (fast at 2.5 GB)
    probs = np.array([0.86, 0.10, 0.04])
    codes = np.arange(256)
    lane_codes = np.stack([(codes >> (2 * k)) & 3 for k in range(4)], axis=1)
    valid = np.all(lane_codes <= 2, axis=1)
    byte_p = np.where(valid, np.prod(probs[np.minimum(lane_codes, 2)],
                                     axis=1), 0.0)
    cdf = np.cumsum(byte_p / byte_p.sum())
    lut = np.searchsorted(cdf, (np.arange(256) + 0.5) / 256).astype(np.uint8)
    packed = lut[rng.integers(0, 256, size=(p, nb), dtype=np.uint8)]
    if n % 4:
        packed[:, -1] &= (1 << (2 * (n % 4))) - 1
    causal = rng.choice(p, n_causal, replace=False)
    cols = unpack_2bit_np(packed[causal], n).astype(np.float32)
    beta = rng.standard_normal(n_causal).astype(np.float32)
    y = cols.T @ beta + 0.5 * rng.standard_normal(n).astype(np.float32)
    return PackedIO(packed, n), y.astype(np.float32), causal


def grouped_binomial(n=20_000, p=1_000, group_size=5, n_true_groups=10,
                     seed=3):
    """Dense f32 X with groups of ``group_size`` and a logistic response
    from ``n_true_groups`` nonzero groups.  Returns (X, y, groups)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32)
    groups = np.arange(0, p, group_size)
    beta = np.zeros(p)
    for g in rng.choice(len(groups), n_true_groups, replace=False):
        beta[groups[g]:groups[g] + group_size] = \
            0.5 * rng.standard_normal(group_size)
    eta = X @ beta
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-eta))).astype(np.float32)
    return X, y, groups
