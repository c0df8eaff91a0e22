"""Adversarial inputs for K5 (VQ codeword assignment), made with numpy.

A helper module the test files import by name (like `_raster_cases.py`);
it imports numpy only, so the CUDA tests and `chip_smoke.py` can use it
without JAX.

`vq_cases(d)` gives, for rows of d floats, cases that stress an exact
argmin and a filter with an error bound: every codeword equal; codewords
one ulp apart in one component; rows at exact dyadic midpoints of two
codewords; magnitudes near 1e18 (some scores overflow) and subnormals;
NaN and inf in rows and in the codebook; Kc of 1, 7, 255 and 256 and M of
0, 1 and 65 (a row tile of 32 and a ragged one).
"""

from __future__ import annotations

import numpy as np

DIMS = (1, 9, 24, 45)
MAX_NORM = 2.0 ** 40    # the filter's bound on Σ|x_d| and max|c|


class Case:
    """One input: rows `x` (M, d), `codebook` (Kc, d), both float32.
    `dyadic`: every value is a small multiple of 1/8, so every sum is exact
    in float32 whatever its order."""

    def __init__(self, name, x, codebook, dyadic=False):
        self.name = name
        self.x = np.ascontiguousarray(x, np.float32)
        self.codebook = np.ascontiguousarray(codebook, np.float32)
        self.dyadic = dyadic

    def scanned_rows(self) -> int:
        """Rows the kernel gives to its plain scan instead of the filter."""
        m, d = self.x.shape
        cb = self.codebook.astype(np.float64)
        if d == 1 or not (np.abs(cb) <= MAX_NORM).all():
            return m
        x1 = np.abs(self.x.astype(np.float64)).sum(1)
        return int((~(x1 <= MAX_NORM)).sum())


def _dyadic(rng, shape):
    return rng.integers(-8, 9, size=shape).astype(np.float32) / 8


def vq_cases(d: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed + 1000 * d)
    cases = []

    cb = rng.normal(size=(256, d)).astype(np.float32)
    x = rng.normal(size=(65, d)).astype(np.float32)
    x[:5] = cb[17] + np.float32(1e-3)
    cb[200] = cb[17]                      # an exact tie across the 128-blocks
    cases.append(Case("gaussian", x, cb))
    cases.append(Case("one row, one code", _dyadic(rng, (1, d)), _dyadic(rng, (1, d)), True))
    cases.append(Case("no rows", np.zeros((0, d), np.float32), rng.normal(size=(7, d))))

    base = _dyadic(rng, (1, d))
    cases.append(Case("every codeword equal", _dyadic(rng, (65, d)), np.repeat(base, 7, 0),
                      True))

    # codewords 1 ulp apart in component j, rows near them: near-ties
    j = int(rng.integers(d))
    c0 = rng.normal(size=d).astype(np.float32)
    ulps = np.empty((255, d), np.float32)
    v = c0[j]
    for k in range(255):
        ulps[k] = c0
        ulps[k, j] = v
        v = np.nextafter(v, np.float32(np.inf))
    x = (c0[None, :] + rng.normal(scale=1e-6, size=(65, d))).astype(np.float32)
    x[:8] = ulps[rng.integers(255, size=8)]
    cases.append(Case("codewords 1 ulp apart", x, ulps))

    # rows at the exact midpoint of two codewords: equal exact scores
    cb = _dyadic(rng, (256, d))
    a, b = rng.integers(256, size=65), rng.integers(256, size=65)
    cases.append(Case("dyadic midpoints", (cb[a] + cb[b]) / 2, cb, True))

    # near 1e18: X1 > 2^40 takes the scan; at 1e19 and 1e20 scores overflow
    cb = (rng.normal(size=(256, d)) * 1e18).astype(np.float32)
    x = (rng.normal(size=(65, d)) * 1e18).astype(np.float32)
    x[10:20] *= np.float32(10.0)
    x[20:25] *= np.float32(100.0)
    x[30:40] = rng.normal(size=(10, d))  # ordinary rows beside them
    cases.append(Case("near 1e18 and overflow", x, cb))
    x = rng.normal(size=(65, d)).astype(np.float32)
    x[:10] = (x[:10] * 1e18).astype(np.float32)
    cases.append(Case("huge rows, ordinary codebook", x, rng.normal(size=(256, d))))

    # subnormal rows and codewords (and a mix of scales)
    sub = np.float32(1e-40)
    cb = (rng.normal(size=(255, d)) * sub).astype(np.float32)
    x = (rng.normal(size=(65, d)) * sub).astype(np.float32)
    x[40:] = rng.normal(size=(25, d)) * 1e-20
    cases.append(Case("subnormal", x, cb))

    # NaN and inf in rows; then in the codebook (every row takes the scan)
    cb = rng.normal(size=(256, d)).astype(np.float32)
    x = rng.normal(size=(65, d)).astype(np.float32)
    x[3, 0] = np.nan
    x[7, d - 1] = np.inf
    x[11, d // 2] = -np.inf
    x[12] = np.nan
    cases.append(Case("NaN and inf rows", x, cb))
    cb = rng.normal(size=(7, d)).astype(np.float32)
    cb[2, 0] = np.nan
    cb[5, d - 1] = np.inf
    cases.append(Case("NaN and inf codewords", rng.normal(size=(65, d)), cb))
    return cases
