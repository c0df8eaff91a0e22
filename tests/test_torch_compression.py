"""Port parity: the Δcut codec (`encode`, `decode`, `roundtrip`) and K5's
plain version against the JAX package, on the same rows and codebook."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close, assert_equal, np_, to_torch_codec,
                           to_torch_gaussians)
from _vq_cases import DIMS, MAX_NORM, vq_cases

from repro.core import compression as jcomp
from repro.kernels.vq_assign import vq_assign_pallas
from repro_torch import convert
from repro_torch import kernels as tkernels
from repro_torch.core import compression as tcomp
from repro_torch.kernels import vq_assign as tvq

FIELDS = ("dc", "code", "pos_q", "scale_q", "quat_q", "opa_q")


@pytest.fixture(scope="module")
def coded(small_tree):
    """The tree's Gaussians encoded by JAX with its own fitted codec, and the
    same inputs carried into the port."""
    g = small_tree.gaussians
    jcodec = jcomp.fit_codec(g, k_codes=256, iters=6)
    jenc = jcomp.encode(jcodec, g)
    jdec = jcomp.decode(jcodec, jenc, g.sh.shape[1])
    return g, jcodec, jenc, jdec, to_torch_gaussians(g), to_torch_codec(jcodec)


def test_encode_fields_exact(coded):
    g, jcodec, jenc, _jdec, tg, tcodec = coded
    tkernels.reset_launch_counts()
    tenc = tcomp.encode(tcodec, tg)
    assert tkernels.launch_counts()["vq_assign"] == 0  # CPU: plain version
    assert_equal(tenc.dc, jenc.dc, "dc")
    for f in FIELDS[1:]:  # the port carries uint16 codes as int32
        assert_equal(np_(getattr(tenc, f)).astype(np.int64),
                     np.asarray(getattr(jenc, f)).astype(np.int64), f)
    assert tenc.dc.dtype == torch.float16 and tenc.quat_q.dtype == torch.int16
    # the codes are those of the reference's oracle (no near-tie flips here)
    n = g.mu.shape[0]
    ac = jnp.asarray(np.asarray(g.sh[:, 1:, :]).reshape(n, -1))
    assert_equal(tenc.code, jcomp.vq_assign_ref(ac, jcodec.codebook))


def test_decode_and_roundtrip_within_tolerance(coded):
    g, jcodec, jenc, jdec, tg, tcodec = coded
    carried = convert.encoded_from_arrays(
        {f: np.asarray(getattr(jenc, f)) for f in FIELDS}, CPU)
    tdec = tcomp.decode(tcodec, carried, g.sh.shape[1])
    jround = jcomp.roundtrip(jcodec, g)
    tround = tcomp.roundtrip(tcodec, tg)
    for f in ("mu", "log_scale", "quat", "opacity", "sh"):
        assert_close(getattr(tdec, f), getattr(jdec, f), 1e-6, 1e-6, f)
        assert_close(getattr(tround, f), getattr(jround, f), 1e-6, 1e-6, f)
    assert tcomp.max_position_error(tcodec) == jcomp.max_position_error(jcodec)
    rows = torch.tensor([3, -1, 0, 7], dtype=torch.int32)
    enc = tcomp.encode_rows(tcodec, tg, rows)
    assert_equal(enc.pos_q, tcomp.encode(tcodec, tg.slice_rows(rows.clamp_min(0))).pos_q)


def _planted_case(d: int, exact: bool):
    """1000 rows against 256 codewords. `exact`: small multiples of 1/8, so
    every score is exact in float32 whatever the summation order, and rows
    128..255 of the codebook repeat rows 0..127 — every row then ties across
    the two 128-blocks, which the earlier block must win."""
    rng = np.random.default_rng(d + 100 * exact)
    if exact:
        cb = rng.integers(-8, 9, size=(128, d)).astype(np.float32) / 8
        cb = np.concatenate([cb, cb])
        x = rng.integers(-8, 9, size=(1000, d)).astype(np.float32) / 8
    else:
        cb = rng.normal(size=(256, d)).astype(np.float32)
        x = rng.normal(size=(1000, d)).astype(np.float32)
    return x, cb


@pytest.mark.parametrize("d", [9, 24])
@pytest.mark.parametrize("exact", [True, False], ids=["planted-ties", "gaussian"])
def test_vq_plain_matches_pallas(d, exact):
    x, cb = _planted_case(d, exact)
    want = np.asarray(vq_assign_pallas(jnp.asarray(x), jnp.asarray(cb), interpret=True))
    got = tvq.vq_assign_plain(torch.from_numpy(x), torch.from_numpy(cb))
    assert got.dtype == torch.int32
    assert_equal(got, want)
    if exact:
        assert int((want < 128).sum()) == 1000  # every tie went to the first block


@pytest.mark.parametrize("d", DIMS)
def test_vq_plain_matches_pallas_on_dyadic_cases(d):
    """K5's plain version against the Pallas kernel (interpret mode) and the
    reference's oracle on the dyadic cases of `tests/_vq_cases.py` (every
    codeword equal, rows at exact midpoints of two codewords, one row and
    one code), where every summation order gives the same scores: the
    ties go to the lowest index in all three."""
    cases = [c for c in vq_cases(d) if c.dyadic]
    assert len(cases) == 3
    for c in cases:
        x, cb = jnp.asarray(c.x), jnp.asarray(c.codebook)
        got = tvq.vq_assign_plain(torch.from_numpy(c.x), torch.from_numpy(c.codebook))
        assert_equal(got, vq_assign_pallas(x, cb, interpret=True), c.name)
        assert_equal(got, jcomp.vq_assign_ref(x, cb), c.name)
        if c.name == "every codeword equal":
            assert not bool(got.any())


def _tf32(a):
    """float32 → TF32 (10 explicit mantissa bits), rounding half away from
    zero, as `cvt.rna.tf32.f32`."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    """The kernel's two TF32 parts of float32 values, as float64."""
    hi = _tf32(a)
    return hi.astype(np.float64), _tf32(np.float32(a) - hi).astype(np.float64)


@pytest.mark.parametrize("d", DIMS[1:])
def test_vq_filter_bound_covers_tf32_and_the_plain_rounding(d):
    """The bound of `csrc/vq_assign.cu` on every case the filter takes:
    with the split-TF32 products (lo·hi + hi·lo + hi·hi) summed exactly
    (float64) and the plain version's own float32 scores, |h_k + s_k/2| ≤
    E0 = E/2 for every code. Among the codes it keeps (a codeword equal to
    an earlier one never is one), those within 2E of the best h hold the
    plain version's answer, and where the best is the only one (the rows
    the kernel's first pass settles) it is that answer; a zero row's is the
    first code of least c2. The kernel's MMA adds its accumulation error,
    which the bound counts, inside the safety factor of 2."""
    tiny = 2.0 ** -100
    k_steps = d // 8 + (d % 8 > 4) + (0 < d % 8 <= 4)
    n_add = 27 * k_steps
    coef_xc, coef_c2 = (2.02 * n_add + 30) * 2.0 ** -23, (n_add / 2 + 1) * 2.0 ** -23
    for c in vq_cases(d):
        if c.x.shape[0] == 0 or not (np.abs(c.codebook.astype(np.float64)) <= MAX_NORM).all():
            continue
        x1 = np.abs(c.x).astype(np.float32).sum(1, dtype=np.float32)
        take = x1 <= MAX_NORM
        xs = c.x[take]
        xt, ct = torch.from_numpy(xs), torch.from_numpy(c.codebook)
        c2 = tvq.codeword_norms(ct)
        dot = xt[:, 0:1] * ct[None, :, 0]
        for j in range(1, d):
            dot = dot + xt[:, j:j + 1] * ct[None, :, j]
        s = (c2[None, :] - 2.0 * dot).numpy().astype(np.float64)
        (xh, xl), (ch, cl) = _split(xs), _split(c.codebook)
        h = xl @ ch.T + xh @ cl.T + xh @ ch.T - c2.numpy().astype(np.float64)[None, :] / 2
        ss = (xs.astype(np.float32) ** 2).sum(1, dtype=np.float32)
        xn = np.where(ss >= tiny, 1.0001 * np.sqrt(ss), 1.0001 * x1[take])
        c2max = float(c2.max())
        cn = 1.0001 * np.sqrt(c2max) if c2max >= tiny else 7.0 * float(np.abs(c.codebook).max())
        e = 2.0 * (coef_xc * xn * cn + coef_c2 * c2max + 2.0 ** -120 * (xn + cn) + 2.0 ** -110)
        assert (np.abs(h + s / 2).max(1) <= e / 2).all(), c.name
        kc = c.codebook.shape[0]
        dup = np.array([any((c.codebook[j] == c.codebook[k]).all() for j in range(k))
                        for k in range(kc)])
        hk = np.where(dup[None, :], -1e38, h)
        want = tvq.vq_assign_plain(xt, ct).numpy()
        zero = x1[take] == 0
        assert (want[zero] == int(np.argmin(c2.numpy()))).all(), c.name
        cand = hk >= hk.max(1, keepdims=True) - 2 * e[:, None]
        assert cand[np.arange(len(want)), want][~zero].all(), c.name
        alone = (cand.sum(1) == 1) & ~zero
        assert (hk.argmax(1)[alone] == want[alone]).all(), c.name
        if c.name == "gaussian":    # the filter settles most ordinary rows alone
            assert alone.mean() > 0.9, cand.sum(1).mean()
