"""Port parity: the Δcut codec (`encode`, `decode`, `roundtrip`) and K5's
plain version against the JAX package, on the same rows and codebook."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close, assert_equal, np_, to_torch_codec,
                           to_torch_gaussians)

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
