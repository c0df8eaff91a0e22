"""K7's float32 kernels on the CPU: their numerics emulated in PyTorch, and
their host side.

On the card K7's float32 forward and backward run every float32 product as
three TF32 products (`csrc/tf32x3.cuh`): x = hi + lo with hi = tf32(x) and
lo = tf32(x - hi), both rounded to nearest with ties away from zero
(`cvt.rna`), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, summed in
float32, a_lo b_lo dropped. Here the rounding is emulated by integer bit
operations and each product by three float32 matrix products of the
rounded parts (a product of two TF32 values is exact in float32), inside
the kernels' recurrences at their own blocks: the forward's online softmax
over kv tiles of the float32 kernel's rows, the backward's p, dp, ds and
the three output products. Both are held to the plain versions
(`flash_attention_plain`, `flash_attention_backward_plain`) within K7's
unchanged float32 contracts: 2e-5 (rtol and atol) on the output, 1e-5 on
lse, 1e-5 of each gradient's largest |value|. With one TF32 product (11
bits of each operand) the same recurrences miss those contracts, which is
why the kernels split.

The host side: the float32 kernels' blocks and shared memory against the
tables in the kernels' sources, within what a block can take."""

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

from _torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FWD_TOL, LSE_TOL, BWD_TOL = 2e-5, 1e-5, 1e-5


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32`: x rounded to 10 explicit mantissa bits, ties away
    from zero (float32's bits are sign and magnitude, so adding half of the
    dropped 13 bits' unit rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor) -> tuple:
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: three TF32 products, the small ones
    first, float32 sums."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product."""
    return _tf32(a) @ _tf32(b)


def _mask(lq, lk, causal, window):
    row, col = torch.arange(lq)[:, None], torch.arange(lk)[None, :]
    vis = col < lk
    if causal:
        vis = vis & (col <= row)
    if window > 0:
        vis = vis & (col > row - window)
    return vis


def _forward(q, k, v, causal, window, mm):
    """K7's float32 forward kernel's recurrence: kv tiles of its block rows,
    a running (m, l, acc) a row, `mm` for both products."""
    b, h, lq, d = q.shape
    g = h // k.shape[1]
    lk = k.shape[2]
    _, (_, bk) = fa.f32_blocks(d)
    qs = q * fa._scale(d, q.dtype)
    kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    vis = _mask(lq, lk, causal, window)
    m = torch.full((b, h, lq, 1), -1e30)
    l_ = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for c0 in range(0, lk, bk):
        s = mm(qs, kk[:, :, c0:c0 + bk].transpose(-1, -2))
        s = torch.where(vis[:, c0:c0 + bk], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_ = alpha * l_ + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vv[:, :, c0:c0 + bk])
        m = m_new
    none = m == -1e30
    out = torch.where(none, 0.0, acc / l_.clamp_min(1e-30))
    return out, torch.where(none, torch.inf, m + torch.log(l_))[..., 0]


def _backward(q, k, v, out, lse, dout, causal, window, mm):
    """K7's float32 backward kernels' recurrence (the dK/dV and dQ passes and
    the Δ pre-pass), `mm` for the five products; a GQA group's dk and dv
    summed over its heads in order."""
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = h // hkv
    sc = fa._scale(d, q.dtype)
    qs = q * sc
    kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    delta = (dout * out).sum(-1, keepdim=True)
    p = torch.where(_mask(lq, lk, causal, window),
                    torch.exp(mm(qs, kk.transpose(-1, -2)) - lse[..., None]), 0.0)
    ds = p * (mm(dout, vv.transpose(-1, -2)) - delta)
    dv = mm(p.transpose(-1, -2), dout).reshape(b, hkv, g, lk, d).sum(2)
    dk = mm(ds.transpose(-1, -2), qs).reshape(b, hkv, g, lk, d).sum(2)
    return sc * mm(ds, kk), dk, dv


def _of_scale(ours, ref) -> float:
    return float((ours - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def _inputs(seed, b, h, hkv, lq, lk, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((b, h, lq, d), (b, hkv, lk, d), (b, hkv, lk, d), (b, h, lq, d))]


# GQA groups 1, 2 and 4; causal, windowed and full; every head-dim bucket
# (80 inside 128); Lq != Lk; lengths off the kernels' blocks
CASES = [(1, 4, 1, 96, 96, 64, True, 0), (1, 4, 2, 80, 80, 80, True, 32),
         (1, 2, 2, 70, 70, 128, False, 0), (2, 2, 1, 50, 90, 64, False, 24),
         (1, 2, 1, 40, 40, 320, True, 16), (1, 2, 1, 33, 33, 256, True, 0)]


@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window", CASES)
def test_tf32x3_forward_and_backward_keep_the_float32_contracts(b, h, hkv, lq, lk, d, causal,
                                                                window):
    q, k, v, dout = _inputs(lq * d + window, b, h, hkv, lq, lk, d)
    out, lse = _forward(q, k, v, causal, window, _mm3)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                            return_lse=True)
    assert torch.allclose(out, ref, rtol=FWD_TOL, atol=FWD_TOL), \
        float((out - ref).abs().max())
    assert torch.allclose(lse, ref_lse, rtol=LSE_TOL, atol=LSE_TOL)
    got = _backward(q, k, v, ref, ref_lse, dout, causal, window, _mm3)
    want = fa.flash_attention_backward_plain(q, k, v, ref, ref_lse, dout, causal=causal,
                                             window=window)
    for ours, r, name in zip(got, want, "qkv"):
        assert _of_scale(ours, r) <= BWD_TOL, (name, _of_scale(ours, r))


def test_one_tf32_product_misses_the_float32_contracts():
    """The same recurrences with a single TF32 product a float32 product
    (11 bits of each operand) miss 2e-5 on the output and 1e-5 of scale on
    the gradients: the split is what keeps the contracts."""
    b, h, hkv, lq, lk, d, causal, window = CASES[2]
    q, k, v, dout = _inputs(7, b, h, hkv, lq, lk, d)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                            return_lse=True)
    out, _ = _forward(q, k, v, causal, window, _mm1)
    assert float((out - ref).abs().max()) > 2 * FWD_TOL
    want = fa.flash_attention_backward_plain(q, k, v, ref, ref_lse, dout, causal=causal,
                                             window=window)
    got = _backward(q, k, v, ref, ref_lse, dout, causal, window, _mm1)
    assert min(_of_scale(o, r) for o, r in zip(got, want)) > 2 * BWD_TOL


def test_tf32_rounding_is_to_nearest_with_ties_away():
    """The emulated `cvt.rna`: 10 explicit mantissa bits, the dropped 13
    bits' half rounding the magnitude up for either sign; hi + lo within
    2^-21 of x."""
    one = 1.0 + 2.0 ** -10
    x = torch.tensor([1.0, one, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23,
                      -(1.0 + 2.0 ** -11), 3.0e-3], dtype=torch.float32)
    got = _tf32(x)
    assert got[:5].tolist() == [1.0, one, one, 1.0, -one]
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    r = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi, lo = _split(r)
    assert float(((hi.double() + lo.double() - r.double()) / r.double()).abs().max()) <= 2.0 ** -21


# -- host side -------------------------------------------------------------------------


def _source_table(name: str, pattern: str) -> dict:
    """bucket -> the numbers of a table row in a kernel source's header."""
    text = (_build.CSRC / name).read_text()
    rows = {}
    for m in re.finditer(pattern, text, flags=re.M):
        nums = [int(x.replace(",", "")) for x in re.findall(r"\d[\d,]*", m.group(0))]
        rows[nums[0]] = nums[1:]
    return rows


@pytest.mark.parametrize("bucket", [64, 128, 256, 320])
def test_tf32x3_blocks_and_shared_memory_match_the_sources(bucket):
    """Each float32 kernel's blocks and shared memory at each head-dim bucket
    (`f32_blocks`, `bwd_route`, `tf32x3_smem`, which mirror the kernels'
    layouts) are the source tables' and fit the 232,448 bytes a block can
    take."""
    fwd = _source_table("flash_attention.cu",
                        r"^//\s+\d+\s+\d+\s+\d+\s+\d+\s+[\d,]+ B$")[bucket]
    bwd = _source_table("flash_attention_bwd.cu",
                        r"^//\s+\d+\s+\d+(?: \(pairs\))?, \d+, \d+\s+\d+, \d+, \d+\s+"
                        r"[\d,]+ B, [\d,]+ B$")[bucket]
    smem = fa.tf32x3_smem(bucket)
    assert max(smem.values()) <= fa.SMEM_LIMIT == 232_448
    # forward: warps, q block, kv tile, bytes
    assert fa.f32_blocks(bucket) == (bucket, (fwd[1], fwd[2]))
    assert fwd[0] * 16 == fwd[1] and smem["fwd"] == fwd[3]
    # backward: dK/dV warps, kv tile, q block; dQ warps, q block, kv tile; bytes
    rt = fa.bwd_route(bucket, torch.float32)
    assert rt.route == "tf32x3" and rt.d_pad == bucket
    assert rt.dkv_blocks == (bwd[2], bwd[1]) and rt.dq_blocks == (bwd[4], bwd[5])
    assert bwd[3] * 16 == bwd[4]
    assert (smem["dkv"], smem["dq"]) == (bwd[6], bwd[7])


@pytest.mark.parametrize("d,bucket", [(16, 64), (64, 64), (80, 128), (128, 128), (192, 256),
                                      (320, 320)])
def test_f32_blocks_bucket_the_head_dim(d, bucket):
    """The float32 forward runs at the backward's head-dim buckets on route
    `tf32x3` (bf16 on `wgmma` at its padded head dim); past 320 it
    raises."""
    assert fa.f32_blocks(d)[0] == fa.bwd_route(d, torch.float32).d_pad == bucket
    assert fa.fwd_route(d, torch.float32) == ("tf32x3", bucket, fa.f32_blocks(d)[1])
    assert fa.fwd_route(d, torch.bfloat16) == ("wgmma", fa.padded_head_dim(d), fa.tc_blocks(d))
    with pytest.raises(ValueError, match="head dim 336"):
        fa.f32_blocks(336)
