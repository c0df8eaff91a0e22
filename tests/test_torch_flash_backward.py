"""K7's backward on the CPU: `flash_attention_backward_plain` (the backward
kernel's recurrence, with its rounding points) against autograd through
`flash_attention_plain` and against `jax.grad` of the JAX package's
`models.attention.attention`; the backward's tile plan (`q_tile_plan`)
against the dense mask at both routes' blocks; `bwd_route` (its blocks and
route), the wgmma route's shared memory and the build stamp over the
kernels' header; the wrapper and `model_zoo.k7_backward_launches`.

Tolerances, of each gradient's largest |value|: against the plain
autograd 1e-5 in float32 (the two differ by the order of their float32
sums; measured at most 6.9e-7 on this grid) and 2e-2 in bf16 (the two
round p and ds at different points; at most 6.3e-3); against JAX 1e-5
(float32 only: JAX's `attention` keeps q and p in float32).

The JAX gradients are computed once, in a module fixture: `jax.grad` of
the chunked attention runs op by op and takes seconds a case."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.configs import ARCHS
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import model_zoo

from _torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _arrays(seed, b, h, hkv, lq, lk, d):
    """q, k, v and the output's gradient, (B, H, L, D) float32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, h, lq, d), (b, hkv, lk, d), (b, hkv, lk, d), (b, h, lq, d))]


def _tensors(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _of_scale(ours, ref) -> float:
    """max |ours - ref| over the largest |ref|."""
    ours, ref = (torch.from_numpy(np.array(x, np.float32)) if not isinstance(x, torch.Tensor)
                 else x.float() for x in (ours, ref))
    return float((ours - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def _plain_autograd(q, k, v, dout, causal, window):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention_plain(*leaves, causal=causal, window=window).backward(dout)
    return [t.grad for t in leaves]


def _backward_plain(q, k, v, dout, causal, window):
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        return_lse=True)
    return fa.flash_attention_backward_plain(q, k, v, out, lse, dout, causal=causal,
                                             window=window), lse


# -- (a) the plain backward against the plain version's autograd -----------------


@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("length", [257, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plain_matches_plain_autograd(h, hkv, causal, window, d, length, dtype):
    """GQA 8/2 and MHA; causal, non-causal, window 64; head dims 64, 80 and
    128; lengths off the 128-column block. The gradients keep the inputs'
    types and shapes."""
    q, k, v, dout = _tensors(_arrays(length + d + window, 1, h, hkv, length, length, d), dtype)
    got, lse = _backward_plain(q, k, v, dout, causal, window)
    assert torch.isfinite(lse).all()
    ref = _plain_autograd(q, k, v, dout, causal, window)
    for ours, want, name in zip(got, ref, "qkv"):
        assert ours.dtype == dtype and ours.shape == want.shape
        assert _of_scale(ours, want) <= TOL[dtype], (name, _of_scale(ours, want))
        assert ours.abs().max() > 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_with_no_visible_column(causal, dtype):
    """Lq 300 over Lk 100 with window 64: rows 163 and after see no column.
    Their lse is +inf (the value the kernel writes for them), so their p is
    0: dq is 0 there and they add nothing to dk and dv, the gradient of the
    kernel's output 0 there. Every other row's gradients equal the plain
    autograd's with the empty rows' output gradient set to 0."""
    q, k, v, dout = _tensors(_arrays(9, 1, 4, 2, 300, 100, 64), dtype)
    got, lse = _backward_plain(q, k, v, dout, causal, 64)
    assert torch.isinf(lse[..., 163:]).all() and (lse[..., 163:] > 0).all()
    assert torch.isfinite(lse[..., :163]).all()
    assert (got[0][:, :, 163:] == 0).all()
    dout[:, :, 163:] = 0
    ref = _plain_autograd(q, k, v, dout, causal, 64)
    for ours, want, name in zip(got, ref, "qkv"):
        assert _of_scale(ours, want) <= TOL[dtype], (name, _of_scale(ours, want))


def test_lse_is_the_rows_logsumexp():
    """`flash_attention_plain(..., return_lse=True)`'s lse is the log-sum-exp
    of each row's visible scaled scores."""
    q, k, v, _ = _tensors(_arrays(4, 2, 4, 2, 200, 200, 32), torch.float32)
    _, lse = fa.flash_attention_plain(q, k, v, causal=True, window=40, return_lse=True)
    s = (q * 32 ** -0.5) @ k.repeat_interleave(2, 1).transpose(-1, -2)
    row, col = torch.arange(200)[:, None], torch.arange(200)[None, :]
    s = s.masked_fill(~((col <= row) & (col > row - 40)), -torch.inf)
    assert torch.allclose(lse, torch.logsumexp(s, -1), rtol=1e-6, atol=1e-5)


# -- (b) both against jax.grad of the JAX package's attention -------------------------

JAX_CASES = [(1, 8, 2, 257, 64, True, 0), (1, 4, 4, 300, 80, False, 0),
             (1, 8, 2, 300, 128, True, 64), (2, 4, 2, 257, 128, False, 64)]


def _bshd(a):
    return a.transpose(0, 2, 1, 3)


@pytest.fixture(scope="module")
def jax_grads():
    """case → (arrays, JAX's dq, dk, dv) as (B, H, L, D) numpy."""
    out = {}
    for case in JAX_CASES:
        b, h, hkv, length, d, causal, window = case
        arrays = _arrays(sum(case), b, h, hkv, length, length, d)
        w = jnp.asarray(_bshd(arrays[3]))

        def loss(q, k, v, causal=causal, window=window, w=w):
            return jnp.sum(jattn.attention(q, k, v, causal=causal, window=window) * w)

        grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(_bshd(a)) for a in arrays[:3]))
        out[case] = (arrays, [_bshd(np.asarray(g)) for g in grads])
    return out


@pytest.mark.parametrize("case", JAX_CASES)
def test_backward_matches_jax_grad(jax_grads, case):
    """float32: the plain backward and the plain version's autograd against
    `jax.grad` of `repro.models.attention.attention` on the same arrays."""
    _b, _h, _hkv, _l, _d, causal, window = case
    arrays, want = jax_grads[case]
    q, k, v, dout = _tensors(arrays, torch.float32)
    got, _ = _backward_plain(q, k, v, dout, causal, window)
    auto = _plain_autograd(q, k, v, dout, causal, window)
    for ours, plain, ref, name in zip(got, auto, want, "qkv"):
        assert _of_scale(ours, ref) <= 1e-5, (name, _of_scale(ours, ref))
        assert _of_scale(plain, ref) <= 1e-5, (name, _of_scale(plain, ref))


# -- (c) the backward's tile plan -----------------------------------------------------


def _visible(lq, lk, causal, window):
    row, col = np.arange(lq)[:, None], np.arange(lk)[None, :]
    vis = np.ones((lq, lk), bool)
    if causal:
        vis &= col <= row
    if window > 0:
        vis &= col > row - window
    return vis


@pytest.mark.parametrize("lq,lk", [(1, 1), (65, 65), (200, 200), (2049, 2049), (65, 200),
                                   (300, 130)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (True, 1024), (False, 0),
                                           (False, 24)])
@pytest.mark.parametrize("block_q,block_k", [(64, 64), (64, 32), (32, 32), (64, 128)])
def test_q_tile_plan_matches_the_dense_mask(lq, lk, causal, window, block_q, block_k):
    """Every kv tile is visited by exactly the q blocks from its first to its
    last that see it; the blocks it runs unmasked have every row < lq and
    see every column of the tile, all < lk; tiles go longest first."""
    vis = _visible(lq, lk, causal, window)
    plan = fa.q_tile_plan(lq, lk, block_q, block_k, causal, window)
    n_qb, n_kb = -(-lq // block_q), -(-lk // block_k)
    assert plan.dtype == np.int32 and plan.shape == (n_kb, 5)
    assert sorted(plan[:, 0].tolist()) == list(range(n_kb))
    assert (np.diff(plan[:, 2] - plan[:, 1]) <= 0).all()
    for kb, first, end, full_first, full_end in plan.tolist():
        cols = vis[:, kb * block_k:(kb + 1) * block_k]
        seen = [cols[qb * block_q:(qb + 1) * block_q].any() for qb in range(n_qb)]
        hit = [qb for qb in range(n_qb) if seen[qb]]
        assert (first, end) == ((hit[0], hit[-1] + 1) if hit else (first, first))
        for qb in range(first, end):
            block = cols[qb * block_q:(qb + 1) * block_q]
            full = block.shape == (block_q, block_k) and block.all()
            assert (full_first <= qb < full_end) == full, (kb, qb)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("d,dtype,blocks", [
    (16, BF16, ("wgmma", 64, (128, 64), (64, 128))),
    (80, BF16, ("wgmma", 128, (128, 64), (64, 128))),
    (128, BF16, ("wgmma", 128, (128, 64), (64, 128))),
    (192, BF16, ("wgmma", 256, (128, 32), (32, 64))),
    (320, BF16, ("wgmma", 320, (128, 16), (32, 64))),
    (64, F32, ("tf32x3", 64, (128, 64), (32, 128))),
    (256, F32, ("tf32x3", 256, (64, 16), (8, 64))),
    (320, F32, ("tf32x3", 320, (64, 16), (8, 64))),
    (64, BF16, ("wgmma", 64, (128, 64), (64, 128))),
    (80, F32, ("tf32x3", 128, (128, 32), (16, 128))),
    (256, BF16, ("wgmma", 256, (128, 32), (32, 64)))])
def test_bwd_blocks(d, dtype, blocks):
    """`bwd_route`: the backward's route, head-dim bucket and (q block, kv
    tile) rows of the dQ and dK/dV passes by type and head dim, as
    `csrc/flash_attention_bwd.cu` instantiates them: bf16 on the wgmma
    kernels at every bucket (head dim 80 in bucket 128, 192 in 256),
    float32 on the tf32x3 kernels."""
    assert tuple(fa.bwd_route(d, dtype)) == blocks
    with pytest.raises(ValueError, match="head dim 336"):
        fa.bwd_route(336, dtype)


def _bwd_source() -> str:
    return (Path(fa.__file__).parent / "csrc" / "flash_attention_bwd.cu").read_text()


def _source_smem_table() -> dict:
    """The wgmma route's shared-memory table in the source's header:
    (pass, D_pad) -> (kv tile, q block, stages, bytes)."""
    import re
    rows = re.findall(r"^//\s+(dK/dV|dQ)\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)\s+([\d,]+) B",
                      _bwd_source(), flags=re.M)
    return {("dkv" if p == "dK/dV" else "dq", int(d)): (int(kv), int(q), int(st),
                                                        int(b.replace(",", "")))
            for p, d, kv, q, st, b in rows}


def _source_blocks() -> dict:
    """`tc::Blocks<D_pad>` as the source instantiates it: D_pad -> (pass ->
    (kv tile, q block, stages))."""
    import re
    rows = re.findall(r"struct Blocks<(\d+)> \{[^}]*KV_BN = (\d+), KV_BM = (\d+), "
                      r"KV_S = (\d+), Q_BM = (\d+), Q_BN = (\d+), Q_S = (\d+);", _bwd_source())
    return {int(d): {"dkv": (int(kb), int(kq), int(ks)), "dq": (int(qb), int(qq), int(qs))}
            for d, kb, kq, ks, qq, qb, qs in rows}


def _source_smem_asserts() -> dict:
    """The bytes the source's static_asserts hold each layout to at build
    time: (pass, D_pad) -> bytes."""
    import re
    rows = re.findall(r"static_assert\((DkvLayout|DqLayout)<(\d+)>::SMEM == (\d+),",
                      _bwd_source())
    return {("dkv" if p == "DkvLayout" else "dq", int(d)): int(b) for p, d, b in rows}


@pytest.mark.parametrize("d_pad,nbytes", [(64, (101_504, 99_456)), (128, (199_808, 197_760)),
                                          (256, (215_168, 230_528)),
                                          (320, (223_104, 226_432))])
def test_wgmma_backward_shared_memory_fits(d_pad, nbytes):
    """Each wgmma pass's shared memory fits the 232,448 bytes a block can
    take, at every bucket the route serves: the source's table gives the
    bytes, its static_asserts hold the kernel's layouts (`DkvLayout`,
    `DqLayout`) to them at build time, and the table's blocks and stages
    are `tc::Blocks`'s, whose blocks `bwd_route` plans with."""
    assert tuple(fa._BWD_WGMMA) == fa._BWD_BUCKETS
    table, blocks, asserted = _source_smem_table(), _source_blocks(), _source_smem_asserts()
    assert max(nbytes) <= fa.SMEM_LIMIT == 232_448
    for pass_, n, (q_block, kv_tile) in zip(("dkv", "dq"), nbytes, fa._BWD_WGMMA[d_pad][::-1]):
        assert table[(pass_, d_pad)] == (*blocks[d_pad][pass_], n)
        assert asserted[(pass_, d_pad)] == n
        assert blocks[d_pad][pass_][:2] == (kv_tile, q_block)


def test_bf16_backward_has_one_route():
    """The bf16 backward runs on the wgmma kernels at every head dim the
    kernel takes: no route code for the retired `mma_sync` kernels, and
    `bwd_route` gives `wgmma` from 16 to 320."""
    assert set(fa._BWD_ROUTE_CODE) == {"wgmma", "tf32x3"}
    assert 0 not in fa._BWD_ROUTE_CODE.values()
    routes = {fa.bwd_route(d, BF16).route for d in range(16, fa.MAX_HEAD_DIM + 1, 16)}
    assert routes == {"wgmma"}


def test_build_stamp_covers_headers(tmp_path):
    """A change to a header's bytes (`csrc/*.cuh`) changes the build's
    stamp, so the library is rebuilt; so does a source's, and nothing else
    in the directory counts."""
    from repro_torch.kernels import _build

    assert (_build.CSRC / "sm90.cuh").exists()
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build.sources_digest(tmp_path)
    (tmp_path / "notes.txt").write_text("not a source")
    assert _build.sources_digest(tmp_path) == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build.sources_digest(tmp_path)
    assert second != first
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n// changed\n')
    assert _build.sources_digest(tmp_path) not in (first, second)


# -- the wrapper on the CPU, the launch count of a train step --------------------------


def test_backward_wrapper_runs_the_plain_version_on_the_cpu():
    """On CPU tensors `flash_attention_backward` is the plain version, counts
    no launch and returns only the gradients asked for."""
    q, k, v, dout = _tensors(_arrays(2, 1, 4, 2, 40, 40, 16), torch.float32)
    out, lse = fa.flash_attention_plain(q, k, v, causal=True, window=8, return_lse=True)
    before = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(q, k, v, out, lse, dout, causal=True, window=8)
    want = fa.flash_attention_backward_plain(q, k, v, out, lse, dout, causal=True, window=8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dq, dk, dv = fa.flash_attention_backward(q, k, v, out, lse, dout, causal=True, window=8,
                                             need_dkv=False)
    assert torch.equal(dq, want[0]) and dk is None and dv is None
    assert fa.flash_attention_backward.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_backward(*(t.to("meta") for t in (q, k, v, out, lse, dout)))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_k7_backward_launches(name):
    """One backward launch a train step for each attention call of the loss
    (the prefill's count), remat or not; the forward count with remat is
    never below it."""
    cfg = ARCHS[name]
    assert model_zoo.k7_backward_launches(cfg) == model_zoo.k7_prefill_launches(cfg)
    assert model_zoo.k7_train_launches(cfg) >= model_zoo.k7_backward_launches(cfg)
