"""The port's attention pieces against the JAX package on the CPU: K7's plain
version (`flash_attention_plain`) against the Pallas kernel in interpret
mode and `kref.ref_attention`; `models.attention.attention` against the
JAX chunked `attention`; `rmsnorm` and `apply_rope`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _pair(a: np.ndarray, dtype):
    """The same values as a JAX array and a torch tensor of `dtype` (bf16
    rounded once, by JAX, and carried exactly through float32)."""
    j = jnp.asarray(a, dtype)
    return j, torch.from_numpy(np.array(j, np.float32)).to(TORCH_DTYPE[dtype])


def _qkv(seed, b, h, hkv, lq, lk, d, dtype):
    rng = np.random.default_rng(seed)
    return [_pair(rng.normal(size=s), dtype)
            for s in ((b, h, lq, d), (b, hkv, lk, d), (b, hkv, lk, d))]


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_f32(a), _f32(b), rtol=tol, atol=tol)


# -- K7's plain version ------------------------------------------------------------


@pytest.mark.parametrize("b,h,hkv,lq,lk,d", [
    (1, 4, 4, 64, 64, 32),
    (2, 8, 2, 128, 128, 16),   # GQA
    (1, 4, 1, 96, 96, 32),     # MQA
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_plain_matches_pallas_and_ref(b, h, hkv, lq, lk, d, causal, window, dtype):
    """The grid of tests/test_kernels.py::test_flash_attention_kernel."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(h * lq + window, b, h, hkv, lq, lk, d, dtype)
    out = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == TORCH_DTYPE[dtype] and out.shape == tq.shape
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    interpret=True)
    _close(out, pallas, tol)
    _close(out, kref.ref_attention(jq, jk, jv, causal=causal, window=window), tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_plain_leading_fully_masked_block(dtype):
    """Window 32 over 256 rows: for rows ≥ 160 the first 128-column kv block
    is masked whole, so the running max starts at -1e30 with p = 1 and the
    next block wipes it (alpha = 0)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(5, 1, 4, 2, 256, 256, 32, dtype)
    out = fa.flash_attention_plain(tq, tk, tv, causal=True, window=32)
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    assert torch.isfinite(out.float()).all()
    _close(out, flash_attention_pallas(jq, jk, jv, causal=True, window=32,
                                       interpret=True), tol)
    _close(out, kref.ref_attention(jq, jk, jv, causal=True, window=32), tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_plain_ragged_length(causal, window, dtype):
    """L = 200 is not a multiple of the 128-column block: columns past L are
    masked and padded rows dropped. Held to `ref_attention` only: the Pallas
    kernel clamps its last slices here and gets rows ≥ 128 wrong (ROADMAP.md,
    faults of the reference)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(7, 2, 4, 2, 200, 200, 16, dtype)
    out = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    _close(out, kref.ref_attention(jq, jk, jv, causal=causal, window=window), tol)


def test_pallas_k7_ragged_rows_are_a_fault_of_the_reference():
    """Pins the ROADMAP.md entry: at L = 200 the Pallas kernel reads its last
    Q and K/V blocks as clamped 128-row slices (rows 72..199 labelled
    128..255), so its rows ≥ 128 are wrong and its rows < 128 right. The
    port masks instead and matches `ref_attention` on every row."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(7, 2, 4, 2, 200, 200, 16, jnp.float32)
    pallas = _f32(flash_attention_pallas(jq, jk, jv, causal=True, interpret=True))
    ref = _f32(kref.ref_attention(jq, jk, jv, causal=True))
    _close(pallas[:, :, :128], ref[:, :, :128], 2e-5)
    assert np.abs(pallas[:, :, 128:] - ref[:, :, 128:]).max() > 1e-2
    _close(fa.flash_attention_plain(tq, tk, tv, causal=True), ref, 2e-5)


def test_flash_wrapper_runs_the_plain_version_on_the_cpu():
    (_, tq), (_, tk), (_, tv) = _qkv(1, 1, 4, 2, 40, 40, 16, jnp.float32)
    before = fa.flash_attention.launches
    out = fa.flash_attention(tq, tk, tv, causal=True, window=8)
    assert torch.equal(out, fa.flash_attention_plain(tq, tk, tv, causal=True, window=8))
    assert fa.flash_attention.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(tq.to("meta"), tk.to("meta"), tv.to("meta"))


# -- the bf16 kernel's host-side plan -------------------------------------------------


@pytest.mark.parametrize("d,d_pad", [(16, 64), (64, 64), (80, 128), (128, 128),
                                     (144, 192), (192, 192), (256, 256), (272, 320),
                                     (320, 320)])
def test_padded_head_dim(d, d_pad):
    assert fa.padded_head_dim(d) == d_pad
    bq, bk = fa.tc_blocks(d)
    assert bq in (64, 128) and bk in (64, 128)


def test_padded_head_dim_refuses_past_320():
    with pytest.raises(ValueError, match="head dim 336"):
        fa.padded_head_dim(336)


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
@pytest.mark.parametrize("block_q,block_k", [(128, 128), (128, 64), (64, 64), (64, 128)])
def test_kv_tile_plan_matches_the_dense_mask(lq, lk, causal, window, block_q, block_k):
    """Every q block visits exactly the kv tiles from its first to its last
    visible one; the tiles it runs unmasked are visible to each of its rows
    at every column; blocks go longest first."""
    vis = _visible(lq, lk, causal, window)
    plan = fa.kv_tile_plan(lq, lk, block_q, block_k, causal, window)
    n_qb, n_kb = -(-lq // block_q), -(-lk // block_k)
    assert plan.dtype == np.int32 and plan.shape == (n_qb, 5)
    assert sorted(plan[:, 0].tolist()) == list(range(n_qb))
    lengths = plan[:, 2] - plan[:, 1]
    assert (np.diff(lengths) <= 0).all()
    for qb, first, end, full_first, full_end in plan.tolist():
        rows = vis[qb * block_q:(qb + 1) * block_q]
        seen = [rows[:, kb * block_k:(kb + 1) * block_k].any() for kb in range(n_kb)]
        hit = [kb for kb in range(n_kb) if seen[kb]]
        assert (first, end) == ((hit[0], hit[-1] + 1) if hit else (first, first))
        for kb in range(first, end):
            cols = rows[:, kb * block_k:(kb + 1) * block_k]
            full = cols.shape[1] == block_k and cols.all()
            assert (full_first <= kb < full_end) == full, (qb, kb)


def test_check_tma_layout():
    """The bf16 kernel reads q, k and v by TMA as they lie: 16-byte aligned
    bases and strides pass, anything else raises with what is wrong."""
    x = torch.zeros((2, 100, 8, 32), dtype=torch.bfloat16)
    fa.check_tma_layout("q", x.transpose(1, 2))
    with pytest.raises(ValueError, match="head stride 72 B"):
        fa.check_tma_layout("q", torch.zeros((2, 100, 8, 36),
                                             dtype=torch.bfloat16)[..., :32].transpose(1, 2))
    with pytest.raises(ValueError, match="base address"):
        fa.check_tma_layout("k", torch.zeros(x.numel() + 8, dtype=torch.bfloat16)[1:1 + x.numel()]
                            .view(x.shape))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma3-4b", "stablelm-1.6b",
                                  "mistral-large-123b"])
def test_model_views_meet_the_tma_layout(arch):
    """The views the dense model hands K7 (separately projected q, k, v after
    RoPE, seen as (B, H, L, D)) meet the bf16 kernel's alignment."""
    from repro_torch.configs import get_arch
    from repro_torch.models import dense
    from repro_torch.models.config import reduced
    full = get_arch(arch)
    cfg = reduced(full, head_dim=full.hd, dtype="bfloat16", n_layers=1)
    model = dense.DenseLM(cfg, seed=0, device="cpu")
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator().manual_seed(0))
    q, k, v = model.layers[0].qkv_rope(x.bfloat16(), torch.arange(40))
    assert q.shape[-1] == full.hd
    for name, t in (("q", q), ("k", k), ("v", v)):
        fa.check_tma_layout(name, t.transpose(1, 2))
        assert fa.padded_head_dim(t.shape[-1]) >= t.shape[-1]


# -- the port's attention against the JAX chunked attention -------------------------


def _bshd(seed, b, sq, sk, h, hkv, d, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    return [_pair(rng.normal(size=s), dtype)
            for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]


ATTN_CASES = {
    "causal": dict(sq=40, sk=40, kw=dict(causal=True)),
    "window": dict(sq=40, sk=40, kw=dict(causal=True, window=8)),
    "noncausal": dict(sq=40, sk=40, kw=dict(causal=False)),
    "prefix_len": dict(sq=40, sk=40, kw=dict(causal=True, prefix_len=10)),
    "prefix_len_per_batch": dict(sq=40, sk=40,
                                 kw=dict(causal=True, prefix_len=np.array([3, 17]))),
    "q_offset_cache": dict(sq=4, sk=48, kw=dict(causal=True, q_offset=30,
                                                kv_valid_len=34)),
    "decode_per_batch_len": dict(sq=1, sk=48, kw=dict(causal=False,
                                                      kv_valid_len=np.array([5, 48]))),
    "kv_chunk_padded": dict(sq=40, sk=40, kw=dict(causal=True, kv_chunk=16)),
    "q_chunk": dict(sq=40, sk=40, kw=dict(causal=True, window=12, q_chunk=8,
                                          kv_chunk=16)),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_jax(case):
    c = ATTN_CASES[case]
    (jq, tq), (jk, tk), (jv, tv) = _bshd(len(case), 2, c["sq"], c["sk"], 4, 2, 16)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in c["kw"].items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in c["kw"].items()}
    want = jattn.attention(jq, jk, jv, **jkw)
    got = tattn.attention(tq, tk, tv, **tkw)
    assert got.shape == tq.shape
    _close(got, want, 1e-5)


def test_attention_bf16_matches_jax():
    (jq, tq), (jk, tk), (jv, tv) = _bshd(3, 2, 40, 40, 4, 2, 32, jnp.bfloat16)
    want = jattn.attention(jq, jk, jv, causal=True, window=8, kv_chunk=16)
    got = tattn.attention(tq, tk, tv, causal=True, window=8, kv_chunk=16)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-2)


# -- rmsnorm and rope ---------------------------------------------------------------------


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.normal(size=(2, 5, 64)) * 3.0, jnp.float32)
    js, ts = _pair(1.0 + 0.1 * rng.normal(size=(64,)), jnp.float32)
    _close(tlayers.rmsnorm(tx, ts, 1e-6), jlayers.rmsnorm(jx, js, 1e-6), 1e-6)


@pytest.mark.parametrize("rotary_pct", [1.0, 0.25])
@pytest.mark.parametrize("batched_positions", [False, True])
def test_apply_rope_matches_jax(rotary_pct, batched_positions):
    """Interleaved pairs (x[2i], x[2i+1]), not the rotate-half convention;
    with rotary_pct 0.25 only the first quarter of the channels turns."""
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.normal(size=(2, 9, 3, 64)), jnp.float32)
    pos = rng.integers(0, 300, size=(2, 9) if batched_positions else (9,))
    want = jlayers.apply_rope(jx, jnp.asarray(pos), 1e6, rotary_pct)
    got = tlayers.apply_rope(tx, torch.from_numpy(pos), 1e6, rotary_pct)
    _close(got, want, 1e-5)
    rot = int(64 * rotary_pct)
    assert torch.equal(got[..., rot:], tx[..., rot:])
    # rotate-half would pair channel i with i + rot/2; interleaved pairs 2i, 2i+1
    norm = (got[..., :rot].reshape(2, 9, 3, rot // 2, 2) ** 2).sum(-1)
    _close(norm, (tx[..., :rot].reshape(2, 9, 3, rot // 2, 2) ** 2).sum(-1), 1e-5)
