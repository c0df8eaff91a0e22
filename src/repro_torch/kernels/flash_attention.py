"""K7 — flash attention (online softmax, GQA, causal and sliding-window
masks) on Hopper.

`flash_attention` launches `csrc/flash_attention.cu` for CUDA tensors and
runs `flash_attention_plain` for CPU tensors. Both compute the Pallas
body's function (`repro/kernels/flash_attention.py:_flash_kernel`) with its
rounding points: `q * scale` in the input type, scores and accumulation in
float32, `p` cast to v's type before `p @ v`, the finite mask value -1e30,
and `acc / max(l, 1e-30)` cast to q's type. Rows ≥ Lq and columns ≥ Lk are
masked, so any length works. (The Pallas kernel clamps its last K/V and Q
slices instead, which gives wrong rows when a length above its 128 block is
not a multiple of it; the port follows `kref.ref_attention` there.)

Layout: q (B, H, Lq, D), k and v (B, Hkv, Lk, D) with H % Hkv == 0; head h
reads kv head h // (H / Hkv). The kernel takes any strides with a
contiguous last axis, so `models.attention` hands it (B, S, H, D) tensors
as transposed views, and the output has q's layout.

bfloat16 runs on the tensor cores (wgmma, fed by TMA), float32 on them too
as three TF32 products a float32 product (`mma.sync`; csrc/tf32x3.cuh says
why that keeps the float32 contract). The host decides what each kernel
is given, in plain functions the CPU tests reach: `fwd_route` (by type
and head dim, the route — `wgmma` for bf16, `tf32x3` for float32 — with
the head dim its kernel is built for and its q-block and kv-tile rows:
`padded_head_dim` and `tc_blocks` for bf16, `f32_blocks` for float32),
`tf32x3_smem` (the float32 kernels' shared memory, the backward's too),
`kv_tile_plan` (the kv tiles each q block visits, the ones among them
that need no mask, and the launch order) and `check_tma_layout` (the
16-byte alignment TMA needs; nothing is copied to meet it).

Gradients. When grad is on and an input requires it, `flash_attention`
launches K7 inside `FlashAttentionFn`: the forward is the kernel, which
also writes each row's log-sum-exp (`lse`, float32), and the backward is
`flash_attention_backward`, a kernel of its own
(`csrc/flash_attention_bwd.cu`: FlashAttention-2's two passes, dK/dV and
dQ, recomputing p = exp(s - lse); its rounding points are in
`flash_attention_backward_plain`'s docstring). The reference has no
backward kernel: the JAX package trains through its plain
`models.attention.attention` and XLA derives the gradient; the port trains
through K7's forward, so its gradient is this kernel's on the card. The
backward's host side is plain code the CPU tests reach: `bwd_route` (by
type and head dim, the route — `wgmma` for bf16, where q, k, v and dout
must pass `check_tma_layout`, `tf32x3` for float32 — its padded head dim
and each pass's q and kv block rows), `kv_tile_plan` at the
dQ pass's blocks and `q_tile_plan` (the q blocks that see each kv tile)
at the dK/dV pass's. Under `torch.utils.checkpoint` (non-reentrant,
`models.layers.remat`) the recomputed forward saves its own lse. With no
input that requires grad, the wrapper launches the forward directly, as
serving does, and writes no lse. (CPU tensors never reach the Function:
the wrapper runs the plain version, and autograd differentiates it.)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_NEG_INF = -1e30
MAX_HEAD_DIM = 320
BLOCK_K = 128          # the Pallas kernel's kv block, which the plain version keeps
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 kernel's padded head dims → (q block rows, kv tile rows): two
# consumer warpgroups of 64 rows where registers and shared memory allow
_TC_BLOCKS = {64: (128, 128), 128: (128, 128), 192: (128, 64), 256: (64, 64),
              320: (64, 64)}
TMA_ALIGN = 16           # bytes: base addresses and strides of TMA's tensors
# the backward's head-dim buckets (and the float32 forward's)
_BWD_BUCKETS = (64, 128, 256, 320)
# the wgmma route (bf16) by bucket: the dQ pass's and the dK/dV pass's (q
# block rows, kv tile rows), which the tile plans take
# (csrc/flash_attention_bwd.cu: Blocks); the rows of Lq's padding
_BWD_WGMMA = {64: ((128, 64), (64, 128)), 128: ((128, 64), (64, 128)),
              256: ((128, 32), (32, 64)), 320: ((128, 16), (32, 64))}
LQ_PAD = 128
# float32 (three TF32 products, csrc/tf32x3.cuh) by head-dim bucket: the
# forward's (q block rows, kv tile rows); the backward's dQ pass's and dK/dV
# pass's (q block rows, kv tile rows)
_F32_FWD = {64: (128, 64), 128: (128, 64), 256: (128, 24), 320: (128, 16)}
_BWD_TF32X3 = {64: ((128, 64), (32, 128)), 128: ((128, 32), (16, 128)),
               256: ((64, 16), (8, 64)), 320: ((64, 16), (8, 64))}
SMEM_LIMIT = 232_448     # bytes of shared memory a block can take on the H100
_BWD_ROUTE_CODE = {"wgmma": 1, "tf32x3": 2}


def padded_head_dim(d: int) -> int:
    """The head dim the bf16 kernel is built for that holds `d`: the
    next of 64, 128, 192, 256, 320. TMA fills the padding with zeros."""
    for d_pad in sorted(_TC_BLOCKS):
        if d <= d_pad:
            return d_pad
    raise ValueError(f"flash_attention: head dim {d} > {MAX_HEAD_DIM}")


def tc_blocks(d: int) -> tuple:
    """(q block rows, kv tile rows) of the bf16 kernel at head dim `d`."""
    return _TC_BLOCKS[padded_head_dim(d)]


def _bucket(d: int) -> int:
    bucket = next((b for b in _BWD_BUCKETS if d <= b), None)
    if bucket is None:
        raise ValueError(f"flash_attention: head dim {d} > {MAX_HEAD_DIM}")
    return bucket


def f32_blocks(d: int) -> tuple:
    """(head-dim bucket, (q block rows, kv tile rows)) of the float32
    forward kernel at head dim `d` (csrc/flash_attention.cu instantiates
    the same)."""
    bucket = _bucket(d)
    return bucket, _F32_FWD[bucket]


class FwdRoute(NamedTuple):
    """How the forward kernel runs at a (head dim, type): `route` "wgmma"
    (bf16: TMA, wgmma) or "tf32x3" (float32: three TF32 `mma.sync`
    products a float32 product); the head dim `d_pad` its kernel is built
    for (bf16's padded head dim, float32's bucket); (q block rows, kv tile
    rows)."""
    route: str
    d_pad: int
    blocks: tuple


def fwd_route(d: int, dtype: torch.dtype) -> FwdRoute:
    """The forward kernel's route, head dim and blocks at head dim `d` in
    `dtype` (csrc/flash_attention.cu dispatches the same)."""
    if dtype == torch.bfloat16:
        return FwdRoute("wgmma", padded_head_dim(d), tc_blocks(d))
    return FwdRoute("tf32x3", *f32_blocks(d))


def tf32x3_smem(bucket: int) -> dict:
    """Shared memory (bytes) a block of each float32 kernel takes at a
    head-dim bucket, as the kernels lay it out: tiles of rows of (bucket +
    4) float32 words. fwd: the scaled Q block, a kv tile's landing tile
    and its hi and lo tiles; dkv: K and V, q's and dO's landing tiles, qs
    and dO hi and lo, the step's lse and Δ, and above bucket 128 (two warps
    a 16 kv rows) each pair's p; dq: qs and dO, a kv tile's landing, hi and
    lo tiles, the block's lse and Δ."""
    ld = 4 * (bucket + 4)
    bq, bk = _F32_FWD[bucket]
    (dq_bq, dq_bk), (kv_bq, kv_bk) = _BWD_TF32X3[bucket]
    return {"fwd": (bq + 3 * bk) * ld,
            "dkv": (2 * kv_bk + 6 * kv_bq) * ld + 2 * kv_bq * 4
            + (kv_bk * kv_bq * 4 if bucket > 128 else 0),
            "dq": (2 * dq_bq + 3 * dq_bk) * ld + 2 * dq_bq * 4}


def kv_tile_plan(lq: int, lk: int, block_q: int, block_k: int, causal: bool,
                 window: int) -> np.ndarray:
    """One int32 row per q block, in launch order: (q block, first kv tile,
    end kv tile, first tile without a mask, end tile without a mask).

    A q block visits the tiles [first, end) that hold a column visible to
    one of its rows < lq; a tile in [first unmasked, end unmasked) is
    visible to every such row at every column, so the kernel skips the
    mask there. Blocks go longest first (stable), so the causal blocks
    with the most tiles start first."""
    n_qb, n_kb = -(-lq // block_q), -(-lk // block_k)
    rows = []
    for qb in range(n_qb):
        r0, r1 = qb * block_q, min((qb + 1) * block_q, lq) - 1
        # the columns visible to some row r0 .. r1: one interval
        lo = max(0, r0 - window + 1) if window > 0 else 0
        hi = min(lk - 1, r1) if causal else lk - 1
        if lo > hi:
            rows.append((qb, 0, 0, 0, 0))
            continue
        first, end = lo // block_k, hi // block_k + 1
        # every column of the tile is < lk and visible to rows r0 .. r1
        full_end = min(end, lk // block_k, (r0 + 1) // block_k if causal else n_kb)
        full_first = first
        if window > 0:
            full_first = max(first, -(-max(0, r1 - window + 1) // block_k))
        rows.append((qb, first, end, full_first, max(full_end, full_first)))
    rows.sort(key=lambda r: r[1] - r[2])         # longest first; sort is stable
    return np.asarray(rows, dtype=np.int32).reshape(n_qb, 5)


def q_tile_plan(lq: int, lk: int, block_q: int, block_k: int, causal: bool,
                window: int) -> np.ndarray:
    """`kv_tile_plan` seen from the kv side, for the backward's dK/dV pass:
    one int32 row per kv tile, in launch order: (kv tile, first q block,
    end q block, first block without a mask, end block without a mask).

    A kv tile is visited by the q blocks [first, end) that hold a row < lq
    that sees one of its columns < lk; a block in [first unmasked, end
    unmasked) has every row < lq and sees every column of the tile, all
    < lk. Tiles go longest first (stable)."""
    n_qb, n_kb = -(-lq // block_q), -(-lk // block_k)
    rows = []
    for kb in range(n_kb):
        c0, c1 = kb * block_k, min((kb + 1) * block_k, lk) - 1
        # the rows that see some column c0 .. c1: one interval
        lo = c0 if causal else 0
        hi = min(lq - 1, c1 + window - 1) if window > 0 else lq - 1
        if lo > hi:
            rows.append((kb, 0, 0, 0, 0))
            continue
        first, end = lo // block_q, hi // block_q + 1
        full_first = max(first, -(-c1 // block_q) if causal else first)
        full_end = min(end, lq // block_q)
        if window > 0:
            full_end = min(full_end, (c0 + window) // block_q)
        if (kb + 1) * block_k > lk:          # columns past lk: every block masks
            full_end = full_first
        rows.append((kb, first, end, full_first, max(full_end, full_first)))
    rows.sort(key=lambda r: r[1] - r[2])         # longest first; sort is stable
    return np.asarray(rows, dtype=np.int32).reshape(n_kb, 5)


class BwdRoute(NamedTuple):
    """How the backward kernel runs at a (head dim, type): `route` "wgmma"
    (bf16 at every bucket: TMA into a ring of stages, wgmma) or "tf32x3"
    (float32 at every bucket: three TF32 `mma.sync` products a float32
    product); the head-dim bucket `d_pad` it is built for; (q block rows,
    kv tile rows) of the dQ pass and of the dK/dV pass."""
    route: str
    d_pad: int
    dq_blocks: tuple
    dkv_blocks: tuple


def bwd_route(d: int, dtype: torch.dtype) -> BwdRoute:
    """The backward kernel's route, padded head dim and blocks at head dim
    `d` in `dtype` (csrc/flash_attention_bwd.cu instantiates the same)."""
    bucket = _bucket(d)
    if dtype == torch.float32:
        return BwdRoute("tf32x3", bucket, *_BWD_TF32X3[bucket])
    return BwdRoute("wgmma", bucket, *_BWD_WGMMA[bucket])


@functools.lru_cache(maxsize=64)
def _device_plan(lq, lk, block_q, block_k, causal, window, device, by_kv=False) -> torch.Tensor:
    plan = (q_tile_plan if by_kv else kv_tile_plan)(lq, lk, block_q, block_k, causal, window)
    return torch.from_numpy(plan).to(device)


def _misaligned(t: torch.Tensor) -> list:
    """What keeps `t` (B, H, L, D) from being read 16 bytes at a time as it
    lies: its base address and (batch, head, row) strides, where not a
    multiple of 16 bytes."""
    es = t.element_size()
    bad = [f"base address {t.data_ptr()}"] if t.data_ptr() % TMA_ALIGN else []
    return bad + [f"{axis} stride {st * es} B" for axis, st in zip(("batch", "head", "row"),
                                                                   t.stride()[:3])
                  if (st * es) % TMA_ALIGN]


def check_tma_layout(name: str, t: torch.Tensor) -> None:
    """Raise unless TMA can read `t` (B, H, L, D) as it lies: a 16-byte
    aligned base and (batch, head, row) strides that are multiples of 16
    bytes. Nothing is copied to meet this."""
    bad = _misaligned(t)
    if bad:
        raise ValueError(f"flash_attention: the bf16 kernel reads {name} by TMA, which "
                         f"needs {TMA_ALIGN}-byte alignment: {', '.join(bad)}")


def _scale(d: int, dtype: torch.dtype) -> torch.Tensor:
    """1/sqrt(D) as the Pallas body multiplies by it: a Python float, hence
    weakly typed, so it is rounded to q's type first."""
    return torch.tensor(1.0 / (d ** 0.5), dtype=dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0, return_lse: bool = False):
    """The Pallas body in torch ops, in its op order: kv blocks of
    min(128, Lk) columns (zero-padded past Lk), a running float32 (m, l,
    acc) per row. With `return_lse`, also each row's log-sum-exp (B, H,
    Lq) as the kernel writes it for the backward: m + log l, and +inf for
    a row with no visible column (its m stays -1e30)."""
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = h // hkv
    bk = min(BLOCK_K, lk)
    qf = (q * _scale(d, q.dtype).to(q.device)).float().reshape(b, hkv, g, lq, d)
    nk = -(-lk // bk)
    pad = nk * bk - lk
    kp = F.pad(k, (0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, pad))
    row = torch.arange(lq, device=q.device)[:, None]
    m = torch.full((b, hkv, g, lq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l_ = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, lq, d), dtype=torch.float32, device=q.device)
    for kb in range(nk):
        kc = kp[:, :, None, kb * bk:(kb + 1) * bk].float()
        vc = vp[:, :, None, kb * bk:(kb + 1) * bk]
        s = qf @ kc.transpose(-1, -2)                        # (b, hkv, g, lq, bk)
        col = kb * bk + torch.arange(bk, device=q.device)[None, :]
        mask = col < lk
        if causal:
            mask = mask & (col <= row)
        if window > 0:
            mask = mask & (col > row - window)
        s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_ = alpha * l_ + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vc.float()
        m = m_new
    out = (acc / l_.clamp_min(1e-30)).to(q.dtype).reshape(b, h, lq, d)
    if not return_lse:
        return out
    lse = torch.where(m == _NEG_INF, torch.inf, m + torch.log(l_))
    return out, lse.reshape(b, h, lq)


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                                   causal: bool = True, window: int = 0) -> tuple:
    """dq, dk, dv of K7 from its output `out` and row log-sum-exp `lse`
    (`flash_attention_plain(..., return_lse=True)`), given the output's
    gradient `dout`: the backward kernel's recurrence in torch ops, over kv
    blocks of min(128, Lk) columns, with its rounding points (T is q's
    type; every sum float32):
      qs = q * scale in T (the forward's), s = qs kᵀ, dp = dout vᵀ;
      p = exp(s - lse) on the visible columns, else 0 (lse = +inf: 0);
      Δ = rowsum(dout ∘ out);
      dv = Σ (p rounded to v's type)ᵀ dout;
      ds = p ∘ (dp - Δ), rounded to T;
      dk = Σ dsᵀ qs (taken against the scaled q);
      dq = scale · Σ ds k, scale the forward's (rounded to T);
    each rounded to its input's type once. Outputs keep the inputs'
    layouts."""
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = h // hkv
    sc = _scale(d, q.dtype).to(q.device)
    qs = (q * sc).float().reshape(b, hkv, g, lq, d)
    do = dout.float().reshape(b, hkv, g, lq, d)
    delta = (do * out.float().reshape(b, hkv, g, lq, d)).sum(-1, keepdim=True)
    lse_ = lse.float().reshape(b, hkv, g, lq, 1)
    row = torch.arange(lq, device=q.device)[:, None]
    dq = torch.zeros_like(qs)
    dks, dvs = [], []
    bk = min(BLOCK_K, lk)
    for c0 in range(0, lk, bk):
        kc = k[:, :, None, c0:c0 + bk].float()
        vc = v[:, :, None, c0:c0 + bk].float()
        col = c0 + torch.arange(kc.shape[-2], device=q.device)[None, :]
        mask = torch.ones((lq, kc.shape[-2]), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (col <= row)
        if window > 0:
            mask = mask & (col > row - window)
        s = qs @ kc.transpose(-1, -2)                        # (b, hkv, g, lq, bk)
        p = torch.where(mask, torch.exp(s - lse_), 0.0)
        dvs.append((p.to(v.dtype).float().transpose(-1, -2) @ do).sum(2))
        dp = do @ vc.transpose(-1, -2)
        ds = (p * (dp - delta)).to(q.dtype).float()
        dq = dq + ds @ kc
        dks.append((ds.transpose(-1, -2) @ qs).sum(2))
    dq = (dq * sc.float()).to(q.dtype).reshape(b, h, lq, d)
    dk, dv = torch.cat(dks, 2).to(k.dtype), torch.cat(dvs, 2).to(v.dtype)
    return tuple(torch.empty_like(t).copy_(x) for t, x in ((q, dq), (k, dk), (v, dv)))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    dev = q.device
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, L, D)")
    b, h, _lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, hkv, lk, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"must be (B, Hkv, Lk, D) for q {tuple(q.shape)}")
    if h % hkv != 0:
        raise ValueError(f"flash_attention: {h} heads are not a multiple of {hkv} kv heads")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {dev}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE:
            raise ValueError(f"flash_attention: the kernel takes float32 or bfloat16 "
                             f"q, k, v of one type; got {q.dtype}/{k.dtype}/{v.dtype}")
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"flash_attention: {name} needs a contiguous head-dim axis")
    if d % 16 != 0 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the kernel takes head dims that are "
                         f"multiples of 16 up to {MAX_HEAD_DIM}, got {d}")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError("flash_attention: empty input")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, lse: torch.Tensor = None) -> torch.Tensor:
    """One launch of K7 on CUDA tensors (checked here); counts it. With
    `lse` (B, H, Lq, float32, contiguous) the kernel also writes each
    row's log-sum-exp into it."""
    _check(q, k, v)
    dev = q.device
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rt = fwd_route(d, q.dtype)
    if rt.route == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma_layout(name, t)
    d_pad, (block_q, block_k) = rt.d_pad, rt.blocks
    plan = _device_plan(lq, lk, block_q, block_k, bool(causal), int(window), dev)
    if lse is not None and (lse.shape != (b, h, lq) or lse.dtype != torch.float32
                            or lse.device != dev or not lse.is_contiguous()):
        raise ValueError("flash_attention: lse must be a contiguous float32 (B, H, Lq) "
                         "tensor on q's device")
    st = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = _build.library()
    p = _build.ptr
    err = lib.nebula_flash_attention(
        p(q), p(k), p(v), p(out), None if lse is None else p(lse), _DTYPE_CODE[q.dtype],
        b, h, hkv, lq, lk, d, *st,
        int(bool(causal)), int(window), float(_scale(d, q.dtype)), p(plan), plan.shape[0],
        d_pad, block_q, block_k, _build.stream_handle(dev))
    _build.check(err, "nebula_flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: int = 0, need_dq: bool = True,
                             need_dkv: bool = True) -> tuple:
    """(dq, dk, dv) of K7 at (q, k, v) from its output, its row
    log-sum-exp and the output's gradient: q's type and layout for dq, k's
    and v's for dk and dv (None for what is not needed). CPU tensors run
    `flash_attention_backward_plain`; CUDA tensors launch the backward
    kernel or raise."""
    dev = q.device
    if dev.type == "cpu":
        dq, dk, dv = flash_attention_backward_plain(q, k, v, out, lse, dout, causal=causal,
                                                    window=window)
        return dq if need_dq else None, dk if need_dkv else None, dv if need_dkv else None
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    _check(q, k, v)
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"flash_attention: {name} must have q's shape, type and device")
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"flash_attention: {name} needs a contiguous head-dim axis")
    if (lse.shape != (b, h, lq) or lse.dtype != torch.float32 or lse.device != dev
            or not lse.is_contiguous()):
        raise ValueError("flash_attention: lse must be a contiguous float32 (B, H, Lq) "
                         "tensor on q's device")
    rt = bwd_route(d, q.dtype)
    wgmma = rt.route == "wgmma"
    if wgmma:     # TMA reads them as they lie: misaligned raises, nothing is copied
        for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
            check_tma_layout(name, t)
    dq = torch.empty_like(q) if need_dq else None
    dk = torch.empty_like(k) if need_dkv else None
    dv = torch.empty_like(v) if need_dkv else None
    # wgmma: Δ and lse over Lq padded to LQ_PAD rows (+inf and 0 past Lq), qs
    lq_pad = -(-lq // LQ_PAD) * LQ_PAD if wgmma else lq
    delta = torch.empty((b, h, lq_pad), dtype=torch.float32, device=dev)
    lse_pad = torch.empty_like(delta) if wgmma else None
    q_scaled = torch.empty((b, h, lq, d), dtype=q.dtype, device=dev) if wgmma else None
    parts = [None, None]
    if need_dkv and h > hkv:
        parts = [torch.empty((b, h, lk, d), dtype=torch.float32, device=dev) for _ in range(2)]
    mask = (bool(causal), int(window), dev)
    dq_plan = _device_plan(lq, lk, *rt.dq_blocks, *mask) if need_dq else None
    dkv_plan = _device_plan(lq, lk, *rt.dkv_blocks, *mask, by_kv=True) if need_dkv else None
    # the tensors the kernels may read 16 bytes at a time (else element by element)
    vec = sum(bit for bit, t in ((1, q), (2, k), (4, v), (8, dout), (16, out))
              if not _misaligned(t))
    st = [s for t in (q, k, v, out, dout, dq if need_dq else q, dk if need_dkv else k,
                      dv if need_dkv else v) for s in t.stride()[:3]]
    p = _build.ptr
    opt = (lambda t: None if t is None else p(t))
    err = _build.library().nebula_flash_attention_backward(
        p(q), p(k), p(v), p(out), p(lse), p(dout), opt(dq), opt(dk), opt(dv), p(delta),
        opt(parts[0]), opt(parts[1]), opt(q_scaled), opt(lse_pad), _DTYPE_CODE[q.dtype],
        b, h, hkv, lq, lk, d, *st, int(bool(causal)), int(window), float(_scale(d, q.dtype)),
        opt(dq_plan), 0 if dq_plan is None else dq_plan.shape[0], opt(dkv_plan),
        0 if dkv_plan is None else dkv_plan.shape[0], _BWD_ROUTE_CODE[rt.route], rt.d_pad,
        *rt.dq_blocks,
        *rt.dkv_blocks, lq_pad, vec, _build.stream_handle(dev))
    _build.check(err, "nebula_flash_attention_backward")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """K7 forward (saving q, k, v, the output and its row log-sum-exp), the
    backward kernel backward (`flash_attention_backward`). Takes the
    strided (B, H, L, D) views that `models.attention` hands K7. Given CPU
    tensors (a test with the plain version as `_launch`), it saves q, k and
    v and differentiates `flash_attention_plain` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.causal, ctx.window = causal, window
        if q.device.type != "cuda":
            ctx.save_for_backward(q, k, v)
            return _launch(q, k, v, causal, window)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out = _launch(q, k, v, causal, window, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        if len(saved) == 5:
            if grad_out.stride(-1) != 1:
                grad_out = grad_out.contiguous()
            dq, dk, dv = flash_attention_backward(
                *saved, grad_out, causal=ctx.causal, window=ctx.window, need_dq=needs[0],
                need_dkv=needs[1] or needs[2])
            return dq, dk if needs[1] else None, dv if needs[2] else None, None, None
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
            out = flash_attention_plain(*ins, causal=ctx.causal, window=ctx.window)
            wrt = [t for t, n in zip(ins, needs) if n]
            got = iter(torch.autograd.grad(out, wrt, grad_out))
        return (*(next(got) if n else None for n in needs), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, H, Lq, D), k/v (B, Hkv, Lk, D) → (B, H, Lq, D) in q's type
    and layout. CPU tensors run the plain version; CUDA tensors launch K7
    or raise, inside `FlashAttentionFn` when grad is on and an input
    requires it."""
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, bool(causal), int(window))
    return _launch(q, k, v, causal, window)


flash_attention.launches = 0
