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

bfloat16 runs on the tensor cores (wgmma, fed by TMA), float32 on the FMA
units (csrc/flash_attention.cu says why). The host decides what the
bf16 kernel is given, in plain functions the CPU tests reach:
`padded_head_dim` and `tc_blocks` (the head dim the kernel is built for
and its q-block and kv-tile rows), `kv_tile_plan` (the kv tiles each q
block visits, the ones among them that need no mask, and the launch
order) and `check_tma_layout` (the 16-byte alignment TMA needs; nothing is
copied to meet it).

Gradients. When grad is on and an input requires it, `flash_attention`
launches K7 inside a `torch.autograd.Function`: the forward is the kernel,
the backward re-runs `flash_attention_plain` (the kernel's own function,
with its rounding points) on the saved q, k and v and differentiates it.
There is no backward kernel because the reference has none: the JAX
package trains through its plain `models.attention.attention`, and no
function under `repro/kernels/` carries a `custom_vjp`, so its backward is
what XLA derives from plain array code. With no input that requires grad,
the wrapper launches the kernel directly, as serving does.
"""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=64)
def _device_plan(lq, lk, block_q, block_k, causal, window, device) -> torch.Tensor:
    plan = kv_tile_plan(lq, lk, block_q, block_k, causal, window)
    return torch.from_numpy(plan).to(device)


def check_tma_layout(name: str, t: torch.Tensor) -> None:
    """Raise unless TMA can read `t` (B, H, L, D) as it lies: a 16-byte
    aligned base and (batch, head, row) strides that are multiples of 16
    bytes. Nothing is copied to meet this."""
    es = t.element_size()
    bad = [f"base address {t.data_ptr()}"] if t.data_ptr() % TMA_ALIGN else []
    bad += [f"{axis} stride {st * es} B" for axis, st in zip(("batch", "head", "row"),
                                                             t.stride()[:3])
            if (st * es) % TMA_ALIGN]
    if bad:
        raise ValueError(f"flash_attention: the bf16 kernel reads {name} by TMA, which "
                         f"needs {TMA_ALIGN}-byte alignment: {', '.join(bad)}")


def _scale(d: int, dtype: torch.dtype) -> torch.Tensor:
    """1/sqrt(D) as the Pallas body multiplies by it: a Python float, hence
    weakly typed, so it is rounded to q's type first."""
    return torch.tensor(1.0 / (d ** 0.5), dtype=dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """The Pallas body in torch ops, in its op order: kv blocks of
    min(128, Lk) columns (zero-padded past Lk), a running float32 (m, l,
    acc) per row."""
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
    return (acc / l_.clamp_min(1e-30)).to(q.dtype).reshape(b, h, lq, d)


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
            window: int) -> torch.Tensor:
    """One launch of K7 on CUDA tensors (checked here); counts it."""
    _check(q, k, v)
    dev = q.device
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    plan_ptr, n_plan, d_pad, block_q, block_k = None, 0, 0, 0, 0
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma_layout(name, t)
        d_pad = padded_head_dim(d)
        block_q, block_k = tc_blocks(d)
        plan = _device_plan(lq, lk, block_q, block_k, bool(causal), int(window), dev)
        plan_ptr, n_plan = plan.data_ptr(), plan.shape[0]
    st = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = _build.library()
    p = _build.ptr
    err = lib.nebula_flash_attention(
        p(q), p(k), p(v), p(out), _DTYPE_CODE[q.dtype], b, h, hkv, lq, lk, d, *st,
        int(bool(causal)), int(window), float(_scale(d, q.dtype)), plan_ptr, n_plan,
        d_pad, block_q, block_k, _build.stream_handle(dev))
    _build.check(err, "nebula_flash_attention")
    flash_attention.launches += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """K7 forward, `flash_attention_plain`'s gradient backward (the module
    docstring says why there is no backward kernel). Takes the strided
    (B, H, L, D) views that `models.attention` hands K7."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
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
