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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_NEG_INF = -1e30
MAX_HEAD_DIM = 320
BLOCK_K = 128          # the Pallas kernel's kv block, which the plain version keeps
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, H, Lq, D), k/v (B, Hkv, Lk, D) → (B, H, Lq, D) in q's type
    and layout. CPU tensors run the plain version; CUDA tensors launch K7
    or raise."""
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    _check(q, k, v)
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    st = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = _build.library()
    p = _build.ptr
    err = lib.nebula_flash_attention(
        p(q), p(k), p(v), p(out), _DTYPE_CODE[q.dtype], b, h, hkv, lq, lk, d, *st,
        int(bool(causal)), int(window), float(_scale(d, q.dtype)),
        _build.stream_handle(dev))
    _build.check(err, "nebula_flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
