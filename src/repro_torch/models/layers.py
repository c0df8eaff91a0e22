"""Shared layer primitives of the LM family: RMSNorm, RoPE, SwiGLU, the QKV
projection, the initializers, and the attention and MLP parameter sets as
`nn.Module`s, the training loss `chunked_ce`, and the logical axes of the
parameters (the JAX package's `models/layers.py`).

Weights keep the JAX layout, (in, out), so a projection is `x @ w` and a
JAX parameter tree converts without a transpose (`convert.params_from_jax`).
Random weights come from an explicit `torch.Generator` with the JAX
package's std rules; the numbers differ from `jax.random`'s for the same
seed, so the parity tests convert the JAX tree instead. On the meta device
(`model_zoo.ModelBundle.abstract_params`) a module is built without memory.

Logical axes: each module class names its own parameters' axes in `AXES`
(the axes half of the JAX `init`), and `param_axes(module)` gathers them by
parameter name. The port's layers are per-layer modules, so no axes carry
JAX's leading "layer"; `convert.axes_as_jax` adds it where JAX stacks.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.context import (gather_dim, gather_seq, over_batch_heads,
                                          seq_whole_grad, split_ranks)

BSHD = ("batch", None, "heads", None)     # a (B, S, H, Dh) tensor's dims, for `over_batch_heads`


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def generator(seed: int, device: torch.device) -> torch.Generator:
    """The init's generator: on `device`, or on the CPU for the meta device
    (which has none, and draws nothing)."""
    dev = torch.device(device)
    return torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(seed)


def param_axes(module: nn.Module) -> Dict[str, Tuple[Optional[str], ...]]:
    """Every parameter's logical axes by its `named_parameters` name, from
    the `AXES` table of the module class that holds it."""
    out = {}
    for prefix, mod in module.named_modules():
        for name in mod._parameters:
            if mod._parameters[name] is not None:
                out[f"{prefix}.{name}" if prefix else name] = type(mod).AXES[name]
    return out


# -- init helpers -------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype, device,
               in_axis: int = -2) -> torch.Tensor:
    """N(0, 1/fan_in) in float32, cast to `dtype`; fan_in = shape[in_axis]."""
    std = 1.0 / np.sqrt(shape[in_axis])
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype: torch.dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            * 0.02).to(dtype)


def param(t: torch.Tensor) -> nn.Parameter:
    """A trainable parameter. Serving builds no graph all the same: every
    family's `prefill` and `decode_step` runs under `torch.no_grad()`."""
    return nn.Parameter(t)


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """`F.embedding(tokens, table)`. A table split over its vocabulary (a
    DTensor) is gathered along it first: DTensor's lookup into vocabulary
    shards leaves a pending masked sum whose gradient it cannot take back."""
    return F.embedding(tokens, gather_dim(table, 0))


# -- norms ---------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# -- rope ----------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, rotary_pct: float = 1.0,
               device=None) -> Tuple[torch.Tensor, int]:
    rot_dim = int(head_dim * rotary_pct) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    inv = 1.0 / torch.pow(theta, exps)
    return inv, rot_dim


@over_batch_heads((BSHD, None, None, None), BSHD)
def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (S,) or (B, S). Rotates interleaved
    pairs (x[2i], x[2i+1]) of the first `rot_dim` channels, as the JAX
    package does (not the rotate-half convention). On a DTensor, once a
    shard (its batch rows and heads; positions are plain)."""
    hd = x.shape[-1]
    inv, rot_dim = rope_freqs(hd, theta, rotary_pct, device=x.device)
    if rot_dim == 0:
        return x
    ang = positions.float()[..., None] * inv      # (S, rd/2) or (B, S, rd/2)
    if ang.ndim == 2:
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot_dim].float()
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape[:-1] + (rot_dim,))
    return torch.cat([out.to(x.dtype), x[..., rot_dim:]], dim=-1)


# -- mlp -----------------------------------------------------------------------


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    x = gather_seq(x)
    g = x @ w_gate
    u = x @ w_up
    return seq_whole_grad((F.silu(g) * u) @ w_down)


class MLP(nn.Module):
    """SwiGLU weights: w_gate, w_up (d, f) and w_down (f, d)."""

    AXES = {"w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"), "w_down": ("ffn", "embed")}

    def __init__(self, d: int, f: int, dtype: torch.dtype, device,
                 gen: torch.Generator):
        super().__init__()
        self.w_gate = param(dense_init(gen, (d, f), dtype, device))
        self.w_up = param(dense_init(gen, (d, f), dtype, device))
        self.w_down = param(dense_init(gen, (f, d), dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, self.w_gate, self.w_up, self.w_down)


# -- attention projections -------------------------------------------------------


class Attention(nn.Module):
    """The attention projections: wq (d, H·Dh), wk and wv (d, Hkv·Dh), wo
    (H·Dh, d), and with `cfg.qkv_bias` the biases bq, bk, bv (zeros at
    init, as in the JAX package). Cross-attention (`cross=True`, the
    enc-dec decoder's) has no biases."""

    AXES = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
            "bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",)}

    def __init__(self, cfg, dtype: torch.dtype, device, gen: torch.Generator,
                 cross: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        h, hkv = cfg.n_heads, cfg.n_kv_heads
        self.wq = param(dense_init(gen, (d, h * hd), dtype, device))
        self.wk = param(dense_init(gen, (d, hkv * hd), dtype, device))
        self.wv = param(dense_init(gen, (d, hkv * hd), dtype, device))
        self.wo = param(dense_init(gen, (h * hd, d), dtype, device))
        self.bq: Optional[nn.Parameter] = None
        self.bk: Optional[nn.Parameter] = None
        self.bv: Optional[nn.Parameter] = None
        if cfg.qkv_bias and not cross:
            self.bq = param(torch.zeros((h * hd,), dtype=dtype, device=device))
            self.bk = param(torch.zeros((hkv * hd,), dtype=dtype, device=device))
            self.bv = param(torch.zeros((hkv * hd,), dtype=dtype, device=device))


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(..., n·hd) → (..., n, hd). A DTensor whose last dim is split over
    more ranks than `n` divides is gathered along it first (XLA does the
    same for a fused heads dim it cannot split by head)."""
    if n % split_ranks(t, -1):
        t = gather_dim(t, t.ndim - 1)
    return t.reshape(*t.shape[:-1], n, hd)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., n, hd) → (..., n·hd). On a DTensor a split head dim is
    gathered first (decode against a cache split over it: DTensor cannot
    merge a split inner dim into the heads), and where the heads are not
    split, the merged tensor's gradient is gathered over the fused dim
    before the backward splits it by head again (a redistribute to its own
    placements), since a head count that does not divide the ranks cannot
    take a split fused dim."""
    t = gather_dim(t, t.ndim - 1)
    out = t.reshape(*t.shape[:-2], -1)
    placements = getattr(t, "placements", None)
    if placements is not None and not any(p.is_shard(t.ndim - 2) for p in placements):
        out = out.redistribute(out.device_mesh, out.placements)
    return out


def qkv(x: torch.Tensor, p: Attention, cfg) -> Tuple[torch.Tensor, torch.Tensor,
                                                   torch.Tensor]:
    """(B, S, d) → q (B, S, H, Dh), k and v (B, S, Hkv, Dh)."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = gather_seq(x)
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if p.bq is not None:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    return split_heads(q, h, hd), split_heads(k, hkv, hd), split_heads(v, hkv, hd)


# -- remat and loss -------------------------------------------------------------


def remat(fn, cfg, *args):
    """`fn(*args)`, recomputed in the backward when `cfg.remat` is set and
    grad is on: the JAX package's `jax.checkpoint(..., nothing_saveable)`
    around each scanned unit. Each family calls it once a unit, on JAX's
    units, so the outputs and the saved boundaries are JAX's."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim. On logits split over the vocabulary
    across ranks as a row max and a sum of exponentials, each reduced
    across ranks, as XLA lowers it, not by gathering the rows."""
    if split_ranks(logits, -1) > 1:
        m = logits.amax(dim=-1, keepdim=True).detach()
        return (torch.log(torch.exp(logits - m).sum(-1, keepdim=True)) + m)[..., 0]
    return torch.logsumexp(gather_dim(logits, logits.ndim - 1), dim=-1)


def _take_target(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits[..., targets]. On logits split over the vocabulary across
    ranks as a masked sum, each rank's own columns and a sum across ranks,
    as XLA lowers it: DTensor's sharded gather cannot take it. Every other
    term of that sum is zero, so it is the gather's value."""
    if split_ranks(logits, -1) > 1:
        cols = torch.arange(logits.shape[-1], device=targets.device)
        return (logits * (cols == targets[..., None].long())).sum(-1)
    logits = gather_dim(logits, logits.ndim - 1)    # split over one rank: no transfer
    return torch.gather(logits, -1, targets[..., None].long())[..., 0]


def _ce_sum(x: torch.Tensor, unembed: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Σ (logsumexp − target logit) over one chunk, logits in float32."""
    logits = (x @ unembed).float()
    return (_logsumexp(logits) - _take_target(logits, targets)).sum()


def chunked_ce(x: torch.Tensor, unembed: torch.Tensor, targets: torch.Tensor,
               seq_chunk: int = 256) -> torch.Tensor:
    """Mean cross-entropy of x (B, S, D) @ unembed (D, V) against targets
    (B, S) without the full (B, S, V) logits: sequence chunks whose logits
    the backward recomputes (`torch.utils.checkpoint`, JAX's
    `jax.checkpoint`), summed in float32 in chunk order and divided by
    B·S. When `seq_chunk` does not divide S, the full logits' mean, as in
    the JAX package."""
    b, s, _d = x.shape
    x, unembed = gather_seq(x), gather_dim(unembed, 0)
    seq_chunk = min(seq_chunk, s)
    if s % seq_chunk != 0:
        logp = torch.log_softmax((x @ unembed).float(), dim=-1)
        return -_take_target(logp, targets).mean()
    total = None
    for c0 in range(0, s, seq_chunk):
        args = (x[:, c0:c0 + seq_chunk], unembed, targets[:, c0:c0 + seq_chunk])
        part = (checkpoint(_ce_sum, *args, use_reentrant=False) if torch.is_grad_enabled()
                else _ce_sum(*args))
        total = part if total is None else total + part
    return total / (b * s)
