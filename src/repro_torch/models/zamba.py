"""Zamba2 hybrid (arXiv:2411.15242): a Mamba2 backbone and one SHARED
attention+MLP block applied after every `attn_every` Mamba2 blocks:
serving and the training loss (each group, its Mamba2 blocks and the
shared block, one remat unit as in JAX).

The shared block's weights are one parameter set reused at every
application site; its input is the current hidden state concatenated
with the embedding output x0, fused by a 2D→D projection, and its output
goes back through `out` onto the residual. Each application site keeps its
own KV cache (weights shared, state not).

On the card the shared block's prefill attention over the whole sequence
launches K7 (head dim 80 at zamba2-2.7b, which the bf16 kernel pads to
128), once a group; decode attends each site's cache with the plain
chunked softmax. The Mamba2 blocks are plain torch ops (`models/mamba2.py`).

Caches: {"pos": int, "mamba": one {"ssd", "conv"} state per Mamba2 block in
layer order, "attn": one {"k", "v"} (B, max_len, Hkv, Dh) per group}.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import dense, mamba2
from repro_torch.models.attention import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.dense import Cache
from repro_torch.models.layers import (MLP, Attention, apply_rope, chunked_ce, dense_init, dtype_of,
                                       embed_init, embed_lookup, generator, merge_heads, param, qkv,
                                       remat, rmsnorm)
from repro_torch.sharding.context import bshard, gather_seq, pad_seq, seq_whole_grad


def group_size(cfg: ModelConfig) -> int:
    """Mamba2 blocks between two applications of the shared block."""
    k = cfg.attn_every or cfg.n_layers
    if cfg.n_layers % k:
        raise ValueError(f"zamba: n_layers {cfg.n_layers} must divide by attn_every {k}")
    return k


class SharedBlock(nn.Module):
    """fuse (2d, d), attn_norm, mlp_norm, the attention projections, the
    SwiGLU MLP and out (d, d)."""

    AXES = {"fuse": ("embed", "embed_out"), "out": ("embed", "embed_out"),
            "attn_norm": ("embed",), "mlp_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device, gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        self.attn = Attention(cfg, dtype, device, gen)
        self.mlp = MLP(d, cfg.d_ff, dtype, device, gen)
        self.fuse = param(dense_init(gen, (2 * d, d), dtype, device))
        self.out = param(dense_init(gen, (d, d), dtype, device))
        self.attn_norm = param(torch.ones((d,), dtype=dtype, device=device))
        self.mlp_norm = param(torch.ones((d,), dtype=dtype, device=device))


class ZambaLM(nn.Module):
    """The hybrid family's parameters: embed, unembed, final_norm,
    `cfg.n_layers` `Mamba2Block`s in layer order (group g's block j at
    g·attn_every + j) and the `SharedBlock`, from `seed` on `device` (the
    card unless the caller asks for the CPU)."""

    AXES = {"embed": ("vocab", "embed"), "unembed": ("embed", "vocab"),
            "final_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"ZambaLM serves the hybrid family, not {cfg.family!r}")
        group_size(cfg)
        device = resolve_device(device)
        dtype = dtype_of(cfg.dtype)
        gen = generator(seed, device)
        vp, d = cfg.vocab_padded, cfg.d_model
        self.cfg = cfg
        self.embed = param(embed_init(gen, (vp, d), dtype, device))
        self.unembed = param(dense_init(gen, (d, vp), dtype, device))
        self.final_norm = param(torch.ones((d,), dtype=dtype, device=device))
        self.blocks = nn.ModuleList(mamba2.Mamba2Block(cfg, dtype, device, gen)
                                    for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, dtype, device, gen)


def init(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None) -> ZambaLM:
    return ZambaLM(cfg, seed=seed, device=device)


def _fused_qkv(x, x0, sp: SharedBlock, cfg: ModelConfig, positions):
    """The shared block up to attention: h = [x, x0]·fuse, and the roped
    q, k and v of rmsnorm(h)."""
    h = torch.cat([gather_seq(x), gather_seq(x0)], dim=-1) @ sp.fuse
    q, k, v = qkv(rmsnorm(h, sp.attn_norm, cfg.norm_eps), sp.attn, cfg)
    return h, apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def _shared_finish(x, h, o, sp: SharedBlock, cfg: ModelConfig) -> torch.Tensor:
    """The shared block after attention: projection and residual on h, the
    MLP, then `out` onto the residual stream x."""
    h = h + merge_heads(o) @ sp.attn.wo
    h = h + sp.mlp(rmsnorm(h, sp.mlp_norm, cfg.norm_eps))
    return x + seq_whole_grad(gather_seq(h) @ sp.out)


def _shared_apply(x, x0, sp: SharedBlock, cfg: ModelConfig, positions, kv_chunk: int):
    h, q, k, v = _fused_qkv(x, x0, sp, cfg, positions)
    o = attention(q, k, v, causal=True, kv_chunk=kv_chunk)
    return bshard(_shared_finish(x, h, o, sp, cfg)), (k, v)


def _group(blocks, sp: SharedBlock, cfg: ModelConfig, x, x0, positions, kv_chunk: int,
           chunk: int):
    """One group: its Mamba2 blocks, then the shared block."""
    for blk in blocks:
        x, _ = mamba2.apply(x, blk, cfg, chunk=chunk)
    return _shared_apply(x, x0, sp, cfg, positions, kv_chunk)[0]


def forward(model: ZambaLM, tokens: torch.Tensor, *, kv_chunk: int = 1024,
            chunk: int = 64) -> torch.Tensor:
    """tokens (B, S) → final hidden states (B, S, D). Each group is one
    remat unit (`layers.remat`), as in JAX."""
    cfg = model.cfg
    k = group_size(cfg)
    x = embed_lookup(tokens, model.embed)
    x0 = x
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for g in range(cfg.n_layers // k):
        x = remat(_group, cfg, model.blocks[g * k:(g + 1) * k], model.shared, cfg, x, x0,
                  positions, kv_chunk, chunk)
    return rmsnorm(x, model.final_norm, cfg.norm_eps)


def loss(model: ZambaLM, batch: Dict[str, torch.Tensor], *,
         kv_chunk: int = 1024) -> torch.Tensor:
    """`layers.chunked_ce` of the final hidden states against batch["targets"]."""
    x = forward(model, batch["tokens"], kv_chunk=kv_chunk)
    return chunked_ce(x, model.unembed, batch["targets"])


# -- serving -----------------------------------------------------------------------


def make_cache(cfg: ModelConfig, batch: int, seq: int, device: DeviceLike = None) -> Cache:
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    shape = (batch, seq, cfg.n_kv_heads, cfg.hd)
    return {"pos": 0,
            "mamba": [mamba2.make_state(cfg, batch, device) for _ in range(cfg.n_layers)],
            "attn": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}
                     for _ in range(cfg.n_layers // group_size(cfg))]}


def cache_axes(cfg: ModelConfig) -> Cache:
    """The logical axes of `make_cache`'s tree, leaf for leaf."""
    kv = dense.KV_AXES
    return {"pos": (), "mamba": [mamba2.state_axes() for _ in range(cfg.n_layers)],
            "attn": [{"k": kv, "v": kv} for _ in range(cfg.n_layers // group_size(cfg))]}


@torch.no_grad()
def prefill(model: ZambaLM, batch: Dict[str, torch.Tensor], *, kv_chunk: int = 1024,
            max_len: int = 0, chunk: int = 64) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt through, carrying each Mamba2 block's state and each
    shared site's K/V (padded to max(max_len, S)) into the cache.
    → (logits (B, Vp) float32 at the last position, cache)."""
    cfg = model.cfg
    k = group_size(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    ml = max(max_len, s)
    x = embed_lookup(tokens, model.embed)
    x0 = x
    positions = torch.arange(s, device=tokens.device)
    states, kvs = [], []
    for i, blk in enumerate(model.blocks):
        x, st = mamba2.apply_prefill(x, blk, cfg, chunk=chunk)
        states.append(st)
        if i % k == k - 1:
            x, (kk, vv) = _shared_apply(x, x0, model.shared, cfg, positions, kv_chunk)
            kvs.append({"k": pad_seq(kk, 0, ml - s), "v": pad_seq(vv, 0, ml - s)})
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = (x[:, -1] @ model.unembed).float()
    return logits, {"pos": s, "mamba": states, "attn": kvs}


@torch.no_grad()
def decode_step(model: ZambaLM, cache: Cache, batch: Dict[str, torch.Tensor], *,
                kv_chunk: int = 2048) -> Tuple[torch.Tensor, Cache]:
    """One-token decode. batch = {"token": (B,) ids}. Replaces each Mamba2
    state and writes each site's K/V into its cache in place.
    → (logits (B, Vp) float32, cache) with `pos` advanced."""
    cfg = model.cfg
    k = group_size(cfg)
    tok = batch["token"]
    pos = int(cache["pos"])
    x = embed_lookup(tok[:, None], model.embed)
    x0 = x
    positions = torch.arange(pos, pos + 1, device=tok.device)
    sp = model.shared
    for i, blk in enumerate(model.blocks):
        x, cache["mamba"][i] = mamba2.apply_decode(x, blk, cache["mamba"][i], cfg)
        if i % k == k - 1:
            kvc = cache["attn"][i // k]
            h, q, kk, vv = _fused_qkv(x, x0, sp, cfg, positions)
            s_cache = kvc["k"].shape[1]
            slot = min(pos, s_cache - 1)
            kvc["k"][:, slot] = kk[:, 0]
            kvc["v"][:, slot] = vv[:, 0]
            o = attention(q, kvc["k"], kvc["v"], causal=False,
                          kv_valid_len=min(pos + 1, s_cache), kv_chunk=kv_chunk)
            x = _shared_finish(x, h, o, sp, cfg)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = (x[:, 0] @ model.unembed).float()
    cache["pos"] = pos + 1
    return logits, cache
