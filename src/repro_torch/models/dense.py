"""Dense decoder-only transformer family: the serving path.

Covers qwen2.5 (QKV bias), mistral-large, stablelm (partial rotary),
gemma3 (5:1 local:global sliding-window pattern) and, with an image-prefix
projector and the prefix-LM mask, paligemma (the `vlm` family: the SigLIP
frontend is a stub, so a request brings (B, n_img_tokens, 1152) patch
embeddings as `img_embed`), and the training loss (`loss`).

`DenseLM` holds the layers in order. The JAX package stacks them as
pattern groups (`groups/sub{si}` with a leading n_groups axis) plus
remainder layers (`rem{ri}`) so that XLA can scan them; layer g·len(pat)+si
comes first, then the remainder, and `layer_windows` gives each layer's
window in that order. Eager PyTorch needs no scan, so the port keeps a flat
list (`convert.params_from_jax` unstacks a JAX tree into it). With
`cfg.remat` and grad on, `forward` recomputes each pattern group in the
backward, JAX's remat unit; the remainder layers lie outside it, as in
JAX. The MoE family is this model with a routed MLP in each block
(`models/moe.py`).

Caches: one {"k", "v"} per layer in the same order, each (B, S_cache, Hkv,
Dh) with RoPE applied. Global layers cache `max_len` positions (padded at
prefill); sliding-window layers keep a ring of `window` slots, position p
in slot p % window (softmax is permutation-invariant, so ring order is
harmless). `pos` is the number of positions consumed, a Python int; for
paligemma it counts the image tokens too. `decode_step` writes the new
token's k/v into the cache in place (the JAX package returns new arrays),
which saves a copy of every cache per step.

Prefill's self-attention launches kernel K7 on the card (`models.attention`);
decode attends the cache with the plain chunked softmax, as the JAX package
leaves that pattern to XLA. So does paligemma's prefill: the prefix-LM mask
is not K7's function (nor the Pallas kernel's), so the vlm family launches
no kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, Attention, apply_rope, chunked_ce, dense_init, dtype_of,
                                       embed_init, embed_lookup, generator, merge_heads, param, qkv,
                                       remat, rmsnorm)
from repro_torch.sharding.context import bshard, pad_seq, seq_whole_grad

Cache = Dict[str, object]

VISION_FEAT = 1152   # SigLIP width (paligemma's stub frontend)
KV_AXES = ("batch", None, "kv_heads_c", "head_dim_c")   # a (B, S, Hkv, Dh) cache leaf


# -- layer pattern -------------------------------------------------------------


def layer_pattern(cfg: ModelConfig) -> Tuple[Tuple[int, ...], int, Tuple[int, ...]]:
    """(group_pattern, n_groups, remainder_pattern) of per-layer windows."""
    if cfg.local_global_ratio > 0:
        pat = (cfg.sliding_window,) * cfg.local_global_ratio + (0,)
    elif cfg.sliding_window > 0:
        pat = (cfg.sliding_window,)
    else:
        pat = (0,)
    n_groups = cfg.n_layers // len(pat)
    rem = cfg.n_layers - n_groups * len(pat)
    if cfg.local_global_ratio > 0:
        rem_pat = (cfg.sliding_window,) * rem
    else:
        rem_pat = (0,) * rem if pat == (0,) else (cfg.sliding_window,) * rem
    return pat, n_groups, rem_pat


def layer_windows(cfg: ModelConfig) -> Tuple[int, ...]:
    """Each layer's window (0 = global) in layer order: the groups, then
    the remainder."""
    pat, n_groups, rem = layer_pattern(cfg)
    return pat * n_groups + rem


# -- params ---------------------------------------------------------------------


class DenseBlock(nn.Module):
    """One pre-norm decoder layer: attention and an MLP, by default SwiGLU
    (the MoE family passes its routed one)."""

    AXES = {"attn_norm": ("embed",), "mlp_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, window: int, dtype: torch.dtype, device,
                 gen: torch.Generator, mlp: Optional[nn.Module] = None):
        super().__init__()
        self.cfg = cfg
        self.window = window
        self.attn = Attention(cfg, dtype, device, gen)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device, gen) if mlp is None else mlp
        self.attn_norm = param(torch.ones((cfg.d_model,), dtype=dtype, device=device))
        self.mlp_norm = param(torch.ones((cfg.d_model,), dtype=dtype, device=device))

    def qkv_rope(self, h: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        q, k, v = qkv(h, self.attn, cfg)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
        return q, k, v

    def finish(self, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        """Output projection, residual, MLP and residual (a block boundary,
        `bshard`)."""
        x = x + seq_whole_grad(merge_heads(o) @ self.attn.wo)
        h = rmsnorm(x, self.mlp_norm, self.cfg.norm_eps)
        return bshard(x + self.mlp(h))

    def forward(self, x: torch.Tensor, positions: torch.Tensor, kv_chunk: int = 1024,
                prefix_len: Optional[int] = None, causal: bool = True):
        """→ (x, k, v): the layer's output and its roped k and v.
        `prefix_len`: columns below it are visible to every row (prefix-LM);
        `causal=False` is the enc-dec encoder's bidirectional layer."""
        h = rmsnorm(x, self.attn_norm, self.cfg.norm_eps)
        q, k, v = self.qkv_rope(h, positions)
        o = attention(q, k, v, causal=causal, window=self.window, prefix_len=prefix_len,
                      kv_chunk=kv_chunk)
        return self.finish(x, o), k, v


class DenseLM(nn.Module):
    """The dense family's parameters (the counterpart of the JAX `init`):
    embed (Vp, d) and unembed (d, Vp) over the padded vocabulary, the
    final norm, `cfg.n_layers` blocks in layer order (`make_block`) and,
    for paligemma, the image projector img_proj (1152, d). Weights are
    drawn from a `torch.Generator` seeded with `seed`, on `device` (the
    card unless the caller asks for the CPU), in `cfg.dtype`."""

    FAMILIES = ("dense", "vlm")
    AXES = {"embed": ("vocab", "embed"), "unembed": ("embed", "vocab"),
            "final_norm": ("embed",), "img_proj": (None, "embed")}

    def __init__(self, cfg: ModelConfig, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        if cfg.family not in self.FAMILIES:
            raise ValueError(f"{type(self).__name__} serves the {self.FAMILIES} families, "
                             f"not {cfg.family!r}")
        device = resolve_device(device)
        dtype = dtype_of(cfg.dtype)
        gen = generator(seed, device)
        vp = cfg.vocab_padded
        self.cfg = cfg
        self.embed = param(embed_init(gen, (vp, cfg.d_model), dtype, device))
        self.unembed = param(dense_init(gen, (cfg.d_model, vp), dtype, device))
        self.final_norm = param(torch.ones((cfg.d_model,), dtype=dtype, device=device))
        self.layers = nn.ModuleList(self.make_block(cfg, w, dtype, device, gen)
                                    for w in layer_windows(cfg))
        self.img_proj = (param(dense_init(gen, (VISION_FEAT, cfg.d_model), dtype, device))
                         if cfg.n_img_tokens else None)

    def make_block(self, cfg: ModelConfig, window: int, dtype: torch.dtype, device,
                   gen: torch.Generator) -> nn.Module:
        return DenseBlock(cfg, window, dtype, device, gen)

    def forward(self, tokens: torch.Tensor, kv_chunk: int = 1024) -> torch.Tensor:
        return forward(self, tokens, kv_chunk=kv_chunk)


def init(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None) -> DenseLM:
    return DenseLM(cfg, seed=seed, device=device)


# -- forward --------------------------------------------------------------------


def embed_inputs(model: DenseLM, tokens: torch.Tensor,
                 img_embed: Optional[torch.Tensor] = None, shard: bool = False
                 ) -> Tuple[torch.Tensor, Optional[int]]:
    """The token embeddings, with paligemma's projected image embeddings
    in front → (x (B, [N_img +] S, D), prefix_len: N_img or None). With
    `shard` the token embeddings are a block boundary (`bshard`), as in
    the reference's forward."""
    x = embed_lookup(tokens, model.embed)
    if shard:
        x = bshard(x)
    if not model.cfg.n_img_tokens or img_embed is None:
        return x, None
    img = img_embed.to(x.dtype) @ model.img_proj
    return torch.cat([img, x], dim=1), model.cfg.n_img_tokens


def _run_layers(blocks, x: torch.Tensor, positions: torch.Tensor, kv_chunk: int,
                prefix_len: Optional[int]) -> torch.Tensor:
    for blk in blocks:
        x, _k, _v = blk(x, positions, kv_chunk, prefix_len)
    return x


def forward(model: DenseLM, tokens: torch.Tensor, *,
            img_embed: Optional[torch.Tensor] = None, kv_chunk: int = 1024) -> torch.Tensor:
    """tokens (B, S) → final hidden states (B, [N_img +] S, D). Each
    pattern group is one remat unit (`layers.remat`)."""
    cfg = model.cfg
    x, prefix_len = embed_inputs(model, tokens, img_embed, shard=True)
    positions = torch.arange(x.shape[1], device=tokens.device)
    pat, n_groups, _rem = layer_pattern(cfg)
    n = len(pat)
    for g in range(n_groups):
        x = remat(_run_layers, cfg, model.layers[g * n:(g + 1) * n], x, positions,
                  kv_chunk, prefix_len)
    x = _run_layers(model.layers[n_groups * n:], x, positions, kv_chunk, prefix_len)
    return rmsnorm(x, model.final_norm, cfg.norm_eps)


def loss(model: DenseLM, batch: Dict[str, torch.Tensor], *,
         kv_chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy of batch["tokens"] against
    batch["targets"] (`layers.chunked_ce`). For paligemma the image
    positions are dropped first, as in JAX (which drops them whether or
    not the batch brings `img_embed`)."""
    cfg = model.cfg
    x = forward(model, batch["tokens"], img_embed=batch.get("img_embed"), kv_chunk=kv_chunk)
    if cfg.n_img_tokens:
        x = x[:, cfg.n_img_tokens:]
    return chunked_ce(x, model.unembed, batch["targets"])


# -- serving (cache) ---------------------------------------------------------------


def make_cache(cfg: ModelConfig, batch: int, seq: int, device: DeviceLike = None) -> Cache:
    """Zero KV caches: a ring of `window` slots for sliding-window layers,
    `seq` slots for global ones."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)

    def one(win):
        s = min(win, seq) if win > 0 else seq
        shape = (batch, s, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"pos": 0, "layers": [one(w) for w in layer_windows(cfg)]}


def cache_axes(cfg: ModelConfig) -> Cache:
    """The logical axes of `make_cache`'s tree, leaf for leaf (`pos`, a
    Python int, has none: ())."""
    return {"pos": (), "layers": [{"k": KV_AXES, "v": KV_AXES} for _ in layer_windows(cfg)]}


def _cache_entry(t: torch.Tensor, win: int, s: int, max_len: int) -> torch.Tensor:
    """A prefill's (B, S, Hkv, Dh) keys or values as the layer caches them."""
    if win > 0:  # keep the last `win` positions, ring-aligned (slot = pos % win)
        wlen = min(win, s)
        t = t[:, s - wlen:]
        if wlen == win:
            return torch.roll(t, shifts=s % win, dims=1)
        return pad_seq(t, 0, win - wlen)               # pos p already sits at slot p
    if max_len > s:  # room for subsequent decode steps
        return pad_seq(t, 0, max_len - s)
    return t.contiguous()


@torch.no_grad()
def prefill(model: DenseLM, batch: Dict[str, torch.Tensor], *, kv_chunk: int = 1024,
            max_len: int = 0) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward that also fills the caches. Global-attention
    caches are padded to `max_len` (≥ S + decode budget); sliding-window
    layers keep a `window`-sized ring regardless. → (logits (B, Vp) float32
    at the last position, cache). With paligemma's `img_embed` the image
    tokens come first and count in S."""
    cfg = model.cfg
    tokens = batch["tokens"]
    x, prefix_len = embed_inputs(model, tokens, batch.get("img_embed"))
    s = x.shape[1]
    positions = torch.arange(s, device=tokens.device)
    layers: List[Dict[str, torch.Tensor]] = []
    for blk in model.layers:
        x, k, v = blk(x, positions, kv_chunk, prefix_len)
        layers.append({"k": _cache_entry(k, blk.window, s, max_len),
                       "v": _cache_entry(v, blk.window, s, max_len)})
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = (x[:, -1] @ model.unembed).float()
    return logits, {"pos": s, "layers": layers}


@torch.no_grad()
def decode_step(model: DenseLM, cache: Cache, batch: Dict[str, torch.Tensor], *,
                kv_chunk: int = 2048) -> Tuple[torch.Tensor, Cache]:
    """One-token decode. batch = {"token": (B,) integer ids}. Writes the
    token's k/v into `cache` in place and returns (logits (B, Vp) float32,
    cache) with `pos` advanced."""
    cfg = model.cfg
    tok = batch["token"]
    pos = int(cache["pos"])
    x = embed_lookup(tok[:, None], model.embed)
    positions = torch.arange(pos, pos + 1, device=tok.device)
    for blk, kvc in zip(model.layers, cache["layers"]):
        h = rmsnorm(x, blk.attn_norm, cfg.norm_eps)
        q, k, v = blk.qkv_rope(h, positions)
        s_cache = kvc["k"].shape[1]
        slot = pos % s_cache if blk.window > 0 else min(pos, s_cache - 1)
        kvc["k"][:, slot] = k[:, 0]
        kvc["v"][:, slot] = v[:, 0]
        o = attention(q, kvc["k"], kvc["v"], causal=False,
                      kv_valid_len=min(pos + 1, s_cache), kv_chunk=kv_chunk)
        x = blk.finish(x, o)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = (x[:, 0] @ model.unembed).float()
    cache["pos"] = pos + 1
    return logits, cache
