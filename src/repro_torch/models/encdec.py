"""Encoder-decoder transformer (seamless-m4t-medium backbone): serving and
the training loss.

The speech frontend is a stub, as in the JAX package: a request brings
precomputed audio-frame embeddings `frames` (B, S_frames, 1280), and a
learned linear projector (`audio_proj`) maps them to d_model. The encoder
is bidirectional self-attention; the decoder is causal self-attention plus
cross-attention to the encoder's output, whose K/V are computed once at
prefill and cached for `decode_step`.

On the card the encoder's and the decoder's self-attention over the whole
sequence launch K7 (`models.attention`: Sq == Sk, non-causal and causal).
Cross-attention (Sq ≠ Sk) and decode run the plain chunked softmax, as the
JAX package leaves those patterns to XLA.

Both stacks rotate q and k with RoPE over all of the head dim: the JAX
package passes no `rotary_pct` here, and the blocks pass the config's,
which is 1.0 for seamless.

Caches: one {"k", "v", "ck", "cv"} per decoder layer: the self K/V (B,
max_len, Hkv, Dh) with RoPE applied, and the cross K/V (B, S_frames, Hkv,
Dh) without. `pos` is a Python int.

`loss` runs the decoder over the whole sequence; with `cfg.remat` and grad
on, each encoder and each decoder layer is recomputed in the backward, as
JAX's scans remat each layer.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models import dense
from repro_torch.models.dense import Cache, DenseBlock
from repro_torch.models.layers import (Attention, chunked_ce, dense_init, dtype_of, embed_init,
                                       embed_lookup, generator, merge_heads, param, remat, rmsnorm)
from repro_torch.sharding.context import bshard, gather_seq, pad_seq, seq_whole_grad

AUDIO_FEAT = 1280


class DecoderBlock(DenseBlock):
    """A decoder layer: `DenseBlock`'s causal self-attention and MLP, with
    the cross-attention projections (no biases) and their norm between."""

    AXES = {**DenseBlock.AXES, "cross_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device, gen: torch.Generator):
        super().__init__(cfg, 0, dtype, device, gen)
        self.cross = Attention(cfg, dtype, device, gen, cross=True)
        self.cross_norm = param(torch.ones((cfg.d_model,), dtype=dtype, device=device))

    def cross_kv(self, enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The encoder output's cross K and V, (B, S_frames, Hkv, Dh)."""
        b, sf = enc_out.shape[:2]
        shape = (b, sf, self.cfg.n_kv_heads, self.cfg.hd)
        return (enc_out @ self.cross.wk).reshape(shape), (enc_out @ self.cross.wv).reshape(shape)

    def self_and_cross(self, x: torch.Tensor, o: torch.Tensor,
                       kc: torch.Tensor, vc: torch.Tensor, kv_chunk: int) -> torch.Tensor:
        """Given the self-attention's output `o`: its projection and
        residual, the cross-attention to (kc, vc), the MLP."""
        cfg = self.cfg
        b, s = x.shape[:2]
        x = x + seq_whole_grad(merge_heads(o) @ self.attn.wo)
        h = rmsnorm(x, self.cross_norm, cfg.norm_eps)
        qc = (gather_seq(h) @ self.cross.wq).reshape(b, s, cfg.n_heads, cfg.hd)
        oc = attention(qc, kc, vc, causal=False, kv_chunk=kv_chunk)
        x = x + seq_whole_grad(merge_heads(oc) @ self.cross.wo)
        h = rmsnorm(x, self.mlp_norm, cfg.norm_eps)
        return bshard(x + self.mlp(h))


class EncDecLM(nn.Module):
    """The enc-dec family's parameters: audio_proj (1280, d), embed,
    unembed, enc_norm, final_norm, `cfg.n_enc_layers` encoder
    `DenseBlock`s and `cfg.n_layers` `DecoderBlock`s, from `seed` on
    `device` (the card unless the caller asks for the CPU)."""

    AXES = {"embed": ("vocab", "embed"), "unembed": ("embed", "vocab"),
            "final_norm": ("embed",), "audio_proj": (None, "embed"),
            "enc_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM serves the encdec family, not {cfg.family!r}")
        device = resolve_device(device)
        dtype = dtype_of(cfg.dtype)
        gen = generator(seed, device)
        vp, d = cfg.vocab_padded, cfg.d_model
        self.cfg = cfg
        self.audio_proj = param(dense_init(gen, (AUDIO_FEAT, d), dtype, device))
        self.embed = param(embed_init(gen, (vp, d), dtype, device))
        self.unembed = param(dense_init(gen, (d, vp), dtype, device))
        self.enc_norm = param(torch.ones((d,), dtype=dtype, device=device))
        self.final_norm = param(torch.ones((d,), dtype=dtype, device=device))
        self.enc_layers = nn.ModuleList(DenseBlock(cfg, 0, dtype, device, gen)
                                        for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(DecoderBlock(cfg, dtype, device, gen)
                                        for _ in range(cfg.n_layers))


def init(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None) -> EncDecLM:
    return EncDecLM(cfg, seed=seed, device=device)


def _enc_layer(blk: DenseBlock, x: torch.Tensor, positions: torch.Tensor,
               kv_chunk: int) -> torch.Tensor:
    return blk(x, positions, kv_chunk, causal=False)[0]


def _dec_layer(blk: DecoderBlock, x: torch.Tensor, enc_out: torch.Tensor,
               positions: torch.Tensor, kv_chunk: int) -> torch.Tensor:
    """One decoder layer over the whole sequence (JAX's `_dec_block`)."""
    h = rmsnorm(x, blk.attn_norm, blk.cfg.norm_eps)
    q, k, v = blk.qkv_rope(h, positions)
    o = attention(q, k, v, causal=True, kv_chunk=kv_chunk)
    kc, vc = blk.cross_kv(enc_out)
    return blk.self_and_cross(x, o, kc, vc, kv_chunk)


def encode(model: EncDecLM, frames: torch.Tensor, *, kv_chunk: int = 1024) -> torch.Tensor:
    """frames (B, S_frames, 1280) → the encoder's output (B, S_frames, D),
    whole over its frames on every rank of a mesh (each decoder layer's
    cross K/V projects it). Each layer is one remat unit (`layers.remat`),
    as in JAX."""
    x = frames.to(model.embed.dtype) @ model.audio_proj
    positions = torch.arange(x.shape[1], device=x.device)
    for blk in model.enc_layers:
        x = remat(_enc_layer, model.cfg, blk, x, positions, kv_chunk)
    return gather_seq(rmsnorm(x, model.enc_norm, model.cfg.norm_eps))


def loss(model: EncDecLM, batch: Dict[str, torch.Tensor], *,
         kv_chunk: int = 1024) -> torch.Tensor:
    """The encoder over batch["frames"], the decoder over batch["tokens"]
    (each layer a remat unit), then `layers.chunked_ce` against
    batch["targets"]."""
    cfg = model.cfg
    enc_out = encode(model, batch["frames"], kv_chunk=kv_chunk)
    tokens = batch["tokens"]
    x = embed_lookup(tokens, model.embed)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for blk in model.dec_layers:
        x = remat(_dec_layer, cfg, blk, x, enc_out, positions, kv_chunk)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return chunked_ce(x, model.unembed, batch["targets"])


# -- serving -------------------------------------------------------------------


@torch.no_grad()
def prefill(model: EncDecLM, batch: Dict[str, torch.Tensor], *, kv_chunk: int = 1024,
            max_len: int = 0) -> Tuple[torch.Tensor, Cache]:
    """The encoder over `frames`, then the decoder over `tokens`, filling
    the self caches (padded to max(max_len, S)) and the cross caches.
    → (logits (B, Vp) float32 at the last position, cache)."""
    cfg = model.cfg
    enc_out = encode(model, batch["frames"], kv_chunk=kv_chunk)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    ml = max(max_len, s)
    x = embed_lookup(tokens, model.embed)
    positions = torch.arange(s, device=tokens.device)
    layers: List[Dict[str, torch.Tensor]] = []
    for blk in model.dec_layers:
        h = rmsnorm(x, blk.attn_norm, cfg.norm_eps)
        q, k, v = blk.qkv_rope(h, positions)
        o = attention(q, k, v, causal=True, kv_chunk=kv_chunk)
        kc, vc = blk.cross_kv(enc_out)
        x = blk.self_and_cross(x, o, kc, vc, kv_chunk)
        layers.append({"k": pad_seq(k, 0, ml - s), "v": pad_seq(v, 0, ml - s),
                       "ck": kc, "cv": vc})
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = (x[:, -1] @ model.unembed).float()
    return logits, {"pos": s, "layers": layers}


def make_cache(cfg: ModelConfig, batch: int, seq: int, device: DeviceLike = None) -> Cache:
    """Zero caches: self K/V of `seq` slots, cross K/V of seq // downsample."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    s_audio = max(seq // cfg.audio_downsample, 1)

    def zeros(s):
        return torch.zeros((batch, s, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device)

    return {"pos": 0, "layers": [{"k": zeros(seq), "v": zeros(seq), "ck": zeros(s_audio),
                                  "cv": zeros(s_audio)} for _ in range(cfg.n_layers)]}


def cache_axes(cfg: ModelConfig) -> Cache:
    """The logical axes of `make_cache`'s tree, leaf for leaf."""
    kv = dense.KV_AXES
    return {"pos": (), "layers": [{"k": kv, "v": kv, "ck": kv, "cv": kv}
                                  for _ in range(cfg.n_layers)]}


@torch.no_grad()
def decode_step(model: EncDecLM, cache: Cache, batch: Dict[str, torch.Tensor], *,
                kv_chunk: int = 2048) -> Tuple[torch.Tensor, Cache]:
    """One-token decode. batch = {"token": (B,) ids}. Writes the token's
    self K/V into `cache` in place; the cross K/V stay as prefill left
    them. → (logits (B, Vp) float32, cache) with `pos` advanced."""
    cfg = model.cfg
    tok = batch["token"]
    pos = int(cache["pos"])
    x = embed_lookup(tok[:, None], model.embed)
    positions = torch.arange(pos, pos + 1, device=tok.device)
    for blk, kvc in zip(model.dec_layers, cache["layers"]):
        h = rmsnorm(x, blk.attn_norm, cfg.norm_eps)
        q, k, v = blk.qkv_rope(h, positions)
        s_cache = kvc["k"].shape[1]
        slot = min(pos, s_cache - 1)
        kvc["k"][:, slot] = k[:, 0]
        kvc["v"][:, slot] = v[:, 0]
        o = attention(q, kvc["k"], kvc["v"], causal=False,
                      kv_valid_len=min(pos + 1, s_cache), kv_chunk=kv_chunk)
        x = blk.self_and_cross(x, o, kvc["ck"], kvc["cv"], kv_chunk)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = (x[:, 0] @ model.unembed).float()
    cache["pos"] = pos + 1
    return logits, cache
