"""xLSTM (sLSTM + mLSTM blocks), arXiv:2405.04517: serving and the
training loss.

mLSTM is a matrix-memory linear-attention recurrence with exponential input
gating and a running stabilizer m_t:

  m_t = max(log f_t + m_{t-1}, log i_t)
  C_t = exp(log f_t + m_{t-1} − m_t)·C_{t-1} + exp(log i_t − m_t)·k_t v_tᵀ
  n_t = (same decays on n)                 h_t = (q̂_t·C_t) / max(|q̂_t·n_t|, e^{−m_t})

Prefill uses the chunkwise-parallel form (intra-chunk quadratic plus the
carried (C, n, m) state); decode uses the O(1) recurrent step. sLSTM is
sequential (scalar memory with recurrent weights) and runs as a time loop,
one step a token. Every recurrence is float32, as in the JAX package, which
has no Pallas kernel here either.

Block pattern: `slstm_every` gives one sLSTM block per group (5 mLSTM + 1
sLSTM at xlstm-350m), then remainder mLSTM blocks (`_pattern`); the port
keeps them in one list in that order. Caches: {"pos": int, "layers": one
state dict per block: mLSTM {"c", "n", "m"}, sLSTM {"c", "n", "h", "m"}}.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.dense import Cache
from repro_torch.models.layers import (BSHD, chunked_ce, dense_init, dtype_of, embed_init,
                                       embed_lookup, generator, merge_heads, param, remat, rmsnorm,
                                       split_heads)
from repro_torch.sharding.context import constrain, gather_seq, over_batch_heads, seq_whole_grad

_NEG = -1e30


# -- mLSTM core ------------------------------------------------------------------


_BSH = ("batch", None, "heads")
_BHD = ("batch", "heads", None)
_MLSTM_STATE = (("batch", "heads", None, None), ("batch", "heads", None), ("batch", "heads"))


@over_batch_heads((BSHD, BSHD, BSHD, _BSH, _BSH, None, _MLSTM_STATE), (BSHD, _MLSTM_STATE))
def mlstm_chunked(q, k, v, log_f, log_i, chunk: int = 64, state: Optional[Tuple] = None):
    """q, k, v: (B, S, H, Dh); log_f, log_i: (B, S, H). Returns (h (B, S,
    H, Dh) float32, state = (C (B, H, Dh, Dh), n (B, H, Dh), m (B, H))). On
    DTensors, once a shard: each rank its own batch rows and heads."""
    b, s, nh, dh = q.shape
    chunk = min(chunk, s)
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def pad_t(x, value=0.0):
        return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad), value=value)

    # padding: log_f = 0 (no decay), log_i = -1e30 (no input) keeps the state exact
    qp = pad_t(q.float() / (dh ** 0.5))
    kp, vp, lfp = pad_t(k.float()), pad_t(v.float()), pad_t(log_f.float())
    lip = pad_t(log_i.float(), _NEG)
    dev = q.device
    if state is None:
        state = (torch.zeros((b, nh, dh, dh), dtype=torch.float32, device=dev),
                 torch.zeros((b, nh, dh), dtype=torch.float32, device=dev),
                 torch.full((b, nh), _NEG, dtype=torch.float32, device=dev))
    c_st, n_st, m_st = state
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))

    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qi, ki, vi, lf, li = qp[:, sl], kp[:, sl], vp[:, sl], lfp[:, sl], lip[:, sl]
        bcum = torch.cumsum(lf, dim=1)                   # b_j inclusive
        btot = bcum[:, -1]                               # (B, H)

        # m_intra_i = b_i + prefix-max_j≤i (li_j − b_j)
        gmax = torch.cummax(li - bcum, dim=1).values
        m_intra = bcum + gmax
        m_i = torch.maximum(m_st[:, None] + bcum, m_intra)   # (B, T, H)

        # intra-chunk weights: exp(b_i − b_j + li_j − m_i), j ≤ i
        lw = (bcum[:, :, None] - bcum[:, None, :] + li[:, None, :]
              - m_i[:, :, None])                         # (B, T_i, T_j, H)
        # masked before the exp, as in models/mamba2.py (JAX masks after it)
        w = torch.exp(torch.where(causal[None, :, :, None], lw, -torch.inf))

        score = torch.einsum("bihd,bjhd->bijh", qi, ki)
        num_intra = torch.einsum("bijh,bjhd->bihd", score * w, vi)
        den_intra = torch.einsum("bijh,bjhd,bihd->bih", w, ki, qi)

        s_inter = torch.exp(m_st[:, None] + bcum - m_i)      # (B, T, H)
        num_inter = torch.einsum("bihd,bhde->bihe", qi, c_st) * s_inter[..., None]
        den_inter = torch.einsum("bihd,bhd->bih", qi, n_st) * s_inter

        num = num_intra + num_inter
        den = den_intra + den_inter
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m_i))[..., None])

        # state update (= values at i = T)
        m_new = m_i[:, -1]
        dec_j = torch.exp(btot[:, None] - bcum + li - m_new[:, None])   # (B, T, H)
        carry = torch.exp(m_st + btot - m_new)
        c_st = (c_st * carry[..., None, None]
                + torch.einsum("bjh,bjhd,bjhe->bhde", dec_j, ki, vi))
        n_st = n_st * carry[..., None] + torch.einsum("bjh,bjhd->bhd", dec_j, ki)
        m_st = m_new
    h = torch.cat(hs, dim=1)
    return h[:, :s], (c_st, n_st, m_st)


@over_batch_heads((_MLSTM_STATE, _BHD, _BHD, _BHD, ("batch", "heads"), ("batch", "heads")),
                  (_MLSTM_STATE, _BHD), key=1)
def mlstm_recurrent_step(state, q, k, v, log_f, log_i):
    """One-token step. q, k, v: (B, H, Dh); gates: (B, H). On DTensors,
    once a shard, as `mlstm_chunked`."""
    c_st, n_st, m_st = state
    dh = q.shape[-1]
    q = q.float() / (dh ** 0.5)
    k = k.float()
    v = v.float()
    m_new = torch.maximum(log_f + m_st, log_i)
    df = torch.exp(log_f + m_st - m_new)
    di = torch.exp(log_i - m_new)
    c_new = df[..., None, None] * c_st + di[..., None, None] * (k[..., :, None] * v[..., None, :])
    n_new = df[..., None] * n_st + di[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, c_new)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n_new)), torch.exp(-m_new))
    return (c_new, n_new, m_new), num / den[..., None]


# -- sLSTM core (sequential, scalar memory with exponential gating) -----------------


_SLSTM_STATE = (("batch", "heads", None),) * 4


@over_batch_heads((("batch", None, "heads", None, None), ("heads", None, None, None),
                   _SLSTM_STATE), (BSHD, _SLSTM_STATE))
def slstm_scan(x_gates: torch.Tensor, r_weights: torch.Tensor, state: Optional[Tuple] = None):
    """x_gates: (B, S, H, 4, Dh) input preactivations (i, f, z, o);
    r_weights: (H, 4, Dh, Dh) recurrent block-diagonal weights.
    Returns (h (B, S, H, Dh) float32, state (c, n, h, m)). On DTensors,
    once a shard: each rank steps its own batch rows and heads."""
    b, s, nh, _, dh = x_gates.shape
    if state is None:
        state = tuple(torch.zeros((b, nh, dh), dtype=torch.float32, device=x_gates.device)
                      for _ in range(4))
    c, n, h, m = state
    one = torch.ones((), dtype=torch.float32, device=x_gates.device)
    hs = []
    for t in range(s):
        rec = torch.einsum("bhd,hgde->bhge", h, r_weights)
        pre = x_gates[:, t].float() + rec
        i_t = pre[:, :, 0]
        f_t = pre[:, :, 1]
        z_t = torch.tanh(pre[:, :, 2])
        o_t = torch.sigmoid(pre[:, :, 3])
        m_new = torch.maximum(f_t + m, i_t)              # log-space stabilizer
        ig = torch.exp(i_t - m_new)
        fg = torch.exp(f_t + m - m_new)
        c = fg * c + ig * z_t
        n = fg * n + ig
        # n is exactly 1 wherever a first step's input gate wins; at that tie
        # `maximum` splits the gradient as `jnp.maximum` does (clamp_min would not)
        h = o_t * c / torch.maximum(n, one)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)


# -- blocks ---------------------------------------------------------------------


class MLSTMBlock(nn.Module):
    """norm, w_up and w_z (d, di), wq, wk and wv (di, di), w_gates (d, 2H),
    head_norm (di,), w_down (di, d); di = mamba_expand · d."""

    kind = "m"
    AXES = {"norm": ("embed",), "w_up": ("embed", "inner"), "w_z": ("embed", "inner"),
            "wq": ("inner_fsdp", "inner"), "wk": ("inner_fsdp", "inner"),
            "wv": ("inner_fsdp", "inner"), "w_gates": ("embed", None),
            "head_norm": ("inner",), "w_down": ("inner", "embed")}

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device, gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        di = cfg.mamba_expand * d
        self.norm = param(torch.ones((d,), dtype=dtype, device=device))
        self.w_up = param(dense_init(gen, (d, di), dtype, device))
        self.w_z = param(dense_init(gen, (d, di), dtype, device))
        self.wq = param(dense_init(gen, (di, di), dtype, device))
        self.wk = param(dense_init(gen, (di, di), dtype, device))
        self.wv = param(dense_init(gen, (di, di), dtype, device))
        self.w_gates = param(dense_init(gen, (d, 2 * cfg.n_heads), dtype, device))
        self.head_norm = param(torch.ones((di,), dtype=dtype, device=device))
        self.w_down = param(dense_init(gen, (di, d), dtype, device))


class SLSTMBlock(nn.Module):
    """norm, w_in (d, H·4·Dh), r (H, 4, Dh, Dh) float32, w_out (d, d); Dh = d / H."""

    kind = "s"
    AXES = {"norm": ("embed",), "w_in": ("embed", "inner"),
            "r": ("mheads", None, None, None), "w_out": ("embed", "embed_out")}

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device, gen: torch.Generator):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        dh = d // nh
        self.norm = param(torch.ones((d,), dtype=dtype, device=device))
        self.w_in = param(dense_init(gen, (d, nh * 4 * dh), dtype, device))
        self.r = param(dense_init(gen, (nh, 4, dh, dh), torch.float32, device))
        self.w_out = param(dense_init(gen, (d, d), dtype, device))


def _mlstm_qkv_gates(x, p: MLSTMBlock, cfg: ModelConfig):
    """→ (z, q, k, v (B, S, H, Dh), log_f, log_i (B, S, H) float32)."""
    b, s, d = x.shape
    nh = cfg.n_heads
    dh = cfg.mamba_expand * d // nh
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    h = gather_seq(h)
    u = h @ p.w_up
    z = h @ p.w_z
    q, k, v = (split_heads(u @ w, nh, dh) for w in (p.wq, p.wk, p.wv))
    gates = (h @ p.w_gates).float()
    log_i = gates[..., :nh]
    log_f = -F.softplus(-gates[..., nh:])                # log σ(f̃)
    return z, q, k, v, log_f, log_i


def _mlstm_out(x, o, z, p: MLSTMBlock, cfg: ModelConfig) -> torch.Tensor:
    b, s, _d = x.shape
    o = rmsnorm(merge_heads(o).to(x.dtype), p.head_norm, cfg.norm_eps)
    return x + seq_whole_grad(gather_seq(o * F.silu(z)) @ p.w_down)


def _mlstm_apply(x, p: MLSTMBlock, cfg: ModelConfig, chunk: int, state=None):
    z, q, k, v, log_f, log_i = _mlstm_qkv_gates(x, p, cfg)
    o, new_state = mlstm_chunked(q, k, v, log_f, log_i, chunk=chunk, state=state)
    # batch-only boundary: the chunk reshape fights seq-parallel sharding
    return constrain(_mlstm_out(x, o, z, p, cfg), ("batch", None, None)), {
        "c": new_state[0], "n": new_state[1], "m": new_state[2]}


def _mlstm_decode(x, p: MLSTMBlock, st, cfg: ModelConfig):
    z, q, k, v, log_f, log_i = _mlstm_qkv_gates(x, p, cfg)
    state, o = mlstm_recurrent_step((st["c"], st["n"], st["m"]), q[:, 0], k[:, 0], v[:, 0],
                                    log_f[:, 0], log_i[:, 0])
    return _mlstm_out(x, o[:, None], z, p, cfg), {"c": state[0], "n": state[1],
                                                  "m": state[2]}


def _slstm_apply(x, p: SLSTMBlock, cfg: ModelConfig, state=None, boundary: bool = True):
    """The sLSTM block; `boundary` constrains its output (the prefill and
    train forms; the reference's decode does not)."""
    b, s, d = x.shape
    nh = cfg.n_heads
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    gates = split_heads(gather_seq(h) @ p.w_in, nh, 4 * (d // nh)).reshape(b, s, nh, 4, d // nh)
    o, st = slstm_scan(gates, p.r, state=state)
    y = seq_whole_grad(gather_seq(merge_heads(o).to(x.dtype)) @ p.w_out)
    out = constrain(x + y, ("batch", None, None)) if boundary else x + y
    return out, {"c": st[0], "n": st[1], "h": st[2], "m": st[3]}


def _slstm_decode(x, p: SLSTMBlock, st, cfg: ModelConfig):
    return _slstm_apply(x, p, cfg, state=(st["c"], st["n"], st["h"], st["m"]),
                        boundary=False)


# -- full model -------------------------------------------------------------------


def _pattern(cfg: ModelConfig):
    if cfg.slstm_every > 0:
        pat = ("m",) * (cfg.slstm_every - 1) + ("s",)
    else:
        pat = ("m",)
    n_groups = cfg.n_layers // len(pat)
    rem = cfg.n_layers - n_groups * len(pat)
    return pat, n_groups, ("m",) * rem


def block_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    """Each block's kind ("m" or "s") in layer order: the groups, then the
    remainder."""
    pat, n_groups, rem = _pattern(cfg)
    return pat * n_groups + rem


class XLSTMLM(nn.Module):
    """The xlstm family's parameters: embed, unembed, final_norm and
    `cfg.n_layers` blocks in `block_kinds` order, from `seed` on `device`
    (the card unless the caller asks for the CPU)."""

    AXES = {"embed": ("vocab", "embed"), "unembed": ("embed", "vocab"),
            "final_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        if cfg.family != "xlstm":
            raise ValueError(f"XLSTMLM serves the xlstm family, not {cfg.family!r}")
        device = resolve_device(device)
        dtype = dtype_of(cfg.dtype)
        gen = generator(seed, device)
        vp, d = cfg.vocab_padded, cfg.d_model
        self.cfg = cfg
        self.embed = param(embed_init(gen, (vp, d), dtype, device))
        self.unembed = param(dense_init(gen, (d, vp), dtype, device))
        self.final_norm = param(torch.ones((d,), dtype=dtype, device=device))
        self.blocks = nn.ModuleList((MLSTMBlock if kind == "m" else SLSTMBlock)(
            cfg, dtype, device, gen) for kind in block_kinds(cfg))


def init(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None) -> XLSTMLM:
    return XLSTMLM(cfg, seed=seed, device=device)


def _run_blocks(blocks, cfg: ModelConfig, x: torch.Tensor, chunk: int) -> torch.Tensor:
    for blk in blocks:
        if blk.kind == "m":
            x, _ = _mlstm_apply(x, blk, cfg, chunk)
        else:
            x, _ = _slstm_apply(x, blk, cfg)
    return x


def forward(model: XLSTMLM, tokens: torch.Tensor, *, chunk: int = 64) -> torch.Tensor:
    """tokens (B, S) → final hidden states (B, S, D). Each pattern group is
    one remat unit (`layers.remat`); the remainder blocks lie outside it,
    as in JAX."""
    cfg = model.cfg
    pat, n_groups, _rem = _pattern(cfg)
    n = len(pat)
    x = embed_lookup(tokens, model.embed)
    for g in range(n_groups):
        x = remat(_run_blocks, cfg, model.blocks[g * n:(g + 1) * n], cfg, x, chunk)
    x = _run_blocks(model.blocks[n_groups * n:], cfg, x, chunk)
    return rmsnorm(x, model.final_norm, cfg.norm_eps)


def loss(model: XLSTMLM, batch: Dict[str, torch.Tensor], *,
         kv_chunk: int = 1024) -> torch.Tensor:
    """`layers.chunked_ce` of the final hidden states against
    batch["targets"] (`kv_chunk` is the bundle's common argument)."""
    del kv_chunk
    x = forward(model, batch["tokens"])
    return chunked_ce(x, model.unembed, batch["targets"])


# -- serving: recurrent state cache (O(1) per token) ---------------------------------


def make_cache(cfg: ModelConfig, batch: int, seq: int, device: DeviceLike = None) -> Cache:
    """Zero states; their size does not depend on `seq`."""
    del seq
    device = resolve_device(device)
    d, nh = cfg.d_model, cfg.n_heads
    dh_m, dh_s = cfg.mamba_expand * d // nh, d // nh

    def zeros(*shape, fill=0.0):
        return torch.full(shape, fill, dtype=torch.float32, device=device)

    def state(kind):
        if kind == "m":
            return {"c": zeros(batch, nh, dh_m, dh_m), "n": zeros(batch, nh, dh_m),
                    "m": zeros(batch, nh, fill=_NEG)}
        return {n: zeros(batch, nh, dh_s) for n in ("c", "n", "h", "m")}

    return {"pos": 0, "layers": [state(kind) for kind in block_kinds(cfg)]}


def cache_axes(cfg: ModelConfig) -> Cache:
    """The logical axes of `make_cache`'s tree, leaf for leaf."""
    m_ax = {"c": ("batch", "mheads", None, None), "n": ("batch", "mheads", None),
            "m": ("batch", "mheads")}
    s_ax = {n: ("batch", "mheads", None) for n in ("c", "n", "h", "m")}
    return {"pos": (), "layers": [dict(m_ax if kind == "m" else s_ax)
                                  for kind in block_kinds(cfg)]}


@torch.no_grad()
def prefill(model: XLSTMLM, batch: Dict[str, torch.Tensor], *, kv_chunk: int = 1024,
            max_len: int = 0, chunk: int = 64) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt through, carrying each block's recurrent state into
    the cache (`kv_chunk` and `max_len` are the bundle's common arguments;
    the states need neither). → (logits (B, Vp) float32 at the last
    position, cache)."""
    del kv_chunk, max_len
    cfg = model.cfg
    tokens = batch["tokens"]
    x = embed_lookup(tokens, model.embed)
    states = []
    for blk in model.blocks:
        if blk.kind == "m":
            x, st = _mlstm_apply(x, blk, cfg, chunk)
        else:
            x, st = _slstm_apply(x, blk, cfg)
        states.append(st)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = (x[:, -1] @ model.unembed).float()
    return logits, {"pos": tokens.shape[1], "layers": states}


@torch.no_grad()
def decode_step(model: XLSTMLM, cache: Cache, batch: Dict[str, torch.Tensor], *,
                kv_chunk: int = 2048) -> Tuple[torch.Tensor, Cache]:
    """One-token decode: each block's recurrent step, its state replaced in
    `cache`. → (logits (B, Vp) float32, cache) with `pos` advanced."""
    del kv_chunk
    cfg = model.cfg
    x = embed_lookup(batch["token"][:, None], model.embed)
    for i, blk in enumerate(model.blocks):
        step = _mlstm_decode if blk.kind == "m" else _slstm_decode
        x, cache["layers"][i] = step(x, blk, cache["layers"][i], cfg)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = (x[:, 0] @ model.unembed).float()
    cache["pos"] = int(cache["pos"]) + 1
    return logits, cache
