"""Mamba2 (SSD) block: the chunked state-space dual form, and the one-token
step that decode carries.

Per head (state N, head dim P):  h_t = exp(dt_t·A)·h_{t−1} + dt_t·x_t⊗B_t,
y_t = h_t·C_t + D·x_t. Prefill uses the chunkwise form (intra-chunk
quadratic plus inter-chunk state passing); decode carries (conv window,
SSD state) in O(1) per token. The JAX package has no Pallas kernel here
either: these are plain torch ops, with the JAX module's float32 upcasts
(x, dt, B, C and the segment sums in float32, the depthwise convolution
in float32 against its float32 weights) at the same places.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import BSHD, dense_init, param, rmsnorm
from repro_torch.sharding.context import (bshard, gather_seq, over_batch_heads, pad_seq,
                                          seq_whole_grad)

State = Dict[str, torch.Tensor]


@over_batch_heads((BSHD, ("batch", None, "heads"), ("heads",), ("batch", None, None),
                   ("batch", None, None), None, ("batch", "heads", None, None)),
                  (BSHD, ("batch", "heads", None, None)))
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_mat: torch.Tensor,
                C_mat: torch.Tensor, chunk: int = 64,
                state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P); dt: (B, S, H); A: (H,) negative; B_mat/C_mat: (B, S, N).
    Returns (y (B, S, H, P) float32, state (B, H, P, N) float32). On
    DTensors, once a shard: each rank scans its own batch rows and heads
    over the whole sequence; B and C are shared by the heads."""
    b, s, nh, p = x.shape
    n = B_mat.shape[-1]
    chunk = min(chunk, s)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.float(), (0, 0, 0, pad))           # dt = 0 ⇒ no decay, no input
    Bf = F.pad(B_mat.float(), (0, 0, 0, pad))
    Cf = F.pad(C_mat.float(), (0, 0, 0, pad))
    if state is None:
        state = torch.zeros((b, nh, p, n), dtype=torch.float32, device=x.device)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))

    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xi, dti, Bi, Ci = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        ldec = dti * A                                   # (B, T, H) log decay ≤ 0
        cum = torch.cumsum(ldec, dim=1)
        # intra: w_ij = exp(cum_i − cum_j)·dt_j, j ≤ i
        lw = cum[:, :, None] - cum[:, None, :]           # (B, T_i, T_j, H)
        # masked before the exp: above the diagonal lw > 0 can overflow, and
        # exp's gradient there, 0·inf, would be NaN (the JAX package masks
        # after the exp and gets NaN gradients)
        w = torch.exp(torch.where(causal[None, :, :, None], lw, -torch.inf)) * dti[:, None]
        cb = torch.einsum("bin,bjn->bij", Ci, Bi)        # (B, T_i, T_j)
        y_intra = torch.einsum("bijh,bjhp->bihp", cb[..., None] * w, xi)
        # inter: y_i += exp(cum_i) · (h_st C_i)
        y_inter = torch.einsum("bhpn,bin->bihp", state, Ci) * torch.exp(cum)[..., None]
        # state update
        tot = cum[:, -1]                                 # (B, H)
        dec_j = torch.exp(tot[:, None] - cum) * dti      # (B, T, H)
        state = (state * torch.exp(tot)[..., None, None]
                 + torch.einsum("bjh,bjhp,bjn->bhpn", dec_j, xi, Bi))
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    return y[:, :s], state


@over_batch_heads((("batch", "heads", None, None), ("batch", "heads", None), ("batch", "heads"),
                   ("heads",), ("batch", None), ("batch", None)),
                  (("batch", "heads", None, None), ("batch", "heads", None)), key=1)
def ssd_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_vec: torch.Tensor, C_vec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token step. x: (B, H, P); dt: (B, H); B_vec/C_vec: (B, N). On
    DTensors, once a shard, as `ssd_chunked`."""
    xf = x.float()
    dec = torch.exp(dt * A)                              # (B, H)
    state = (state * dec[..., None, None]
             + dt[..., None, None] * (xf[..., :, None] * B_vec[:, None, None, :]))
    y = torch.einsum("bhpn,bn->bhp", state, C_vec)
    return state, y


def _causal_conv(x: torch.Tensor, w: torch.Tensor, conv_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, S, C); w: (K, C). Returns (silu(y)
    float32, new_state (B, K−1, C) in x's type)."""
    k = w.shape[0]
    if conv_state is None:
        xp = pad_seq(x, k - 1, 0)
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    new_state = xp[:, -(k - 1):] if k > 1 else x.new_zeros((x.shape[0], 0, x.shape[2]))
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return F.silu(y), new_state


class Mamba2Block(nn.Module):
    """One Mamba2 block's parameters (the JAX `block_init`): norm, in_proj
    (d, 2·di + 2·N + H), conv_w (K, di + 2·N) float32, A_log, D and dt_bias
    (H,) float32, gate_norm (di,), out_proj (di, d)."""

    AXES = {"norm": ("embed",), "in_proj": ("embed", "inner"), "conv_w": (None, "inner"),
            "A_log": ("mheads",), "D": ("mheads",), "dt_bias": ("mheads",),
            "gate_norm": ("inner",), "out_proj": ("inner", "embed")}

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        di = cfg.mamba_expand * d
        n = cfg.ssm_state
        nh = di // cfg.mamba_headdim
        f32 = dict(dtype=torch.float32, device=device)
        self.norm = param(torch.ones((d,), dtype=dtype, device=device))
        self.in_proj = param(dense_init(gen, (d, 2 * di + 2 * n + nh), dtype, device))
        self.conv_w = param(torch.randn((cfg.mamba_conv, di + 2 * n), generator=gen, **f32)
                            * 0.2)
        self.A_log = param(torch.zeros((nh,), **f32))        # A = −exp(A_log) ∈ (−∞, 0)
        self.D = param(torch.ones((nh,), **f32))
        self.dt_bias = param(torch.zeros((nh,), **f32))
        self.gate_norm = param(torch.ones((di,), dtype=dtype, device=device))
        self.out_proj = param(dense_init(gen, (di, d), dtype, device))


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    d = cfg.d_model
    di = cfg.mamba_expand * d
    n = cfg.ssm_state
    nh = di // cfg.mamba_headdim
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    return z, xbc, dt, di, n, nh


def apply_prefill(x: torch.Tensor, p: Mamba2Block, cfg: ModelConfig, chunk: int = 64
                  ) -> Tuple[torch.Tensor, State]:
    """x (B, S, D) → (x + the block's output, the decode-ready state
    {"ssd" (B, H, P, N), "conv" (B, K−1, di + 2N)}, both float32)."""
    b, s, _d = x.shape
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    z, xbc, dt_raw, di, n, nh = _split_proj(seq_whole_grad(gather_seq(h) @ p.in_proj), cfg)
    xbc, conv_state = _causal_conv(xbc, p.conv_w)
    xs = xbc[..., :di].reshape(b, s, nh, cfg.mamba_headdim)
    B_mat = xbc[..., di:di + n]
    C_mat = xbc[..., di + n:]
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    y, ssd_state = ssd_chunked(xs, dt, A, B_mat, C_mat, chunk=chunk)
    y = y + p.D[None, None, :, None] * xs.float()
    y = y.reshape(b, s, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p.gate_norm, cfg.norm_eps)
    out = seq_whole_grad(gather_seq(y) @ p.out_proj)
    return bshard(x + out), {"ssd": ssd_state, "conv": conv_state.float()}


def apply(x: torch.Tensor, p: Mamba2Block, cfg: ModelConfig, chunk: int = 64
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prefill form → (x + the block's output, the SSD state)."""
    x, st = apply_prefill(x, p, cfg, chunk)
    return x, st["ssd"]


def make_state(cfg: ModelConfig, batch: int, device: DeviceLike = None) -> State:
    device = resolve_device(device)
    d = cfg.d_model
    di = cfg.mamba_expand * d
    n = cfg.ssm_state
    nh = di // cfg.mamba_headdim
    return {
        "ssd": torch.zeros((batch, nh, cfg.mamba_headdim, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.mamba_conv - 1, di + 2 * n), dtype=torch.float32,
                            device=device),
    }


def state_axes() -> Dict[str, tuple]:
    """The logical axes of `make_state`'s leaves."""
    return {"ssd": ("batch", "mheads", None, None), "conv": ("batch", None, "inner")}


def apply_decode(x: torch.Tensor, p: Mamba2Block, st: State, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, State]:
    """One-token step. x: (B, 1, D) → (x + the block's output, new state)."""
    b = x.shape[0]
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    z, xbc, dt_raw, di, n, nh = _split_proj(seq_whole_grad(gather_seq(h) @ p.in_proj), cfg)
    xbc, conv_state = _causal_conv(xbc, p.conv_w, conv_state=st["conv"])
    xs = xbc[:, 0, :di].reshape(b, nh, cfg.mamba_headdim)
    B_vec = xbc[:, 0, di:di + n]
    C_vec = xbc[:, 0, di + n:]
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    ssd_state, y = ssd_step(st["ssd"], xs, dt, A, B_vec, C_vec)
    y = y + p.D[None, :, None] * xs.float()
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p.gate_norm, cfg.norm_eps)
    return x + y @ p.out_proj, {"ssd": ssd_state, "conv": conv_state.float()}
