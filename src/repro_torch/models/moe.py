"""Mixture-of-Experts decoder (granite-moe, qwen3-moe): serving and the
training loss.

A layer is the dense family's block (`dense.DenseBlock`) with a routed MLP
in place of the SwiGLU: the router is float32, softmax top-k with
renormalisation (qwen3 style), plus the switch load-balance aux, which
`loss` adds at AUX_COEF. So the family serves through
`dense.prefill`/`dense.decode_step` and its caches are the dense family's
global-layer caches (`dense.make_cache`).

Dispatch is the JAX package's capacity-based sort-dispatch
(`repro/models/moe.py:moe_mlp`) in one group: a stable sort of the
(token, k) assignments by expert id, each expert's start by
`searchsorted`, a slot `expert·C + position` for the first C of each
expert and the trash slot past them for the rest (dropped: they add 0),
then each assignment gathers its expert's output back. The JAX package
sorts per data-parallel group of the ambient sharding context
(`_n_data_groups`); without one that is a single group, which is what the
port does until the sharding context is ported.

Two points where torch and JAX differ, and what the port does:
- `jax.lax.top_k` puts the lower index first among equal values;
  `torch.topk` promises no order. The top k come from a stable descending
  sort instead, which keeps the lower index first.
- JAX scatter-adds each token's weighted expert outputs, rounded to x's
  type, into zeros in slot order, that is by ascending expert id. The
  port sums the same terms in the same order and type.

The expert SwiGLUs over the (E, C, D) buffers are batched matmuls, as in
JAX, where they are XLA einsums outside any Pallas kernel; they run over
groups of experts so that the buffers stay under `_EXPERT_GROUP_BYTES`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike
from repro_torch.models import dense
from repro_torch.models.attention import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import chunked_ce, dense_init, param, remat, rmsnorm

AUX_COEF = 0.01
_EXPERT_GROUP_BYTES = 1 << 30     # float32 bytes of one group's (E_g, C, max(D, F)) buffer


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


class MoEMLP(nn.Module):
    """The routed MLP's weights: router (d, E) float32, w_gate and w_up
    (E, d, f), w_down (E, f, d) in `cfg.dtype`."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = param(dense_init(gen, (d, e), torch.float32, device))
        self.w_gate = param(dense_init(gen, (e, d, f), dtype, device))
        self.w_up = param(dense_init(gen, (e, d, f), dtype, device))
        self.w_down = param(dense_init(gen, (e, f, d), dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe_mlp(x, self, self.cfg)[0]


class MoELM(dense.DenseLM):
    """`dense.DenseLM` whose blocks carry a `MoEMLP` (every layer global)."""

    FAMILIES = ("moe",)

    def make_block(self, cfg, window, dtype, device, gen):
        return dense.DenseBlock(cfg, window, dtype, device, gen,
                                mlp=MoEMLP(cfg, dtype, device, gen))


def init(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None) -> MoELM:
    return MoELM(cfg, seed=seed, device=device)


def route(x: torch.Tensor, p: MoEMLP, k: int):
    """(N, D) → (probs (N, E), top_w (N, k) renormalised, top_e (N, k)):
    the float32 router, softmax, and the top k by a stable descending sort
    (the lower expert first among equal probabilities, as `lax.top_k`)."""
    logits = x.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return probs, top_w, top_e


def dispatch(top_e: torch.Tensor, cap: int, e: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, k) expert ids → (slot (N·k,): each assignment's buffer row,
    expert·cap + its place among the expert's assignments, or e·cap (the
    trash slot) past the first `cap`; disp_tok (e·cap,): each row's token,
    or N where the row is empty). Assignment a = token·k + j; each expert
    takes its assignments in order of a (a stable sort by expert)."""
    n, k = top_e.shape
    e_flat = top_e.reshape(-1)
    order = torch.sort(e_flat, stable=True).indices
    es = e_flat[order]
    start = torch.searchsorted(es, torch.arange(e, device=es.device, dtype=es.dtype))
    pos = torch.arange(n * k, device=es.device) - start[es]
    keep = pos < cap
    slot_sorted = torch.where(keep, es * cap + pos, e * cap)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    disp_tok = torch.full((e * cap + 1,), n, dtype=torch.long, device=es.device)
    disp_tok[slot_sorted] = torch.where(keep, order // k, n)
    return slot, disp_tok[:-1]


def _expert_ffn(xd: torch.Tensor, p: MoEMLP, e0: int, e1: int) -> torch.Tensor:
    """SwiGLU of experts e0..e1-1 over their (E_g, C, D) buffer."""
    h = F.silu(torch.bmm(xd, p.w_gate[e0:e1])) * torch.bmm(xd, p.w_up[e0:e1])
    return torch.bmm(h, p.w_down[e0:e1])


def moe_mlp(x: torch.Tensor, p: MoEMLP, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (out (B, S, D), aux loss). Assignments past an
    expert's capacity are dropped (they add 0)."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(n, cfg)
    xf = x.reshape(n, d)
    probs, top_w, top_e = route(xf, p, k)

    # switch aux: fraction routed vs mean prob per expert (a scatter of
    # ones, exact in any order; `bincount` would wait on the device)
    frac = torch.zeros(e, dtype=torch.float32, device=x.device).scatter_add_(
        0, top_e.reshape(-1), torch.ones(n * k, dtype=torch.float32, device=x.device)) / (n * k)
    aux = e * torch.sum(frac * probs.mean(0))

    slot, disp_tok = dispatch(top_e, cap, e)

    # the experts' SwiGLUs over their (C, D) buffers; row e·cap stays 0
    xpad = torch.cat([xf, xf.new_zeros((1, d))])
    y = x.new_zeros((e * cap + 1, d))
    eg = max(1, _EXPERT_GROUP_BYTES // (4 * cap * max(d, cfg.d_ff)))
    for e0 in range(0, e, eg):
        e1 = min(e, e0 + eg)
        xd = xpad[disp_tok[e0 * cap:e1 * cap]].view(e1 - e0, cap, d)
        y[e0 * cap:e1 * cap] = _expert_ffn(xd, p, e0, e1).reshape(-1, d)

    # gather back: each token's k weighted outputs in x's type, summed by
    # ascending expert id (JAX's scatter-add order)
    contrib = (y[slot].float() * top_w.reshape(-1, 1)).to(x.dtype).view(n, k, d)
    by_expert = torch.argsort(top_e, dim=-1)
    contrib = torch.take_along_dim(contrib, by_expert[..., None], dim=1)
    out = x.new_zeros((n, d))
    for j in range(k):
        out = out + contrib[:, j]
    return out.reshape(b, s, d), aux


def moe_mlp_reference(x: torch.Tensor, p: MoEMLP, cfg: ModelConfig) -> torch.Tensor:
    """No-capacity oracle: every token exactly through its top-k experts."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    _probs, top_w, top_e = route(xf, p, cfg.top_k)
    h = (F.silu(torch.einsum("nd,edf->nef", xf, p.w_gate))
         * torch.einsum("nd,edf->nef", xf, p.w_up))
    y_all = torch.einsum("nef,efd->ned", h, p.w_down)                 # (N, E, D)
    sel = torch.take_along_dim(y_all, top_e[..., None], dim=1)        # (N, k, D)
    return (sel * top_w[..., None]).sum(1).to(x.dtype).reshape(b, s, d)


# -- forward and serving -----------------------------------------------------------


def _layer(blk, x: torch.Tensor, positions: torch.Tensor, kv_chunk: int):
    """One layer → (x, its aux)."""
    cfg = blk.cfg
    h = rmsnorm(x, blk.attn_norm, cfg.norm_eps)
    q, k, v = blk.qkv_rope(h, positions)
    o = attention(q, k, v, causal=True, kv_chunk=kv_chunk)
    x = x + o.reshape(o.shape[0], o.shape[1], -1) @ blk.attn.wo
    mo, aux = moe_mlp(rmsnorm(x, blk.mlp_norm, cfg.norm_eps), blk.mlp, cfg)
    return x + mo, aux


def forward(model: MoELM, tokens: torch.Tensor, *, kv_chunk: int = 1024
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (final hidden states (B, S, D), the layers' mean
    aux). Each layer is one remat unit (`layers.remat`), as in JAX."""
    cfg = model.cfg
    x = F.embedding(tokens, model.embed)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    auxs = []
    for blk in model.layers:
        x, aux = remat(_layer, cfg, blk, x, positions, kv_chunk)
        auxs.append(aux)
    return rmsnorm(x, model.final_norm, cfg.norm_eps), torch.stack(auxs).mean()


def loss(model: MoELM, batch: Dict[str, torch.Tensor], *,
         kv_chunk: int = 1024) -> torch.Tensor:
    """`layers.chunked_ce` plus AUX_COEF × the layers' mean aux."""
    x, aux = forward(model, batch["tokens"], kv_chunk=kv_chunk)
    return chunked_ce(x, model.unembed, batch["targets"]) + AUX_COEF * aux


# the family serves through the dense family's prefill and cached decode
prefill = dense.prefill
decode_step = dense.decode_step
make_cache = dense.make_cache
