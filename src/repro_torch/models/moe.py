"""Mixture-of-Experts decoder (granite-moe, qwen3-moe): serving and the
training loss.

A layer is the dense family's block (`dense.DenseBlock`) with a routed MLP
in place of the SwiGLU: the router is float32, softmax top-k with
renormalisation (qwen3 style), plus the switch load-balance aux, which
`loss` adds at AUX_COEF. So the family serves through
`dense.prefill`/`dense.decode_step` and its caches are the dense family's
global-layer caches (`dense.make_cache`).

Dispatch is the JAX package's capacity-based sort-dispatch
(`repro/models/moe.py:moe_mlp`): a stable sort of the (token, k)
assignments by expert id, each expert's start by `searchsorted`, a slot
`expert·C + position` for the first C of each expert and the trash slot
past them for the rest (dropped: they add 0), then each assignment gathers
its expert's output back. Tokens sort per data-parallel group of the
ambient sharding context (`_n_data_groups`: the product of the `batch`
axes' sizes in the rules), each group with the capacity of its own
tokens; with no context that is a single group. On DTensors each rank
routes its own group, runs its own experts, and combines (`_moe_mlp_sharded`).

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

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike
from repro_torch.models import dense
from repro_torch.models.attention import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (chunked_ce, dense_init, embed_lookup, merge_heads, param,
                                       remat, rmsnorm)
from repro_torch.sharding.context import (activation_rules, bshard, constrain, current_rules,
                                          logical_spec, seq_whole_grad, when_placed)
from repro_torch.sharding.partitioning import to_placements

AUX_COEF = 0.01
_EXPERT_GROUP_BYTES = 1 << 30     # float32 bytes of one group's (E_g, C, max(D, F)) buffer


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


class MoEMLP(nn.Module):
    """The routed MLP's weights: router (d, E) float32, w_gate and w_up
    (E, d, f), w_down (E, f, d) in `cfg.dtype`."""

    AXES = {"router": ("embed", None), "w_gate": ("experts", "embed", None),
            "w_up": ("experts", "embed", None), "w_down": ("experts", None, "embed")}

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


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """(..., N, D) → (probs (..., N, E), top_w (..., N, k) renormalised,
    top_e (..., N, k)): the float32 router, softmax, and the top k by a
    stable descending sort (the lower expert first among equal
    probabilities, as `lax.top_k`)."""
    logits = x.float() @ router
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :k], top_e[..., :k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return probs, top_w, top_e


def dispatch(top_e: torch.Tensor, cap: int, e: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., N, k) expert ids, one group a leading index → (slot (..., N·k):
    each assignment's buffer row in its group, expert·cap + its place among
    the expert's assignments, or e·cap (the trash slot) past the first
    `cap`; disp_tok (..., e·cap): each row's token in its group, or N where
    the row is empty). Assignment a = token·k + j; each expert takes its
    assignments in order of a (a stable sort by expert), group by group."""
    lead, (n, k) = top_e.shape[:-2], top_e.shape[-2:]
    e_flat = top_e.reshape(-1, n * k)
    g = e_flat.shape[0]
    order = torch.sort(e_flat, dim=-1, stable=True).indices
    es = torch.gather(e_flat, 1, order)
    experts = torch.arange(e, device=es.device, dtype=es.dtype).expand(g, e).contiguous()
    start = torch.searchsorted(es, experts)
    pos = torch.arange(n * k, device=es.device) - torch.gather(start, 1, es)
    keep = pos < cap
    slot_sorted = torch.where(keep, es * cap + pos, e * cap)
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    disp_tok = torch.full((g, e * cap + 1), n, dtype=torch.long, device=es.device)
    disp_tok.scatter_(1, slot_sorted, torch.where(keep, order // k, n))
    return slot.reshape(*lead, n * k), disp_tok[:, :-1].reshape(*lead, e * cap)


def _n_data_groups() -> int:
    """Data-parallel group count from the ambient sharding context: the
    product of the sizes of the rules' `batch` axes (1 with no context)."""
    rules = current_rules()
    if not rules:
        return 1
    sizes = rules.get("__sizes__", {})
    g = 1
    for a in rules.get("batch", ()):
        g *= sizes.get(a, 1)
    return max(g, 1)


def _groups(n: int) -> int:
    ng = _n_data_groups()
    return ng if n % ng == 0 else 1


def _flat_rows(idx: torch.Tensor, rows: int) -> torch.Tensor:
    """(G, M) row indices within each group → (G·M,) indices into the
    groups' rows stacked, `rows` a group (one group: the indices as they
    are, with no offset to add)."""
    if idx.shape[0] == 1:
        return idx.reshape(-1)
    return (idx + torch.arange(idx.shape[0], device=idx.device)[:, None] * rows).reshape(-1)


def _route_dispatch(xf: torch.Tensor, router: torch.Tensor, k: int, e: int, cap: int):
    """The routing of each data group's tokens, xf (G, N, D) → (xpad
    (G·(N+1), D): each group's tokens and a zero row; rows (G, e·cap): each
    buffer row's source in xpad; slot (G, N·k) as `dispatch` gives it;
    top_w, top_e (G, N, k); the aux's routed count (E,) and mean
    probability (E,) over these tokens)."""
    g, n, d = xf.shape
    probs, top_w, top_e = route(xf, router, k)
    # a scatter of ones, exact in any order (`bincount` would wait on the device)
    counts = torch.zeros(e, dtype=torch.float32, device=xf.device).scatter_add_(
        0, top_e.reshape(-1), torch.ones(top_e.numel(), dtype=torch.float32, device=xf.device))
    slot, disp_tok = dispatch(top_e, cap, e)
    xpad = torch.cat([xf, xf.new_zeros((g, 1, d))], dim=1).view(g * (n + 1), d)
    return (xpad, _flat_rows(disp_tok, n + 1).view(g, e * cap), slot, top_w, top_e, counts,
            probs.reshape(-1, e).mean(0))


def _expert_ffn(xd: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU of a chunk of E_g experts over their rows of every group, xd
    (G, E_g, cap, D) → (G, E_g·cap, D)."""
    g, eg, cap, d = xd.shape
    xe = xd.transpose(0, 1).reshape(eg, g * cap, d)
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    return torch.bmm(h, w_down).view(eg, g, cap, d).transpose(0, 1).reshape(g, eg * cap, d)


def _experts(buffers, g: int, cap: int, w_gate, w_up, w_down) -> torch.Tensor:
    """y (G, E·cap + 1, D): each expert's SwiGLU over its rows of every
    group, `buffers(e0, e1)` giving experts e0..e1-1's (G, e1-e0, cap, D)
    rows. They run in chunks of experts whose (E_g, G·cap, max(D, F))
    float32 bytes stay under `_EXPERT_GROUP_BYTES`; the last row (the
    trash slot) stays 0."""
    e, d, f = w_gate.shape
    y = torch.zeros((g, e * cap + 1, d), dtype=w_gate.dtype, device=w_gate.device)
    eg = max(1, _EXPERT_GROUP_BYTES // (4 * g * cap * max(d, f)))
    for e0 in range(0, e, eg):
        e1 = min(e, e0 + eg)
        y[:, e0 * cap:e1 * cap] = _expert_ffn(buffers(e0, e1), w_gate[e0:e1], w_up[e0:e1],
                                              w_down[e0:e1])
    return y


def _combine(y: torch.Tensor, slot: torch.Tensor, top_w: torch.Tensor, top_e: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Each token's k weighted expert outputs in `dtype`, summed by
    ascending expert id (JAX's scatter-add order). y (G, e·cap + 1, D)
    with the trash row last, slot (G, N·k) → (G·N, D)."""
    g, rows, d = y.shape
    k = top_e.shape[-1]
    contrib = (y.view(g * rows, d)[_flat_rows(slot, rows)].float()
               * top_w.reshape(-1, 1)).to(dtype).view(-1, k, d)
    by_expert = torch.argsort(top_e.reshape(-1, k), dim=-1)
    contrib = torch.take_along_dim(contrib, by_expert[..., None], dim=1)
    out = y.new_zeros((contrib.shape[0], d))
    for j in range(k):
        out = out + contrib[:, j]
    return out


def _moe_mlp_sharded(fn, x, p: MoEMLP, cfg: ModelConfig):
    """`moe_mlp` on DTensors, the reference's expert parallelism: the steps
    of the plain form in three `local_map`s a rank. Its data groups' routing
    and dispatch into (G, E, C, D) buffers; the buffers placed by
    ("expert_groups", "experts"), each rank's experts run on them with the
    weights gathered over their FSDP axis; the buffers gathered over
    `model` and each token's outputs combined in its group."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rules = current_rules() or activation_rules(mesh)
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.top_k
    ng = _groups(n)
    n_loc = n // ng
    cap = capacity(n_loc, cfg)

    def placements(t, logical):
        return list(to_placements(logical_spec(t.shape, logical, rules), mesh, t.shape))

    pl_x = placements(x, ("batch", None, None))
    n_split = int(np.prod([size for size, pl in zip(mesh.mesh.shape, pl_x) if pl.is_shard(0)]))
    if ng % n_split:
        raise ValueError(f"{ng} data groups do not split over the {n_split} ranks that "
                         f"split the batch")
    ng_loc = ng // n_split
    rep = [Replicate()] * mesh.ndim
    by_group = [pl if pl.is_shard(0) else Replicate() for pl in pl_x]
    count_pl = [Partial() if pl.is_shard(0) else Replicate() for pl in pl_x]
    mean_pl = [Partial("avg") if pl.is_shard(0) else Replicate() for pl in pl_x]

    def route_local(xl, router):
        xpad, rows, slot, top_w, top_e, counts, prob_mean = _route_dispatch(
            xl.reshape(ng_loc, n_loc, d), router, k, e, cap)
        return xpad[rows].view(ng_loc, e, cap, d), slot, top_w, top_e, counts, prob_mean

    xd, slot, top_w, top_e, counts, prob_mean = local_map(
        route_local, out_placements=(by_group,) * 4 + (count_pl, mean_pl),
        in_placements=(pl_x, rep), device_mesh=mesh, redistribute_inputs=True)(x, p.router)
    aux = e * torch.sum(counts / (n * k) * prob_mean)

    buf = ("expert_groups", "experts", None, None)
    xd = constrain(xd, buf)
    pl_buf = list(xd.placements)
    pl_w = placements(p.w_gate, ("experts", None, None))

    def experts_local(xdl, wg, wu, wd):
        g, el = xdl.shape[:2]
        y = _experts(lambda e0, e1: xdl[:, e0:e1], g, cap, wg, wu, wd)
        return y[:, :-1].reshape(g, el, cap, d)

    y = local_map(experts_local, out_placements=pl_buf,
                  in_placements=(pl_buf, pl_w, pl_w, pl_w), device_mesh=mesh,
                  redistribute_inputs=True)(xd, p.w_gate, p.w_up, p.w_down)
    y = constrain(y, buf)

    def combine_local(yl, sl, twl, tel):
        g = yl.shape[0]
        yl = torch.cat([yl.reshape(g, e * cap, d), yl.new_zeros((g, 1, d))], dim=1)
        return _combine(yl, sl, twl, tel, x.dtype).reshape(-1, s, d)

    out = local_map(combine_local, out_placements=pl_x, in_placements=(by_group,) * 4,
                    device_mesh=mesh, redistribute_inputs=True)(y, slot, top_w, top_e)
    return out, aux


@when_placed(_moe_mlp_sharded)
def moe_mlp(x: torch.Tensor, p: MoEMLP, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (out (B, S, D), aux loss). Assignments past an
    expert's capacity are dropped (they add 0). Tokens sort per
    data-parallel group of the sharding context (`_n_data_groups`), each
    with its own capacity, as in the reference; with no context, one."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.top_k
    ng = _groups(n)
    cap = capacity(n // ng, cfg)
    xpad, rows, slot, top_w, top_e, counts, prob_mean = _route_dispatch(
        x.reshape(ng, n // ng, d), p.router, k, e, cap)
    # switch aux: fraction routed vs mean prob per expert (global)
    aux = e * torch.sum(counts / (n * k) * prob_mean)
    y = _experts(lambda e0, e1: xpad[rows[:, e0 * cap:e1 * cap]].view(ng, e1 - e0, cap, d),
                 ng, cap, p.w_gate, p.w_up, p.w_down)
    out = _combine(y, slot, top_w, top_e, x.dtype)
    return out.reshape(b, s, d), aux


def moe_mlp_reference(x: torch.Tensor, p: MoEMLP, cfg: ModelConfig) -> torch.Tensor:
    """No-capacity oracle: every token exactly through its top-k experts."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    _probs, top_w, top_e = route(xf, p.router, cfg.top_k)
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
    x = x + seq_whole_grad(merge_heads(o) @ blk.attn.wo)
    mo, aux = moe_mlp(rmsnorm(x, blk.mlp_norm, cfg.norm_eps), blk.mlp, cfg)
    return bshard(x + mo), aux


def forward(model: MoELM, tokens: torch.Tensor, *, kv_chunk: int = 1024
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (final hidden states (B, S, D), the layers' mean
    aux). Each layer is one remat unit (`layers.remat`), as in JAX."""
    cfg = model.cfg
    x = bshard(embed_lookup(tokens, model.embed))
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
cache_axes = dense.cache_axes
