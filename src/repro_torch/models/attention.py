"""Attention for the LM family: (B, S, H, Dh) queries against (B, S, Hkv, Dh)
keys and values, GQA/MQA (query head h attends kv head h // (H/Hkv)).

`attention` dispatches by device and call pattern:
- On the card, self-attention over the whole sequence (no prefix, no
  query offset, no cache length, Sq == Sk; causal or not, any window) is
  exactly the function of kernel K7, so it launches
  `kernels.flash_attention.flash_attention` through a strided (B, H, L, Dh)
  view. If K7 does not take the shape (head dim, dtype), the call raises.
  That is prefill, and the forward of a train step: with grad on, K7 runs
  inside an autograd Function whose backward is K7's backward kernel
  (`kernels/flash_attention.py`).
- Every other pattern, and every call on the CPU, runs `attention_plain`:
  the JAX package's chunked online softmax (`repro/models/attention.py`)
  step by step. On the card that covers decode against the cache
  (`causal=False, kv_valid_len=`) and the prefix-LM mask. The JAX package
  leaves those patterns to XLA outside any Pallas kernel as well; no
  kernel computes them in either package, so this is not a fall back.

On DTensors (a model placed on a mesh, `sharding.partitioning`) the call
runs per shard through `local_map`. Over the whole sequence, q, k and v
are redistributed to batch over the data axes and heads over `model` (kv
heads repeated for their query group where only the query heads divide
it; replicated where neither does), and each rank attends its own batch
rows and heads, so on the card K7 still launches, once a rank, on plain
tensors. Against a cache, the cache stays as it lies and q follows it
(`_attention_cached_sharded`).

The two differ in two rounding points. K7 follows the Pallas body: it
scales q in the input type, and it rounds the probabilities p to v's type
before p·V. `attention_plain` follows the JAX `attention`: it upcasts q to
float32 before the scale and keeps p in float32. In bfloat16 K7 therefore
computes a less precise function than the JAX serving path; in float32
the two compute the same function.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.sharding.context import (activation_rules, current_rules, logical_spec, pad_seq,
                                          when_placed)
from repro_torch.sharding.partitioning import to_placements

_NEG_INF = -1e30

IntLike = Union[int, torch.Tensor]


def _attention_sharded(fn, q, k, v, **kw) -> torch.Tensor:
    """`attention` (`fn`) on DTensors, one call a shard (module
    docstring)."""
    from torch.distributed.tensor.experimental import local_map

    if kw.get("kv_valid_len") is not None:
        return _attention_cached_sharded(q, k, v, **kw)
    mesh = q.device_mesh
    rules = current_rules() or activation_rules(mesh)
    logical = ("batch", None, "heads_act", None)
    spec_q, spec_k = logical_spec(q.shape, logical, rules), logical_spec(k.shape, logical, rules)
    if spec_q[2] is not None and spec_k[2] is None:
        # kv heads do not divide `model` but q heads do: each kv head
        # repeated for its query group, so that both split by head
        b, sk, hkv, dh = k.shape
        g = q.shape[2] // hkv
        k, v = (t.unsqueeze(3).expand(b, sk, hkv, g, dh).reshape(b, sk, hkv * g, dh)
                for t in (k, v))
        spec_k = logical_spec(k.shape, logical, rules)
    elif spec_q[2] != spec_k[2]:
        spec_q, spec_k = spec_q[:2] + (None, None), spec_k[:2] + (None, None)
    pl_q, pl_k = to_placements(spec_q, mesh, q.shape), to_placements(spec_k, mesh, k.shape)
    return local_map(lambda ql, kl, vl: fn(ql, kl, vl, **kw), out_placements=list(pl_q),
                     in_placements=(list(pl_q), list(pl_k), list(pl_k)), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def _attention_cached_sharded(q, k, v, **kw) -> torch.Tensor:
    """`attention` against a cache on DTensors (decode), once a shard: the
    cache stays as it lies (batch, and its heads or head dim split; a
    split sequence is gathered), q takes the same splits, and where the
    head dim is split each chunk's scores are summed across its ranks
    (an all-reduce) before the softmax, as XLA contracts a split dim."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = k.device_mesh
    pl = [p if p.is_shard(0) or p.is_shard(2) or p.is_shard(3) else Replicate()
          for p in k.placements]
    hd_split = [i for i, p in enumerate(pl) if p.is_shard(3)]
    pl_q = [Replicate() if p.is_shard(0) and q.shape[0] == 1 else p for p in pl]

    def scores_sum(s):
        for i in hd_split:
            s = funcol.all_reduce(s, "sum", (mesh, i))
        return s

    def local(ql, kl, vl):
        return attention_plain(ql, kl, vl, head_dim=q.shape[-1],
                               scores_sum=scores_sum if hd_split else None, **kw)

    return local_map(local, out_placements=pl_q, in_placements=(pl_q, pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


@when_placed(_attention_sharded)
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: int = 0,
              prefix_len: Optional[IntLike] = None,
              q_offset: int = 0,
              kv_valid_len: Optional[IntLike] = None,
              kv_chunk: int = 1024,
              q_chunk: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Sk, Hkv, Dh) → (B, Sq, H, Dh).

    prefix_len: (B,) or scalar — columns < prefix_len are always visible
    (prefix-LM). q_offset: global position of q row 0 (decode). kv_valid_len:
    (B,) or scalar — masks the unfilled cache tail. kv_chunk and q_chunk
    block the plain version (peak score block (B, q_chunk, H, kv_chunk));
    K7 has its own blocks and ignores them."""
    self_attention = (prefix_len is None and isinstance(q_offset, int) and q_offset == 0
                      and kv_valid_len is None and q.shape[1] == k.shape[1])
    if q.device.type == "cuda" and self_attention:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, window=window)
        return out.transpose(1, 2)
    return attention_plain(q, k, v, causal=causal, window=window, prefix_len=prefix_len,
                           q_offset=q_offset, kv_valid_len=kv_valid_len,
                           kv_chunk=kv_chunk, q_chunk=q_chunk)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int = 0,
                    prefix_len: Optional[IntLike] = None,
                    q_offset: int = 0,
                    kv_valid_len: Optional[IntLike] = None,
                    kv_chunk: int = 1024,
                    q_chunk: int = 0,
                    head_dim: Optional[int] = None,
                    scores_sum=None) -> torch.Tensor:
    """The JAX package's chunked online softmax in torch ops: q upcast to
    float32 and scaled, kv chunks zero-padded to a whole chunk, masked
    scores set to -1e30, and with `q_chunk` an outer loop over query
    blocks. On a shard of the head dim (`_attention_cached_sharded`),
    `head_dim` is the whole one (the scale's) and `scores_sum` sums each
    chunk's partial scores across the ranks."""
    if q_chunk and q.shape[1] > q_chunk and q.shape[1] % q_chunk == 0:
        outs = [attention_plain(q[:, i:i + q_chunk], k, v, causal=causal, window=window,
                                prefix_len=prefix_len, q_offset=q_offset + i,
                                kv_valid_len=kv_valid_len, kv_chunk=kv_chunk, q_chunk=0,
                                head_dim=head_dim, scores_sum=scores_sum)
                for i in range(0, q.shape[1], q_chunk)]
        return torch.cat(outs, dim=1)
    dev = q.device
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / ((head_dim or hd) ** 0.5)

    qg = (q.float() * scale).reshape(b, sq, hkv, g, hd)
    rows = q_offset + torch.arange(sq, device=dev)           # (Sq,) global rows

    kv_chunk = min(kv_chunk, sk)
    n_chunks = -(-sk // kv_chunk)
    pad = n_chunks * kv_chunk - sk
    kp, vp = pad_seq(k, 0, pad), pad_seq(v, 0, pad)

    if kv_valid_len is None or isinstance(kv_valid_len, int):
        # a fill on the device, not a copy from the host (decode calls this
        # once a layer)
        valid_len = torch.full((1,), sk if kv_valid_len is None else kv_valid_len,
                               dtype=torch.int32, device=dev)
    else:
        valid_len = torch.as_tensor(kv_valid_len, dtype=torch.int32, device=dev).reshape(-1)
    pl = None
    if prefix_len is not None:
        pl = torch.as_tensor(prefix_len, dtype=torch.int32, device=dev).reshape(-1, 1, 1)

    m_i = torch.full((b, sq, hkv, g), _NEG_INF, dtype=torch.float32, device=dev)
    l_i = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, hkv, g, hd), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        kci = kp[:, ci * kv_chunk:(ci + 1) * kv_chunk].float()
        vci = vp[:, ci * kv_chunk:(ci + 1) * kv_chunk].float()
        cols = ci * kv_chunk + torch.arange(kv_chunk, device=dev)   # (C,) global cols
        s = torch.einsum("bqhgd,bchd->bqhgc", qg, kci)               # (B, Sq, Hkv, G, C)
        if scores_sum is not None:
            s = scores_sum(s)

        mask = cols[None, None, :] < valid_len[:, None, None]         # (B?, 1, C)
        mask = mask.expand(max(b, mask.shape[0]), sq, kv_chunk)
        if causal:
            cm = (cols[None, :] <= rows[:, None])[None]               # (1, Sq, C)
            if pl is not None:
                cm = cm | (cols[None, None, :] < pl)
            mask = mask & cm
        if window > 0:
            mask = mask & (cols[None, None, :] > rows[None, :, None] - window)

        s = torch.where(mask[:, :, None, None, :], s, _NEG_INF)
        m_new = torch.maximum(m_i, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_i - m_new)
        l_i = l_i * alpha + p.sum(dim=-1)
        pv = torch.einsum("bqhgc,bchd->bqhgd", p, vci)
        acc = acc * alpha[..., None] + pv
        m_i = m_new
    out = acc / torch.clamp_min(l_i, 1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(q.dtype)
