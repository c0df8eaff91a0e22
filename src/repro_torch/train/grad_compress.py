"""int8 gradient compression with error feedback: the port of
`repro.train.grad_compress`.

Per-tensor symmetric int8 with the quantization residual fed back into the
next step. A "tensor" is a leaf of the reference's parameter tree, so the
train step compresses the gradients keyed and stacked as JAX holds them
(`convert.stack_as_jax`): one scale for each scanned group's stacked leaf,
and the codes equal the reference's. `torch.round` rounds half to even, as
`jnp.round` does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

Named = Mapping[str, torch.Tensor]


def init_error(params: Named) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: returns (q, scale)."""
    scale = torch.amax(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads_ef(grads: Named, error: Named
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], torch.Tensor]:
    """Quantize (grads + carried error); return (dequantized grads that the
    optimizer consumes, new error, mean relative quantization error). The
    sums run over the leaves in key order, the reference's leaf order."""
    keys = sorted(grads)
    deq, new_err = {}, {}
    for k in keys:
        gf = grads[k].float() + error[k]
        q, s = compress(gf)
        deq[k] = decompress(q, s)
        new_err[k] = gf - deq[k]
    num = sum(torch.sum(torch.abs(new_err[k])) for k in keys)
    den = sum(torch.sum(torch.abs(grads[k].float())) for k in keys) + 1e-12
    return deq, new_err, num / den


def wire_bytes(grads: Named) -> int:
    """int8 payload size (vs 4 bytes fp32 / 2 bytes bf16)."""
    return sum(int(g.numel()) for g in grads.values()) + 8 * len(grads)
