"""Train and serve steps: the port of `repro.train.train_step`.

`make_train_step` returns (model, opt_state, grad_error, batch) → (model,
opt_state, grad_error, metrics), as the reference's pure step does with a
parameter tree. The port's parameters are the model's own tensors: the
step takes the loss's gradient of every parameter, optionally compresses
it (int8 with error feedback, on the reference's leaves, so `grad_error`
is keyed and stacked as JAX's parameter tree: `convert.stack_as_jax`),
and writes the AdamW update into the model in place (`optimizer`).
On the card the forward's self-attention launches K7 (`models.attention`).

On a mesh the module's parameters are DTensors (`sharding.partitioning`
`shard_module`) and the step runs unchanged under the caller's
`sharding.context.use_rules`, as the reference's does under its
`activation_rules`; without rules the annotations are the identity.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import convert
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.train import grad_compress, optimizer as opt


def placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient on its parameter's placements: on a mesh, a gradient
    pending a sum over the data ranks is reduce-scattered onto the
    parameter's shards, as XLA reduces FSDP gradients. A plain tensor as it
    is."""
    if hasattr(g, "placements") and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_loss_fn(model: ModelBundle):
    def loss_fn(module, batch):
        return model.loss(module, batch)
    return loss_fn


def make_train_step(model: ModelBundle, ocfg: opt.OptimizerConfig,
                    compress_grads: bool = False):
    """(module, opt_state, grad_error, batch) → (module, opt_state,
    grad_error, metrics {"loss", "grad_norm", "lr", "quant_err"}). The
    batch may lie on the host; it is moved to the module's device. A
    parameter the loss does not reach gets a zero gradient, as under
    `jax.grad`."""
    cfg = model.cfg

    def step(module, opt_state: opt.AdamWState, grad_error: Optional[dict], batch):
        params = dict(module.named_parameters())
        batch = {k: v.to(opt_state.step.device, non_blocking=True) for k, v in batch.items()}
        loss = model.loss(module, batch)
        gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                 materialize_grads=True)
        grads = {n: placed_like(g, params[n]) for n, g in zip(params, gs)}
        del gs
        if compress_grads:
            deq, grad_error, qerr = grad_compress.compress_grads_ef(
                convert.stack_as_jax(grads, cfg), grad_error)
            grads = convert.unstack_from_jax(deq, cfg, params)
        else:
            qerr = torch.zeros((), dtype=torch.float32, device=loss.device)
        _params, opt_state, metrics = opt.apply_updates(params, grads, opt_state, ocfg)
        metrics = dict(metrics, loss=loss.detach(), quant_err=qerr)
        return module, opt_state, grad_error, metrics

    return step


def make_serve_step(model: ModelBundle, mode: str):
    """decode: (module, cache, batch) → (logits, cache);
    prefill: (module, batch) → (logits, cache)."""
    if mode == "decode":
        def step(module, cache, batch):
            return model.decode_step(module, cache, batch)
        return step
    if mode == "prefill":
        def step(module, batch):
            return model.prefill(module, batch)
        return step
    raise ValueError(mode)
