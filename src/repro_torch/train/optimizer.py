"""AdamW with float32 state over (possibly bfloat16) parameters, the
learning-rate schedule and global-norm clipping: the port of
`repro.train.optimizer`.

Parameters, gradients and the moments m and v are dicts keyed by the
model's parameter names (`named_parameters()`); m and v are float32, `step`
an int32 scalar on the parameters' device. `apply_updates` writes the new
parameters and moments in place under `torch.no_grad()`, the port's form of
the reference's donated buffers: a second copy of the float32 moments would
not fit beside a large model. Its arithmetic follows the reference op by
op, with its rounding points: the update in float32, each parameter cast
back to its own type last. On a mesh each parameter's update runs once a
shard (`_update_sharded`): it is elementwise, so no rank needs another's
entries, and DTensor need not place its twenty-odd ops one by one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple, Union

import torch

from repro_torch.sharding.context import when_placed

Named = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


@dataclasses.dataclass(frozen=True)
class AdamWState:
    """step (int32 scalar) and the float32 moments by parameter name. As a
    checkpoint tree its keys are the reference's: `.step`, `.m/...`, `.v/...`."""
    step: torch.Tensor
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def schedule(cfg: OptimizerConfig, step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_frac (float32)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init(params: Named) -> AdamWState:
    """Zero moments in float32 for every parameter, step 0."""
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.items()},
        v={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.items()})


def state_axes(param_axes: Dict[str, tuple]) -> AdamWState:
    """The state's logical axes: m and v mirror the parameters'."""
    return AdamWState(step=(), m=param_axes, v=param_axes)


def global_norm(tree: Named) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _update_sharded(fn, p, g, m, v, *rest):
    """`_update` on DTensors, once a shard: the gradient and the moments on
    the parameter's placements, the scalars replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    pl, rep = list(p.placements), [Replicate()] * p.device_mesh.ndim
    specs = (pl,) * 4 + tuple(rep if isinstance(r, DTensor) else None for r in rest)
    return local_map(fn, out_placements=None, in_placements=specs, device_mesh=p.device_mesh,
                     redistribute_inputs=True)(p, g, m, v, *rest)


@when_placed(_update_sharded)
def _update(p, g, m, v, scale, lr, b1c, b2c, cfg: OptimizerConfig) -> None:
    """One parameter's AdamW update, written into p, m and v."""
    g = g.float() * scale
    m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
    v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p.float()
    p.copy_((p.float() - lr * delta).to(p.dtype))


@torch.no_grad()
def apply_updates(params: Named, grads: Named, state: AdamWState, cfg: OptimizerConfig
                  ) -> Tuple[Named, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, clipped to `cfg.clip_norm` by the global norm.
    Writes `params`, `state.m` and `state.v` in place and returns (params,
    the state with the step advanced, {"grad_norm", "lr"})."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for name, p in params.items():
        _update(p, grads[name], state.m[name], state.v[name], scale, lr, b1c, b2c, cfg)
    return params, AdamWState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}
